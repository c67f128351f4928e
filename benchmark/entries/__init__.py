"""The system under test's entry points, one file a traffic mix's
``entry`` (``benchmark/entries/<entry>.py``).

Each file names its two directions, ``DIRECTIONS = (encode, decode)``
(the suffixes of the per-layer metrics that read its calls), the API
call behind each (``API``), and an ``Entry(settings, level, dev, dtype)``
with

* ``encode(images, budgets)``: one request's host images and their
  budgets in bits, to a list of ``EncodingResult``, one an image;
* ``decode(results)``: those results to a list of decoded images on the
  device, synchronised; each valid until the entry's next call;
* ``stage_s()``: the program's last host copy into pinned memory in
  seconds, or None where the entry has no such reading.

The calls look the API up on ``spiht_tpu_torch`` at each call.
"""
