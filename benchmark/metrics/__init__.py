"""Per-layer metrics, one reader a family, named as in ``BENCHMARK.json``.

Each ``read(records, direction)`` takes the traced run's ``Records``
(``trace.py``) and the direction its name carries (``enc_batch``,
``dec_batch``, ``enc_single`` or ``dec_single``), and returns the metric,
or None where the trace holds nothing for it to read: never a 0 that
stands for "not measured".
"""
