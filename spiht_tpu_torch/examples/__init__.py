"""The JAX package's four example scripts (``examples/``), through the
port, each run as ``python -m spiht_tpu_torch.examples.<name>`` and
callable in-process as ``main(argv)``. Each takes its JAX counterpart's
arguments plus ``--device`` (default: the CUDA card; ``cpu`` runs the
kernels' plain versions):

  * demonstrate          — IPT + per-channel quantization, bpp sweep
  * on_device_codec      — image -> stream -> image, all on the device
  * metadata_ml_consumer — the decoder's event log featurized on the device
  * progressive_gif      — the embedded stream as an animated GIF
"""
