"""The benchmark of ``spiht_tpu_torch``, the PyTorch and CUDA codec.

``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON line (``run.py``).
"""
