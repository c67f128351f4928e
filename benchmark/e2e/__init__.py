"""End-to-end metrics, one reader a file, named as in ``BENCHMARK.json``.

Each ``read(window)`` takes the window's calls (``cell.run``: each with
its direction, host seconds, images and pixels) and returns the metric,
or None where the window holds no call it reads.
"""
