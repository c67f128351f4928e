"""The 95th percentile of the host milliseconds of every encode call of
the window, each from what the caller hands over to what it gets back,
synchronised."""

from .rates import p95_ms


def read(window: dict):
    return p95_ms(window, "enc")
