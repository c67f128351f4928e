"""Megapixels decoded a second: every decode call's pixels over the summed
host seconds of those calls, each call from what the caller hands over to
what it gets back, synchronised."""

from .rates import mpx_per_s


def read(window: dict):
    return mpx_per_s(window, "dec")
