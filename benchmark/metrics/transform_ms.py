"""The transforms' device time an image, ms: every kernel inside the
direction's spans that is not a bit machine (colour model, DWT, scales
and quantization, maps, max_n, the rec scatter, copies into the outputs),
memcpys and memsets left out, over the images of those calls."""

from ..trace import MACHINE


def read(records, direction):
    spans, ops = records.in_spans(direction)
    images = sum(s["images"] for s in spans)
    us = sum(b - a for name, cat, a, b in ops
             if cat == "kernel" and not MACHINE.search(name))
    if not images or not us:
        return None
    return us / 1e3 / images
