"""The bit machines' device time a stream bit, ns: kernels whose names
start with ``spiht_encode`` or ``spiht_decode`` (B1-B5 of
``spiht_tpu_torch/csrc``) inside the direction's spans, over the bits of
the streams those calls encoded or decoded."""

from ..trace import MACHINE


def read(records, direction):
    spans, ops = records.in_spans(direction)
    bits = sum(s["bits"] for s in spans)
    us = sum(b - a for name, cat, a, b in ops
             if cat == "kernel" and MACHINE.search(name))
    if not bits or not us:
        return None
    return 1e3 * us / bits
