"""The host's read-back after a call's sync, ms an image: the ``read``
spans of the program's calls (the stream bytes copied back and the
results built, after the stat row's read) inside the direction's API
spans, over their images."""

from .. import spans


def read(records, direction, log=None):
    return spans.phase_ms(records, direction, "read", log)
