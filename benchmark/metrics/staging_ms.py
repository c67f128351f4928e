"""The host's staging of a call's inputs, ms an image: the ``stage``
spans of the program's calls (``_begin`` through every ``_put*``: the
wait on the last upload, the host copies into pinned memory, the uploads
enqueued) inside the direction's API spans, over their images."""

from .. import spans


def read(records, direction, log=None):
    return spans.phase_ms(records, direction, "stage", log)
