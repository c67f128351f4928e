"""The API call's own host time, ms an image: each of the direction's
API spans less what the spans directly under it cover (the argument
checks, the program's key build and cache lookup, building the results),
over their images."""

from .. import spans
from ..trace import covered, union


def read(records, direction, log=None):
    cs = spans.calls(records, direction, log)
    if not cs or not spans.images(cs):
        return None
    ns = 0
    for c in cs:
        a, b = c.api.start_ns, c.api.end_ns
        kids = union((s.start_ns, s.end_ns) for s in c.under
                     if s.parent == c.api.id)
        ns += (b - a) - covered(kids, a, b)
    return ns / 1e6 / spans.images(cs)
