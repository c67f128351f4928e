"""Device idle share of the direction's calls, %: the part of the calls'
spans in which no device operation (kernel, memcpy or memset) runs."""

from ..trace import covered, union


def read(records, direction):
    spans, _ = records.in_spans(direction)
    if not spans:
        return None
    busy = union((o[2], o[3]) for o in records.ops)
    total = sum(s["end_us"] - s["start_us"] for s in spans)
    used = sum(covered(busy, s["start_us"], s["end_us"]) for s in spans)
    return 100.0 * (1.0 - used / total)
