"""The program's own spans, joined to a traced run's records.

The port records spans (``spiht_tpu_torch.metrics.spans()``) only while a
profiler records: in a traced run, the traced rounds' calls and nothing
of set-up. Each on-device API call is a top-level span
``spiht/api/<function>`` (count ``images``) with its programs' phases
under it, ``spiht/<program kind>/<phase>``: ``stage``, ``capture``,
``replay``, ``wait`` (the call's one sync) and ``read``.

``calls`` matches the direction's bench spans (``Records.spans``, in call
order) with the log's last as many top-level spans of the entry's API
function, one each: a trace taken again after one with no kernel record
leaves the earlier trace's spans at the head of the log, and the last
trace is its tail. The program's spans are on ``time.perf_counter_ns``,
the bench spans on the trace's clock: one offset a window maps the one
onto the other, the least that puts every API span's start inside its
bench span (the largest of the bench spans' starts less the API spans'
starts: the host's gap before an API span is at least 0, and the
profiler's first event, a millisecond or more, lies in the first call's).
A log that holds fewer API spans than the window's bench spans, or an
offset that leaves some API span's end past its bench span's by more
than ``OFFSET_SPREAD_US``, gives None: the spans do not belong to these
calls.
"""

from __future__ import annotations

from .trace import covered, union

PHASES = ("stage", "capture", "replay", "wait", "read")
OFFSET_SPREAD_US = 200.0


def program_log():
    """The program's span log, or None where the program keeps none."""
    try:
        from spiht_tpu_torch import metrics
        return metrics.spans()
    except (ImportError, AttributeError):
        return None


class Call:
    """One traced call: its bench span (``bench``, a ``Records.spans``
    dict, on the trace's clock in us), its API span (``api``) and the
    spans under it (``under``), and ``at(ns)``, a log time on the trace's
    clock."""

    def __init__(self, bench, api, under, offset_us):
        self.bench, self.api, self.under = bench, api, under
        self.offset_us = offset_us

    def at(self, ns: int) -> float:
        return ns / 1e3 + self.offset_us

    def interval(self, s) -> tuple:
        """A log span's (start, end) on the trace's clock, inside the
        bench span."""
        a = max(self.at(s.start_ns), self.bench["start_us"])
        b = min(self.at(s.end_ns), self.bench["end_us"])
        return a, max(a, b)

    def phase(self, name: str) -> list:
        """The spans of phase ``name`` under the API span."""
        return [s for s in self.under if s.name.endswith("/" + name)]


def calls(records, direction, log=None):
    """[Call] of the direction's traced calls, or None where the log does
    not match them (see the module's doc)."""
    bench = sorted((s for s in records.spans if s["direction"] == direction),
                   key=lambda s: s["call"])
    log = program_log() if log is None else log
    if not bench or log is None:
        return None
    name = "spiht/api/" + bench[0]["api"]
    tops = sorted((s for s in log if s.name == name and s.parent is None),
                  key=lambda s: s.start_ns)
    if len(tops) < len(bench):
        return None
    tops = tops[len(tops) - len(bench):]
    # each API span lies inside its bench span: the offset is at least
    # each start's difference and at most each end's
    offset = max(b["start_us"] - a.start_ns / 1e3 for b, a in zip(bench, tops))
    if offset - min(b["end_us"] - a.end_ns / 1e3
                    for b, a in zip(bench, tops)) > OFFSET_SPREAD_US:
        return None
    under = {a.id: [] for a in tops}
    for s in log:
        if s.request in under and s.id != s.request:
            under[s.request].append(s)
    return [Call(b, a, under[a.id], offset) for b, a in zip(bench, tops)]


def images(cs) -> int:
    return sum(c.api.counts.get("images", 0) for c in cs)


def phase_ms(records, direction, phase: str, log=None):
    """Host ms an image in the phase's spans of the direction's calls."""
    cs = calls(records, direction, log)
    if not cs or not images(cs):
        return None
    ns = sum(s.end_ns - s.start_ns for c in cs for s in c.phase(phase))
    return ns / 1e6 / images(cs)


def idle_us(busy, intervals) -> float:
    """The time of the (disjoint) intervals in which no device operation
    of ``busy`` (``union`` of the operations) runs."""
    return sum((b - a) - covered(busy, a, b) for a, b in intervals)


def minus(interval, holes) -> list:
    """``interval`` less the (disjoint, sorted) ``holes``."""
    a, b = interval
    out = []
    for h0, h1 in holes:
        if h1 <= a or h0 >= b:
            continue
        if h0 > a:
            out.append((a, h0))
        a = max(a, h1)
    if a < b:
        out.append((a, b))
    return out
