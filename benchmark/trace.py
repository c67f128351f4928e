"""The traced run's records, read from torch.profiler's trace.

The harness wraps every API call in a ``torch.profiler.record_function``
span named ``bench/<direction>/<call>`` (``direction`` is ``enc_batch``,
``dec_batch``, ``enc_single`` or ``dec_single``; each call ends in a
sync, so its device work lies inside its span). A bounded part of the
window runs under the profiler, with CUPTI's device activity on; its
trace (the Chrome trace format) gives the device operations (kernels,
memcpys and memsets, each with its start and end on the host's clock)
and the spans' own start and end on the same clock. ``Records`` joins
them with what the harness knew of each call (images, pixels, stream
bits). The readers in ``benchmark/metrics/`` take their numbers from a
``Records``.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = re.compile(r"^bench/(\w+)/(\d+)$")
# the bit machines of ``spiht_tpu_torch/csrc/spiht_{encode,decode}.cu``
MACHINE = re.compile(r"\bspiht_(encode|decode)")


@dataclass
class Records:
    ops: list  # (name, cat, start_us, end_us) of each device operation
    spans: list  # {"direction", "call", "start_us", "end_us", **the call's}
    geometry: dict  # shapes and bytes of the cell's images and coefficients
    calls: list  # every call of the window

    def in_spans(self, direction: str):
        """(spans, the device operations that start inside them)."""
        spans = [s for s in self.spans if s["direction"] == direction]
        ops = []
        for s in spans:
            ops.extend(o for o in self.ops
                       if s["start_us"] <= o[2] < s["end_us"])
        return spans, ops


def union(intervals) -> list:
    """Disjoint, sorted (start, end) covering the given intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals, start: float, end: float) -> float:
    """Length of [start, end) that the (disjoint) intervals cover."""
    return sum(max(0.0, min(b, end) - max(a, start)) for a, b in intervals)


def read_trace(prof) -> tuple:
    """(device operations, spans by (direction, call)) of a profile."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    ops, spans = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            ops.append((name, cat, start, end))
        elif cat == "user_annotation":
            m = SPAN.match(name)
            if m:
                spans[(m.group(1), int(m.group(2)))] = (start, end)
    return ops, spans


def busy_and_window(rec: Records) -> tuple:
    """(seconds some device operation ran, seconds of the traced window):
    the window runs from the first traced span's start to the last one's
    end."""
    start = min(s["start_us"] for s in rec.spans)
    end = max(s["end_us"] for s in rec.spans)
    busy = covered(union((o[2], o[3]) for o in rec.ops), start, end)
    return busy / 1e6, (end - start) / 1e6


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ").strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()


def breakdown(rec: Records) -> dict:
    """The ten device operations that took the most time, by name, and
    the ten longest gaps between device operations inside a call's span,
    by the API call that was running."""
    total = {}
    for name, _, a, b in rec.ops:
        key = short_name(name)
        total[key] = total.get(key, 0.0) + (b - a) / 1e6
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:10]
    busy = union((o[2], o[3]) for o in rec.ops)
    gaps = []
    for s in rec.spans:
        t = s["start_us"]
        for a, b in busy:
            if b <= s["start_us"] or a >= s["end_us"]:
                continue
            if a > t:
                gaps.append((s["api"], (a - t) / 1e6))
            t = max(t, b)
        if s["end_us"] > t:
            gaps.append((s["api"], (s["end_us"] - t) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [list(g) for g in gaps[:10]]}
