"""The device idle the program's own host work causes, %: the part of the
direction's bench spans in which no device operation runs while the host
is inside the API span but not in its ``wait`` span (the call's sync),
the program's spans mapped onto the trace's clock (``benchmark.spans``).
It is a part of ``idle_pct`` of the same records.

``idle_by_phase`` puts the whole of ``idle_pct`` down to where the host
was. To print it, with the program-span metrics, for one traced run of a
cell on the card:

    python3 -m benchmark.metrics.idle_host_pct --workload W --seed N \
        [--seconds S]
"""

from __future__ import annotations

from .. import spans
from ..trace import union


def read(records, direction, log=None):
    cs = spans.calls(records, direction, log)
    if not cs:
        return None
    busy = union((o[2], o[3]) for o in records.ops)
    total = sum(c.bench["end_us"] - c.bench["start_us"] for c in cs)
    idle = 0.0
    for c in cs:
        waits = union(c.interval(s) for s in c.phase("wait"))
        idle += spans.idle_us(busy, spans.minus(c.interval(c.api), waits))
    return 100.0 * idle / total


def idle_by_phase(records, direction, log=None):
    """{piece: % of the direction's bench-span time idle there}: the
    device's idle share (``idle_pct``) put down to where the host was,
    ``outside`` the API span, in one of the program's ``spans.PHASES``,
    or in the API span's own code (``api_self``). The pieces sum to
    ``idle_pct``."""
    cs = spans.calls(records, direction, log)
    if not cs:
        return None
    busy = union((o[2], o[3]) for o in records.ops)
    total = sum(c.bench["end_us"] - c.bench["start_us"] for c in cs)
    out = dict.fromkeys(("outside", "api_self") + spans.PHASES, 0.0)
    for c in cs:
        api = c.interval(c.api)
        bench = (c.bench["start_us"], c.bench["end_us"])
        out["outside"] += spans.idle_us(busy, spans.minus(bench, [api]))
        held = []
        for p in spans.PHASES:
            iv = union(c.interval(s) for s in c.phase(p))
            out[p] += spans.idle_us(busy, iv)
            held.extend(iv)
        out["api_self"] += spans.idle_us(busy, spans.minus(api, union(held)))
    return {k: 100.0 * v / total for k, v in out.items()}


def main(argv=None) -> int:
    """One traced run of a cell on the card; prints one JSON line: the
    run's ``correct`` and per-layer metrics and, a direction, its traced
    calls' host p50, the program-span metrics and ``idle_by_phase``."""
    import argparse
    import json
    import statistics

    from .. import cell, spec, trace
    from . import api_self_ms, idle_pct, readback_ms, staging_ms

    p = argparse.ArgumentParser(description=main.__doc__.split(";")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    c = spec.cell(args.workload)
    kept = {}
    breakdown = trace.breakdown

    def keep(rec):  # cell.run hands its Records to breakdown alone
        kept["rec"] = rec
        return breakdown(rec)

    trace.breakdown = keep
    try:
        result = cell.run(c, args.seed, args.seconds, True, "cuda")
    finally:
        trace.breakdown = breakdown
    rec = kept["rec"]
    out = {"workload": args.workload, "seed": args.seed,
           "correct": result["correct"], "device": result["device"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "directions": {}}
    for d in spec.entry(c["traffic"]["entry"]).DIRECTIONS:
        ms = [1e3 * s["seconds"] for s in rec.spans if s["direction"] == d]
        out["directions"][d] = {
            "traced_calls": len(ms),
            "traced_p50_ms": statistics.median(ms) if ms else None,
            "idle_pct": idle_pct.read(rec, d),
            "idle_host_pct": read(rec, d),
            "staging_ms": staging_ms.read(rec, d),
            "readback_ms": readback_ms.read(rec, d),
            "api_self_ms": api_self_ms.read(rec, d),
            "idle_by_phase": idle_by_phase(rec, d),
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
