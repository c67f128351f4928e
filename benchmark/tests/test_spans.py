"""The readers of the program's spans (``benchmark/spans.py``,
``staging_ms``, ``readback_ms``, ``api_self_ms``, ``idle_host_pct``) on
synthetic records and span logs, and on a traced run on the CPU."""

import random

import pytest

from benchmark import cell, spans, trace
from benchmark.metrics import (
    api_self_ms, idle_host_pct, idle_pct, readback_ms, staging_ms,
)
from benchmark.tests.helpers import tiny
from spiht_tpu_torch import metrics
from spiht_tpu_torch.metrics import Span

API = "encode_images_device"
DIRECTION = "enc_batch"
IMAGES = 4
OFFSET_US = 5e6  # the trace's clock minus the log's
# a call's spans, (phase, start us, end us) from the API span's start
PHASES = [("stage", 10, 310), ("replay", 320, 400), ("wait", 400, 900),
          ("read", 900, 990)]
API_US = 1000


class _Ids:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n


def _call(ids, t_us, phases=PHASES, api=API):
    """The spans of one API call starting at t_us on the log's clock."""
    top = ids()
    out = [Span(f"spiht/encode_batch/{p}", int(1e3 * (t_us + a)),
                int(1e3 * (t_us + b)), ids(), top, top,
                {"bytes": 100} if p in ("stage", "read") else {})
           for p, a, b in phases]
    out.append(Span(f"spiht/api/{api}", int(1e3 * t_us),
                    int(1e3 * (t_us + API_US)), top, None, top,
                    {"images": IMAGES}))
    return out


def _records(starts, busy, shift=None):
    """Records of calls whose API spans start at ``starts`` (log us): each
    bench span 5 us wider on each side, on the trace's clock; one device
    operation a call at (a, b) us from its API span's start."""
    shift = shift or [0.0] * len(starts)
    spans_, ops = [], []
    for r, (t, d) in enumerate(zip(starts, shift)):
        t0 = t + OFFSET_US + d
        spans_.append({"direction": DIRECTION, "api": API, "call": r,
                       "start_us": t0 - 5, "end_us": t0 + API_US + 5,
                       "images": IMAGES})
        a, b = busy
        ops.append(("void k(x)", "kernel", t0 + a, t0 + b))
    return trace.Records(ops=ops, spans=spans_, geometry={}, calls=[])


def _window(n=3, t0=1e6, busy=(400, 800)):
    ids = _Ids()
    starts = [t0 + 2000.0 * k for k in range(n)]
    log = [s for t in starts for s in _call(ids, t)]
    return _records(starts, busy), log, ids


def test_readers_on_a_window():
    rec, log, _ = _window()
    n = 3
    assert staging_ms.read(rec, DIRECTION, log) == pytest.approx(
        300e-3 * n / (n * IMAGES))
    assert readback_ms.read(rec, DIRECTION, log) == pytest.approx(
        90e-3 / IMAGES)
    # 1000 us less 300 + 80 + 500 + 90 us of children
    assert api_self_ms.read(rec, DIRECTION, log) == pytest.approx(
        30e-3 / IMAGES)
    # bench 1010 us a call, 400 busy inside the wait; the API span less
    # its wait (500 us) is all idle
    assert idle_pct.read(rec, DIRECTION) == pytest.approx(100 * 610 / 1010)
    assert idle_host_pct.read(rec, DIRECTION, log) == pytest.approx(
        100 * 500 / 1010)
    parts = idle_host_pct.idle_by_phase(rec, DIRECTION, log)
    want = {"outside": 10, "api_self": 30, "stage": 300, "capture": 0,
            "replay": 80, "wait": 100, "read": 90}
    assert parts == pytest.approx({k: 100 * v / 1010 for k, v in want.items()})
    assert sum(parts.values()) == pytest.approx(idle_pct.read(rec, DIRECTION))


def test_a_traced_again_window_reads_the_logs_tail():
    """A first trace with no kernel record is taken again: its calls stay
    at the head of the log, and the records hold only the last trace's."""
    rec, log, ids = _window(t0=2e6)
    slow = [("stage", 10, 910), ("replay", 920, 930), ("wait", 930, 980),
            ("read", 980, 990)]
    head = [s for t in (1e6, 1.002e6) for s in _call(ids, t, slow)]
    assert staging_ms.read(rec, DIRECTION, head + log) == pytest.approx(
        300e-3 / IMAGES)


def test_fewer_api_spans_than_calls_read_nothing():
    rec, log, _ = _window()
    short = [s for s in log if s.request != log[-1].request]
    for reader in (staging_ms, readback_ms, api_self_ms, idle_host_pct):
        assert reader.read(rec, DIRECTION, short) is None
    assert idle_host_pct.idle_by_phase(rec, DIRECTION, short) is None


def test_offsets_that_spread_read_nothing():
    """Spans that do not belong to the window's calls (offsets 300 us
    apart) read nothing."""
    _, log, _ = _window()
    starts = sorted(s.start_ns / 1e3 for s in log if s.parent is None)
    rec = _records(starts, (400, 800), shift=[0.0, 300.0, 0.0])
    assert spans.calls(rec, DIRECTION, log) is None
    assert idle_host_pct.read(rec, DIRECTION, log) is None


def test_another_direction_or_no_log_reads_nothing(monkeypatch):
    rec, log, _ = _window()
    assert staging_ms.read(rec, "dec_batch", log) is None
    monkeypatch.setattr(spans, "program_log", lambda: None)
    assert staging_ms.read(rec, DIRECTION) is None


@pytest.mark.parametrize("seed", range(4))
def test_idle_host_pct_is_part_of_idle_pct(seed):
    """On random windows the host's share never passes the idle share,
    and the pieces of ``idle_by_phase`` sum to it."""
    rng = random.Random(seed)
    ids = _Ids()
    starts, log, ops, bench = [], [], [], []
    t = 1e6
    for r in range(5):
        cuts = sorted(rng.uniform(0, API_US) for _ in range(7))
        phases = [("stage", cuts[0], cuts[1]), ("capture", cuts[1], cuts[2]),
                  ("replay", cuts[2], cuts[3]), ("wait", cuts[3], cuts[5]),
                  ("read", cuts[5], cuts[6])]
        log += _call(ids, t, phases)
        t0 = t + OFFSET_US + rng.uniform(-50, 50)
        bench.append({"direction": DIRECTION, "api": API, "call": r,
                      "start_us": t0 - rng.uniform(0, 30),
                      "end_us": t0 + API_US + rng.uniform(0, 30),
                      "images": IMAGES})
        for _ in range(3):
            a = t0 + rng.uniform(-20, API_US)
            ops.append(("void k(x)", "kernel", a, a + rng.uniform(1, 200)))
        starts.append(t)
        t += 3000
    rec = trace.Records(ops=ops, spans=bench, geometry={}, calls=[])
    idle = idle_pct.read(rec, DIRECTION)
    host = idle_host_pct.read(rec, DIRECTION, log)
    assert 0 <= host <= idle + 1e-9
    parts = idle_host_pct.idle_by_phase(rec, DIRECTION, log)
    assert sum(parts.values()) == pytest.approx(idle, abs=1e-6)


def _cpu_trace(monkeypatch):
    """A traced run on the CPU under a real profiler: the trace's bench
    spans as recorded, with two synthetic kernels in each (the CPU has
    none; a bit machine and a transform, for the accepted readers),
    and a dict where the run's Records land."""
    from torch.profiler import ProfilerActivity, profile

    def profiler():
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.__enter__()
        return prof

    real_read, real_breakdown = trace.read_trace, trace.breakdown
    kept = {}

    def read(prof):
        ops, found = real_read(prof)
        for a, b in found.values():
            m = (a + b) / 2
            ops = ops + [("void spiht_decode_k(x)", "kernel", a, m),
                         ("void elementwise_k(x)", "kernel", m, m + 1)]
        return ops, found

    def breakdown(rec):
        kept["rec"] = rec
        return real_breakdown(rec)

    monkeypatch.setattr(cell, "_profiler", profiler)
    monkeypatch.setattr(trace, "read_trace", read)
    monkeypatch.setattr(trace, "breakdown", breakdown)
    return kept


@pytest.mark.parametrize("name", ["kodak-batch-1bpp", "kodak-single-1bpp"])
def test_a_traced_run_on_the_cpu(name, monkeypatch):
    """The program's spans of a real traced run match its bench spans
    (the trace's clock and the log's, joined by one offset), and every
    reader reads a number."""
    kept = _cpu_trace(monkeypatch)
    metrics.clear_spans()
    c = tiny(name)
    res = cell.run(c, 15, 0.3, True, "cpu")
    assert res["correct"]
    rec = kept["rec"]
    enc, dec = ("enc_batch", "dec_batch") if "batch" in name else (
        "enc_single", "dec_single")
    for d in (enc, dec):
        cs = spans.calls(rec, d)
        assert cs and len(cs) == len([s for s in rec.spans
                                      if s["direction"] == d])
        for cl in cs:  # each API span lies inside its bench span
            a, b = cl.at(cl.api.start_ns), cl.at(cl.api.end_ns)
            assert cl.bench["start_us"] - 50 <= a < b <= \
                cl.bench["end_us"] + 50
        assert staging_ms.read(rec, d) > 0
        assert api_self_ms.read(rec, d) > 0
        host = idle_host_pct.read(rec, d)
        assert 0 < host <= idle_pct.read(rec, d)
    assert readback_ms.read(rec, enc) > 0
