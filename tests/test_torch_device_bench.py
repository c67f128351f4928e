"""The port's bench (``python -m spiht_tpu_torch.codec.device_bench``) on
the CPU, in process: one JSON line on stdout, every ``exact_*`` true, and
exactly the documented keys, which are the reference bench's less its
modelled-host rates plus the port's additions. A lane that raises ends
the run with no line, a false ``exact_*`` exits 1 after the line, no card
exits 2, and nothing is cached on disk.

The run with every lane is made at 16x16, level 1: the hybrid decode
machine's full stream takes ~0.3 s a call on the CPU there (~6 s at the
fast run's 64x64), and the bench calls each lane four times.
"""

import json
import os
from pathlib import Path

import pytest
import torch

from spiht_tpu_torch.codec import decoder, device_bench, encoder

ROOT = Path(__file__).resolve().parent.parent
FAST = ["64x64", "3", "1.0", "fast=1", "batch=2", "ebatch=2", "device=cpu"]
ALL = ["16x16", "1", "1.0", "batch=2", "ebatch=2", "device=cpu"]
RATE = ("mpps", "ms", "exact")


def reference_keys(bpp, fast, batch, ebatch, ilv):
    """The keys the reference bench prints on its TPU route (where every
    lane reports), less ``*_modeled_host`` and the cache's ``commit``."""
    b = f"{bpp}bpp"
    keys = {"geom", "level", "backend"}
    for tag in ("full", b):
        keys |= {f"{p}_{tag}" for p in RATE}
        keys |= {f"{p}_dec_{tag}" for p in RATE}
        keys |= {f"mpps_dec_{tag}_kernel", f"mpps_dec_{tag}_materialized"}
        if not fast:
            keys |= {f"{p}_{lane}_{tag}" for p in RATE
                     for lane in ("enc_sorted", "dec_hybrid")}
    keys |= {f"ms_enc_pipeline_{b}", f"exact_enc_pipeline_{b}",
             f"mpps_enc_pipeline_{b}_kernel",
             f"mpps_enc_pipeline_{b}_materialized"}
    keys |= {f"ms_pipeline_{b}", f"mpps_dec_pipeline_{b}_kernel",
             f"mpps_dec_pipeline_{b}_materialized"}
    if batch:
        keys |= {"batch", f"mpps_dec_batch{batch}",
                 f"exact_dec_batch{batch}"}
    if ebatch:
        keys |= {"ebatch", f"mpps_enc_batch{ebatch}",
                 f"exact_enc_batch{ebatch}"}
    for d in ("enc", "dec") if ilv else ():
        keys |= {f"mpps_{d}_ilv{ilv}", f"exact_{d}_ilv{ilv}",
                 f"mpps_{d}_ilv{ilv}_kernel",
                 f"mpps_{d}_ilv{ilv}_materialized"}
    return keys


def additions(bpp, fast, batch, ebatch, ilv):
    """The port's own keys: the card, each lane's launches, the clock of
    each kernel time, and the decode pipeline's exactness."""
    b = f"{bpp}bpp"
    timed = ["dec_full", f"dec_{b}", f"enc_pipeline_{b}",
             f"dec_pipeline_{b}"]
    lanes = ["full", b, *timed]
    if not fast:
        lanes += [f"{lane}_{tag}" for lane in ("enc_sorted", "dec_hybrid")
                  for tag in ("full", b)]
    if batch:
        lanes.append(f"dec_batch{batch}")
    if ebatch:
        lanes.append(f"enc_batch{ebatch}")
    if ilv:
        lanes += [f"enc_ilv{ilv}", f"dec_ilv{ilv}"]
        timed += [f"enc_ilv{ilv}", f"dec_ilv{ilv}"]
    return ({"card", "power_limit_w", f"exact_pipeline_{b}"}
            | {f"launches_{lane}" for lane in lanes}
            | {f"kernel_clock_{lane}" for lane in timed})


def _run(argv, capsys, monkeypatch, tmp_path, ilv="2"):
    monkeypatch.setenv("SPIHT_TPU_BENCH_ILV", ilv)
    monkeypatch.chdir(tmp_path)
    rc = device_bench.main(argv)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err


@pytest.mark.parametrize("argv,fast", [(FAST, True), (ALL, False)],
                         ids=["fast", "all_lanes"])
def test_one_exact_line_with_the_documented_keys(argv, fast, capsys,
                                                 monkeypatch, tmp_path):
    root = sorted(os.listdir(ROOT))
    rc, lines, err = _run(argv, capsys, monkeypatch, tmp_path)
    assert rc == 0, err
    assert len(lines) == 1
    out = json.loads(lines[0])
    want = (reference_keys(1.0, fast, 2, 2, 2)
            | additions(1.0, fast, 2, 2, 2))
    assert set(out) == want
    exact = {k: v for k, v in out.items() if k.startswith("exact_")}
    assert exact and all(v is True for v in exact.values()), exact
    assert not any(k.endswith("_modeled_host") for k in out)
    assert out["backend"] == "cpu" and out["card"] is None
    # the CPU runs the plain versions: no kernel launches, host clock
    assert all(out[k] == {} for k in out if k.startswith("launches_"))
    assert all(out[k] == "host" for k in out
               if k.startswith("kernel_clock_"))
    assert all(out[k] > 0 for k in out if k.startswith(("mpps_", "ms_")))
    # no cache file, in the working directory or beside the package
    assert os.listdir(tmp_path) == [] and sorted(os.listdir(ROOT)) == root


def test_geometry_and_defaults(capsys, monkeypatch, tmp_path):
    """HxW, level and bpp as the reference reads them; the ilv lane off
    with SPIHT_TPU_BENCH_ILV=0, and the batch lanes off by default."""
    rc, lines, _ = _run(["24x40", "2", "0.5", "fast=1", "device=cpu"],
                        capsys, monkeypatch, tmp_path, ilv="0")
    out = json.loads(lines[0])
    assert rc == 0 and out["level"] == 2
    assert set(out) == (reference_keys(0.5, True, 0, 0, 0)
                        | additions(0.5, True, 0, 0, 0))
    assert device_bench._parse([])[:5] == (512, 512, 6, 1.0, False)


def test_a_false_exact_prints_and_exits_1(capsys, monkeypatch, tmp_path):
    """A lane whose output differs from the native scheduler's is reported
    false, the line is still printed, and the run exits 1."""
    nat = device_bench._native()

    class Wrong:
        def __getattr__(self, name):
            return getattr(nat, name)

        def decode(self, *a, **k):
            rec = nat.decode(*a, **k)
            rec.reshape(-1)[0] += 1
            return rec

    monkeypatch.setattr(device_bench, "_native", Wrong)
    rc, lines, err = _run(FAST[:3] + ["fast=1", "device=cpu"], capsys,
                          monkeypatch, tmp_path, ilv="0")
    assert rc == 1
    out = json.loads(lines[-1])
    assert out["exact_dec_full"] is False and out["exact_full"] is True
    assert "not exact" in err


@pytest.mark.parametrize("module,name", [(encoder, "pallas_encode_fn"),
                                         (decoder, "pallas_decode_fn")])
def test_a_failing_lane_ends_the_run(module, name, capsys, monkeypatch,
                                     tmp_path):
    """No lane's failure is swallowed: the exception leaves ``main``
    before the line is printed (as ``python -m``, an uncaught exception
    exits 1)."""
    def broken(*a, **k):
        raise RuntimeError("lane forced to fail")

    monkeypatch.setattr(module, name, broken)
    with pytest.raises(RuntimeError, match="forced"):
        _run(["16x16", "1", "1.0", "fast=1", "device=cpu"], capsys,
             monkeypatch, tmp_path, ilv="0")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("empty,clock", [(0, "profiler"), (2, "profiler"),
                                         (3, "events")])
def test_an_empty_trace_is_taken_again_then_events(empty, clock,
                                                  monkeypatch):
    """A torch.profiler trace with no kernel in it is taken again; after
    ``PROFILE_TRIES`` empty traces the time comes from CUDA events, and
    the clock says so. The card's calls are stood in for."""
    assert device_bench.PROFILE_TRIES == 3
    bench = device_bench._Bench(torch.device("cpu"))
    bench.dev = torch.device("cuda", 0)
    traces = []

    def profiled(fn, *args):
        traces.append(fn(*args))
        return 0.0 if len(traces) <= empty else 2e-3

    monkeypatch.setattr(bench, "sync", lambda: None)
    monkeypatch.setattr(bench, "profiled", profiled)
    monkeypatch.setattr(bench, "events", lambda fn, *args: 5e-3)
    got = bench.device(lambda x: x + 1, 1)
    assert got == ((2e-3, "profiler") if clock == "profiler"
                   else (5e-3, "events"))
    assert traces == [2] * min(empty + 1, 3)
    bench.rates("dec_full", 1e6, 1e-2, got)
    assert bench.out["kernel_clock_dec_full"] == clock
    assert bench.out["mpps_dec_full_kernel"] == 1 / got[0]


def test_no_card_exits_2(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, err = _run(["64x64", "3"], capsys, monkeypatch, tmp_path)
    assert rc == 2 and lines == [] and "no CUDA device" in err
