"""The result line's keys, the traced run's records and readers, the card
check and the import guard."""

import json
import subprocess
import sys

import pytest

from benchmark import cell, run, spec, trace
from benchmark.tests.helpers import tiny

ROOT = spec.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["kodak-batch-1bpp", "kodak-single-1bpp"])
def test_untraced_line(name):
    res = cell.run(tiny(name), 11, 0.3, False, "cpu")
    assert list(res) == KEYS + ["checks"]
    want = {m["name"] for m in spec.cell(name)["end_to_end"]}
    assert set(res["metrics"]) == want
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(run._json_safe(res))


class _NoProfiler:
    def __exit__(self, *a):
        pass


def _fake_trace(monkeypatch, kernel_name="void spiht_decode_kernel<1>(x)"):
    """A trace in which each call's span holds one bit machine and one
    transform kernel with a gap between them."""
    spans_seen = []

    def read(prof):
        ops, spans = [], {}
        for k, (direction, r) in enumerate(spans_seen):
            t = 1000.0 * k
            spans[(direction, r)] = (t, t + 900.0)
            ops.append((kernel_name, "kernel", t + 100.0, t + 400.0))
            ops.append(("void elementwise_kernel<3>(y)", "kernel", t + 500.0,
                        t + 800.0))
        spans_seen.clear()
        return ops, spans

    real_call = cell._call

    def call(prof, direction, r, fn, arg):
        spans_seen.append((direction, r))
        return real_call(None, direction, r, fn, arg)

    monkeypatch.setattr(cell, "_profiler", lambda: _NoProfiler())
    monkeypatch.setattr(cell, "_call", call)
    monkeypatch.setattr(trace, "read_trace", read)


@pytest.mark.parametrize("name", ["kodak-batch-1bpp", "uhd-single-0.5bpp"])
def test_traced_line(name, monkeypatch):
    _fake_trace(monkeypatch)
    res = cell.run(tiny(name), 12, 0.3, True, "cpu")
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"]
    want = {m["name"] for m in spec.cell(name)["per_layer"]}
    assert set(res["metrics"]) == want
    # two traced rounds of two calls; each span 900 us, 600 of them busy
    assert res["device"]["busy_s"] == pytest.approx(4 * 600e-6)
    for m, v in res["metrics"].items():
        if m.startswith("idle_pct."):
            assert v["value"] == pytest.approx(100 / 3)
    bd = res["breakdown"]
    assert len(bd["device_ops"]) == 2 and len(bd["idle_gaps"]) <= 10
    assert bd["idle_gaps"][0][1] == pytest.approx(100e-6)


def test_trace_without_kernels_fails_loudly(monkeypatch):
    _fake_trace(monkeypatch)
    monkeypatch.setattr(trace, "read_trace", lambda prof: ([], {}))
    with pytest.raises(RuntimeError, match="no kernel record"):
        cell.run(tiny("kodak-single-1bpp"), 13, 5.0, True, "cpu")


def test_a_listed_metric_that_reads_nothing_fails_loudly(monkeypatch):
    """A trace whose kernels include no bit machine leaves
    ``machine_ns_bit`` nothing to read: the run raises, and never drops
    the metric from its line."""
    _fake_trace(monkeypatch, kernel_name="void some_other_kernel<1>(x)")
    with pytest.raises(RuntimeError, match="machine_ns_bit"):
        cell.run(tiny("kodak-single-1bpp"), 14, 0.3, True, "cpu")


def test_readers_return_none_without_records():
    rec = trace.Records(ops=[], spans=[], geometry={}, calls=[])
    for m in spec.load_benchmark()["per_layer"]:
        read, direction = spec.layer_reader(m["name"])
        assert read(rec, direction) is None


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "kodak-single-1bpp", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT)
    if p.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_names_compared_whole():
    names = ["jax.numpy", "jaxlib", "spiht_tpu_torch", "spiht_tpu.codec",
             "flax", "spiht_tpu_torchx", "jaxtyping"]
    assert run.forbidden_modules(names) == ["flax", "jax", "jaxlib",
                                            "spiht_tpu"]
    assert run.forbidden_modules(["spiht_tpu_torch.codec.api"]) == []


def test_a_run_loads_no_forbidden_module():
    """A whole run's process (the port, the reference, the harness) holds
    no module of JAX or of the JAX package."""
    code = (
        "import sys\n"
        "from benchmark import cell, run\n"
        "from benchmark.tests.helpers import tiny\n"
        "cell.run(tiny('kodak-single-1bpp'), 1, 0.2, False, 'cpu')\n"
        "cell.run(tiny('kodak-batch-1bpp'), 1, 0.2, False, 'cpu')\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_bare_checkout_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "kodak-single-1bpp", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
