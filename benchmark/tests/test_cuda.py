"""Each cell on the card, briefly: ``python -m pytest benchmark/tests -m
cuda`` on a machine with a CUDA card and nvcc (skips without a card)."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(card, name, traced):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2**31 + 7), "--seconds", "2", "--trace", str(traced)],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    if traced:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
