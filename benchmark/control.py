"""Readings for the limits of the comparison: the program and its control.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \
        --seconds 3 [--control-seeds 1,2,3]

runs the cell in one process, a short window a seed, once as the cell
states it (float64, the configuration's working dtype: the lower
readings) and once for each control seed with the program's own float32
path switched on (``dtype=torch.float32``, the nearest precision below
the one the configuration states: the upper readings). Prints one JSON
line a run, then the largest lower and the smallest upper reading of each
compared number. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cell, spec
from .run import _json_safe


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    c = spec.cell(args.workload)
    readings = {"program": {}, "control": {}}
    correct = {"program": 0, "control": 0}
    runs = ([(s, "program", torch.float64) for s in _seeds(args.seeds)]
            + [(s, "control", torch.float32)
               for s in _seeds(args.control_seeds)])
    for seed, side, dtype in runs:
        res = cell.run(c, seed, args.seconds, False, "cuda", dtype)
        line = {"workload": args.workload, "seed": seed, "side": side,
                "correct": res["correct"], "attempted": res["attempted"],
                "checks": res["checks"], "metrics": res["metrics"]}
        print(json.dumps(_json_safe(line)), flush=True)
        correct[side] += bool(res["correct"])
        for k, v in res["checks"].items():
            readings[side].setdefault(k, []).append(v["value"])
    summary = {
        "lower": {k: max(v) for k, v in readings["program"].items()},
        "upper": {k: min(v) for k, v in readings["control"].items()},
        "runs_correct": correct,
    }
    print(json.dumps(_json_safe(summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
