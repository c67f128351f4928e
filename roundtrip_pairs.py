"""Single-image round-trip wall time of two trees, in alternating processes
on one CUDA card.

Run from the repository root on a machine with a card:

    python3 roundtrip_pairs.py --tree DIR --tree DIR [--rounds N]

Each tree is a checkout of the repository (e.g. a commit unpacked with
``git archive`` into the ignored ``out/``; ``.`` for this one). Each round
runs the trees in the order first, second, second, first, each in a
process of its own started in that tree, which times chip_smoke.py's
phase 6 there: ``encode_image_device`` and ``decode_image_device`` of
configurations A and B at 1 bpp, host clock to a sync, median of 5, after
one untimed round trip (which builds the kernels if need be). It prints one
JSON line a process, then one a tree with every process's numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json
import chip_smoke as cs
import spiht_tpu_torch as pt

out = {}
for label, seed, settings, level in (("A", 1, cs.CONFIG_A, None),
                                     ("B", 2, cs.CONFIG_B, 3)):
    im = cs.image(seed, (3, 512, 512))
    er = pt.encode_image_device(im, settings, level, 512 * 512, device=cs.DEV)
    pt.decode_image_device(er, settings, device=cs.DEV)
    out[label + "_encode_ms"] = cs.median_ms(lambda: pt.encode_image_device(
        im, settings, level, 512 * 512, device=cs.DEV))
    out[label + "_decode_ms"] = cs.median_ms(
        lambda: pt.decode_image_device(er, settings, device=cs.DEV))
print(json.dumps(out))
"""


def run(tree: Path) -> dict:
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    if len(a.tree) != 2:
        ap.error("give two trees")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    first, second = (t.resolve() for t in a.tree)
    runs = {first: [], second: []}
    for rnd in range(a.rounds):
        for tree in (first, second, second, first):
            got = run(tree)
            runs[tree].append(got)
            print(json.dumps({"round": rnd, "tree": str(tree), **got}),
                  flush=True)
    for tree, rows in runs.items():
        print(json.dumps({"tree": str(tree), "runs": len(rows), **{
            k: [r[k] for r in rows] for k in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
