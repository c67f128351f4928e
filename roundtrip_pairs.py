"""Single-image round-trip wall time, or the machine kernels' times, of two
trees, in alternating processes on one CUDA card.

Run from the repository root on a machine with a card:

    python3 roundtrip_pairs.py --tree DIR --tree DIR [--rounds N] [--kernels]

Each tree is a checkout of the repository (e.g. a commit unpacked with
``git archive`` into the ignored ``out/``; ``.`` for this one). Each round
runs the trees in the order first, second, second, first, each in a
process of its own started in that tree, which times chip_smoke.py's
phase 6 there: ``encode_image_device`` and ``decode_image_device`` of
configurations A and B at 1 bpp, host clock to a sync, median of 5, after
one untimed round trip (which builds the kernels if need be). With
``--kernels`` it times the machine kernels instead, by CUDA events as
chip_smoke.py's ``time_kernel`` does, at the shapes of chip_smoke.py's
kernel table (B1, B2, B2-log at A; B3 and, where the tree has it, B3-log
at B; B4 and B5 at the A batch of 16; batched B3 at the B batch of 8),
and the metadata trace at A (host clock to a sync, median of 5). It prints
one JSON line a process, then one a tree with every process's numbers.
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


KERNEL_CHILD = """
import json
import numpy as np
import torch
import chip_smoke as cs
import spiht_tpu_torch as pt
from spiht_tpu_torch.codec import decoder, encoder
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w, slices_to_wire

out = {}
for label, seed, settings, level in (("A", 1, cs.CONFIG_A, None),
                                     ("B", 2, cs.CONFIG_B, 3)):
    im = cs.image(seed, (3, 512, 512))
    arr, ll_h, ll_w = cs.forward(torch.as_tensor(im, device=cs.DEV),
                                 settings, level)
    out[label + " B1"] = cs.time_kernel(
        encoder.encode_machine, encoder.machine_args(arr, ll_h, ll_w,
                                                     512 * 512))
    er = pt.encode_image_device(im, settings, level, 512 * 512,
                                device=cs.DEV)
    words, nbits = decoder.words_tensor(er.encoded_bytes, cs.DEV)
    geo = (*arr.shape, ll_h, ll_w)
    args = decoder.machine_args(words, nbits, er.max_n, *geo)
    kernels = (("B3", "decode_seq"), ("B3-log", "decode_seq_log")) if (
        decoder.has_duplicate_parents(*geo[1:])) else (
        ("B2", "decode_lsp"), ("B2-log", "decode_lsp_log"))
    for name, fn in kernels:
        if hasattr(decoder, fn):
            out[label + " " + name] = cs.time_kernel(getattr(decoder, fn),
                                                     args)
    if label == "A":
        slices, _, _ = get_slices_and_h_w(512, 512, settings, level)
        wire = slices_to_wire(slices)
        out["A trace (host clock)"] = cs.median_ms(
            lambda: pt.decode_with_metadata(er.encoded_bytes, er.max_n, *geo,
                                            *wire, device=cs.DEV))
for label, settings, level, n, dec, fn in (
        ("A batch of 16", cs.CONFIG_A, None, 16, "B5", "decode_lsp_batch"),
        ("B batch of 8", cs.CONFIG_B, 3, 8, "batched B3", "decode_seq_batch")):
    ims = [cs.image(100 * (2 if n == 8 else 1) + b, (3, 512, 512))
           for b in range(n)]
    mbs = [cs.BUDGETS_A[b % 4] if n == 16 else 512 * 512 for b in range(n)]
    arrs, ll_h, ll_w = cs.forward(torch.as_tensor(np.stack(ims),
                                                  device=cs.DEV),
                                  settings, level)
    if n == 16:
        out[label + " B4"] = cs.time_kernel(
            encoder.encode_machine_batch,
            encoder.batch_machine_args(arrs, ll_h, ll_w, mbs))
    ers = pt.encode_images_device(ims, settings, level, mbs, device=cs.DEV)
    words, nbits = decoder.words_batch([e.encoded_bytes for e in ers], cs.DEV)
    args = decoder.batch_machine_args(words, nbits, [e.max_n for e in ers],
                                      *arrs.shape[1:], ll_h, ll_w)
    out[label + " " + dec] = cs.time_kernel(getattr(decoder, fn), args)
print(json.dumps(out))
"""


def run(tree: Path, child: str = CHILD) -> dict:
    r = subprocess.run([sys.executable, "-c", child], cwd=tree,
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", action="store_true",
                    help="time the machine kernels instead of phase 6")
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
            got = run(tree, KERNEL_CHILD if a.kernels else CHILD)
            runs[tree].append(got)
            print(json.dumps({"round": rnd, "tree": str(tree), **got}),
                  flush=True)
    for tree, rows in runs.items():
        print(json.dumps({"tree": str(tree), "runs": len(rows), **{
            k: [r[k] for r in rows] for k in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
