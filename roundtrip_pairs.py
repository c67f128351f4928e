"""Single-image round-trip wall time, the batch codec's, or the machine
kernels' times, of two trees, in alternating processes on one CUDA card.

Run from the repository root on a machine with a card:

    python3 roundtrip_pairs.py --tree DIR --tree DIR [--rounds N]
        [--kernels | --batch | --trace | --host]

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
at B; B4 and B5 at the A batch of 16; batched B3 at the B batch of 8;
B7 at A), the metadata trace at A (host clock to a sync, median of 5),
and B6 on the A batch's 13.9 M scaled coefficients: its wrapper as
time_kernel times it, and the kernel alone, cold and warm ([median, min,
max]), by chip_smoke.py's ``quantize_cold_warm`` (its launch on outputs
allocated once, 21 times after a 128 MB write that flushes the L2 and 21
times back to back; a copy of it for a tree whose chip_smoke.py lacks
it). With ``--batch`` it times the batch codec instead:
``encode_images_device`` and ``decode_images_device`` of chip_smoke.py's
A batch (phase 8's 16 images and budgets) at B = 16 and, tiled, 128, and
of the B batch (phase 9's 8 images at 1 bpp), host clock to a sync,
median of 5, after one untimed round trip (a tree whose batch codec runs
as programs captures them there). With ``--trace`` it times
``decode_with_metadata`` at A (B2-log) and B (B3-log), 1 bpp, and with
``--host`` the host-scheduled codec of the A batch of 16 in float32:
``encode_images`` without a budget (B6) and at phase 8's budgets (the
budget path), and ``decode_images``; each median of 5 after one untimed
call. It prints one JSON line a process, then one a tree with every
process's numbers.
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


BATCH_CHILD = """
import json
import chip_smoke as cs
import spiht_tpu_torch as pt

out = {}
ims_a = [cs.image(100 + b, (3, 512, 512)) for b in range(16)]
mbs_a = [cs.BUDGETS_A[b % 4] for b in range(16)]
ims_b = [cs.image(200 + b, (3, 512, 512)) for b in range(8)]
for label, settings, level, ims, mbs in (
        ("A16", cs.CONFIG_A, None, ims_a, mbs_a),
        ("A128", cs.CONFIG_A, None, ims_a * 8, mbs_a * 8),
        ("B8", cs.CONFIG_B, 3, ims_b, [512 * 512] * 8)):
    ers = pt.encode_images_device(ims, settings, level, mbs, device=cs.DEV)
    pt.decode_images_device(ers, settings, device=cs.DEV)
    out[label + "_encode_ms"] = cs.median_ms(lambda: pt.encode_images_device(
        ims, settings, level, mbs, device=cs.DEV))
    out[label + "_decode_ms"] = cs.median_ms(
        lambda: pt.decode_images_device(ers, settings, device=cs.DEV))
print(json.dumps(out))
"""


TRACE_CHILD = """
import json
import chip_smoke as cs
import spiht_tpu_torch as pt
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w, slices_to_wire

out = {}
for label, seed, settings, level in (("A", 1, cs.CONFIG_A, None),
                                     ("B", 2, cs.CONFIG_B, 3)):
    im = cs.image(seed, (3, 512, 512))
    er = pt.encode_image_device(im, settings, level, 512 * 512, device=cs.DEV)
    slices, eh, ew = get_slices_and_h_w(512, 512, settings, level)
    geo = (3, eh, ew, slices[0][1].stop, slices[0][2].stop)
    args = (er.encoded_bytes, er.max_n, *geo, *slices_to_wire(slices))
    pt.decode_with_metadata(*args, device=cs.DEV)
    out[label + "_trace_ms"] = cs.median_ms(
        lambda: pt.decode_with_metadata(*args, device=cs.DEV))
print(json.dumps(out))
"""


HOST_CHILD = """
import json
import os
import torch
import chip_smoke as cs
import spiht_tpu_torch as pt

out = {}
ims = [cs.image(100 + b, (3, 512, 512)) for b in range(16)]
mbs = [cs.BUDGETS_A[b % 4] for b in range(16)]
f32 = torch.float32
for label, budgets in (("standard", None), ("budget", mbs)):
    ers = pt.encode_images(ims, cs.CONFIG_A, None, budgets, device=cs.DEV,
                           dtype=f32)
    out["A16_f32_encode_" + label + "_ms"] = cs.median_ms(
        lambda: pt.encode_images(ims, cs.CONFIG_A, None, budgets,
                                 device=cs.DEV, dtype=f32))
pt.decode_images(ers, cs.CONFIG_A, device=cs.DEV)
out["A16_decode_ms"] = cs.median_ms(
    lambda: pt.decode_images(ers, cs.CONFIG_A, device=cs.DEV))
print(json.dumps(out))
"""


KERNEL_CHILD = """
import json
import numpy as np
import torch
import chip_smoke as cs
import spiht_tpu_torch as pt
from spiht_tpu_torch import _build
from spiht_tpu_torch.codec import api as tapi
from spiht_tpu_torch.codec import decoder, encoder
from spiht_tpu_torch.ops.quantize_kernels import quantize_compact
from spiht_tpu_torch.torch_transform import _scaled_coeffs
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w, slices_to_wire


# chip_smoke.quantize_cold_warm's measurement, for a tree that lacks it:
# B6's launch on outputs allocated once, reps times each after a 128 MB
# write (cold) and back to back (warm), by CUDA events, after one untimed
# launch
def quantize_cold_warm(x, scale, reps=21):
    go = _build.load("spiht_quantize").spiht_quantize_compact_launch
    outs = [torch.empty(x.shape, dtype=t, device=cs.DEV)
            for t in (torch.int32, torch.int16, torch.int8)]
    ofl = torch.zeros((), dtype=torch.int32, device=cs.DEV)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=cs.DEV)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        assert go(x.data_ptr(), x.numel(), float(np.float32(scale)),
                  *(o.data_ptr() for o in outs), ofl.data_ptr(),
                  stream) == 0

    launch()
    res = {}
    for kind in ("cold", "warm"):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(reps)]
        for e0, e1 in ev:
            if kind == "cold":
                flush.fill_(1)
            e0.record()
            launch()
            e1.record()
        torch.cuda.synchronize()
        t = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
        res[kind] = {"median_ms": t[reps // 2], "min_ms": t[0],
                     "max_ms": t[-1]}
    return res

out = {}
for label, seed, settings, level in (("A", 1, cs.CONFIG_A, None),
                                     ("B", 2, cs.CONFIG_B, 3)):
    im = cs.image(seed, (3, 512, 512))
    arr, ll_h, ll_w = cs.forward(torch.as_tensor(im, device=cs.DEV),
                                 settings, level)
    out[label + " B1"] = cs.time_kernel(
        encoder.encode_machine, encoder.machine_args(arr, ll_h, ll_w,
                                                     512 * 512))
    if label == "A":
        out["A B7"] = cs.time_kernel(
            encoder.encode_machine_seq,
            encoder.machine_args(arr, ll_h, ll_w, 512 * 512))
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
    if n == 16:  # B6 on the batch's scaled float32 coefficients
        x = _scaled_coeffs(tapi._device_batch(ims, cs.DEV), settings, level,
                           torch.float32)[0].to(torch.float32)
        scale = settings.quantization_scale
        out["B6 wrapper"] = cs.time_kernel(quantize_compact, (x, scale))
        # the kernel alone, cold and warm, as chip_smoke.py's phase 13
        # times it; a tree whose chip_smoke.py lacks that gets a copy
        cold_warm = getattr(cs, "quantize_cold_warm", quantize_cold_warm)
        for kind, r in cold_warm(x, scale).items():
            out[f"B6 {kind}"] = [r["median_ms"], r["min_ms"], r["max_ms"]]
        del x
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
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--kernels", action="store_true",
                      help="time the machine kernels instead of phase 6")
    what.add_argument("--batch", action="store_true",
                      help="time the batch codec instead of phase 6")
    what.add_argument("--trace", action="store_true",
                      help="time the metadata trace instead of phase 6")
    what.add_argument("--host", action="store_true",
                      help="time the host-scheduled batch codec instead")
    a = ap.parse_args()
    if len(a.tree) != 2:
        ap.error("give two trees")
    child = (KERNEL_CHILD if a.kernels else BATCH_CHILD if a.batch
             else TRACE_CHILD if a.trace else HOST_CHILD if a.host
             else CHILD)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    first, second = (t.resolve() for t in a.tree)
    runs = {first: [], second: []}
    for rnd in range(a.rounds):
        for tree in (first, second, second, first):
            got = run(tree, child)
            runs[tree].append(got)
            print(json.dumps({"round": rnd, "tree": str(tree), **got}),
                  flush=True)
    for tree, rows in runs.items():
        print(json.dumps({"tree": str(tree), "runs": len(rows), **{
            k: [r[k] for r in rows] for k in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
