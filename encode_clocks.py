"""Where the encode machine's cycles go (kernels B1 and B4), on one CUDA card.

Run from the repository root on a machine with a card:

    python3 encode_clocks.py [--csrc DIR ...]

For each ``csrc`` directory given (default: ``spiht_tpu_torch/csrc``; give
another tree's, e.g. a commit unpacked with ``git archive``, for a
before/after pair in one run), it builds ``spiht_encode.cu`` twice with
nvcc into ``spiht_tpu_torch/build/clocks/``: as it is, and with clock64
counters inserted at run time (the instrumented copy is never kept). It then encodes chip_smoke.py's configuration A
(1 bpp) through B1 and its A batch (16 images, phase 8's budgets) through
B4 and prints one JSON line each: the kernel's time by CUDA events (as
chip_smoke.py times it), the instrumented build's time, whether both
builds equal the plain version, and thread 0's counters, summed over the
batch's blocks for B4: cycles of the whole machine, of each pass, of each
pass's gathers (its entries' loads, and a LIS fire's children's) and
decisions (all after the gathers up to the chunk's last barrier and, for
the block-wide machine, its block scans and chunk ends apart), and the
number of chunks of each pass and of LIS chunks shorter than a full chunk.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from decode_clocks import EPILOGUE, _sub, build
from spiht_tpu_torch.codec import encoder
from spiht_tpu_torch.torch_transform import forward
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

ROOT = Path(__file__).resolve().parent
COUNTERS = ["total", "lip", "lis", "refine", "lip_gather", "lip_decide",
            "lis_gather", "lis_decide", "ref_gather", "ref_decide",
            "lip_chunks", "lis_chunks", "ref_chunks", "lis_short_chunks",
            "scan", "chunk_end"]
PROLOGUE = """
__device__ unsigned long long g_clk[16];
__shared__ unsigned long long s_clk[16];
#define CLK(v) long long v = clock64()
#define CLK_ADD(i, v) do { if (threadIdx.x == 0) s_clk[i] += clock64() - (v); } while (0)
#define CLK_INC(i) do { if (threadIdx.x == 0) s_clk[i] += 1; } while (0)
"""
# around the machine's call: zero the block's counters, time the whole
# machine, then add them to the global ones
AROUND = (r"\n\1if (threadIdx.x < 16) s_clk[threadIdx.x] = 0;\n"
          r"\1__syncthreads();\n\1CLK(t_all);\n\1\2\n\1CLK_ADD(0, t_all);\n"
          r"\1__syncthreads();\n"
          r"\1if (threadIdx.x < 16) atomicAdd(&g_clk[threadIdx.x], "
          r"s_clk[threadIdx.x]);")


def instrument(src: str) -> str:
    """The encode source with counters. The passes are found by anchors
    common to the warp-0 design and the block-wide one; each
    chunk's parts by the anchors of the design the source has."""
    src = _sub(src, r'(#include "spiht_common.cuh"\n)', r"\1" + PROLOGUE)
    src = _sub(src, r"(#endif  // __CUDACC__\s*)$", EPILOGUE + r"\1")
    # the passes, from their comments (both designs)
    src = _sub(src, r"(\n *// ---- LIP pass ----\n)", r"\1CLK(t_lip);\n")
    src = _sub(src, r"(\n\s*s\.lip_n = s\.keep;\n)(\n\s*// ---- LIS pass)",
               r"\1CLK_ADD(1, t_lip);\n\2")
    src = _sub(src, r"(\n *// ---- LIS pass[^\n]*\n)", r"\1CLK(t_lis);\n")
    src = _sub(src, r"(\n\s*// ---- refinement of the entries[^\n]*\n)",
               r"\nCLK_ADD(2, t_lis);\1CLK(t_ref);\n")
    if "enc_lis_chunk" in src:  # warp 0 decides, after a block gather
        src = _sub(src, r"\n(\s*)(encode_machine\(a, sh, [a-zA-Z.]+, "
                        r"[a-zA-Z.]+\);)", AROUND, count=2)
        src = _sub(src, r"(\n    if \(tid == 0\) \{\n      sh\.pub\.lip_n)",
                   r"\nCLK_ADD(3, t_ref);\1")
        src = _sub(src, r"(const int32_t m = min32\(SPIHT_CHUNK, lis_len - "
                        r"r0\);\n)",
                   r"\1if (m < SPIHT_CHUNK) CLK_INC(13);\n")
        for first, g, d, c in (
                (r"const int32_t node = a\.lip\[r0 \+ i\];", 4, 5, 10),
                (r"const int32_t e = a\.lis\[r0 \+ i\]", 6, 7, 11),
                (r"sh\.t3\[i\] = a\.t3s\[a\.lsp\[r0 \+ i\]\];", 8, 9, 12)):
            src = _sub(src, r"(\n\s*for \(int32_t i = tid; i < m; i \+= nt\)"
                            rf"[ {{\n]*{first}.*?SPIHT_SYNC\(\);\n)(.*?)"
                            r"(\n\s*SPIHT_SYNC\(\);)",
                       rf"\nCLK(tg);\1CLK_ADD({g}, tg);\nCLK_INC({c});\n"
                       rf"CLK(tc);\n\2\nCLK_ADD({d}, tc);\3")
        return src
    # the block-wide machine
    src = _sub(src, r"\n(\s*)(encode_machine<NT, E>\(a, sh, tid\);)", AROUND)
    src = _sub(src, r"(const int32_t m = min32\(CH, s\.lis_n - r0\);\n)",
               r"\1if (m < CH) CLK_INC(13);\n")
    for first, scan, end, g, d, c in (
            (r"int32_t x\[E\];", r"uint32_t tsig;",
             r"lip_counts\(m, tsig\), tid", 4, 5, 10),
            (r"LisEntry le\[E\];", r"uint64_t tot;", r"tot, tid", 6, 7, 11)):
        src = _sub(src, rf"(\n\s*{first})", rf"\nCLK(tg);\nCLK_INC({c});\1")
        src = _sub(src, rf"(\n\s*)({scan}\n\s*[^\n]*block_scan[^\n]*\n)",
                   rf"\1CLK_ADD({g}, tg);\nCLK(tc);\nCLK(ts);\1\2"
                   r"CLK_ADD(14, ts);\n")
        src = _sub(src, rf"if \(enc_chunk_end<NT>\(a, sh, s, {end}\)\) "
                        r"return;",
                   rf"CLK(te);\nconst bool stop_ = enc_chunk_end<NT>(a, sh, "
                   rf"s, {end.replace(chr(92), '')});\nCLK_ADD(15, te);\n"
                   rf"CLK_ADD({d}, tc);\nif (stop_) return;")
    src = _sub(src, r"(\n\s*)(uint32_t bits = 0;\n\s*for \(int j = 0; j < E; "
                    r"\+\+j\)\n\s*if \(k0 \+ j < min32\(m, room\)\))",
               r"\1CLK(tg);\1CLK_INC(12);\1\2")
    src = _sub(src, r"(\n\s*)(SPIHT_SYNC\(\);  // the last chunk's flush)",
               r"\1CLK_ADD(8, tg);\1CLK(tc);\1\2")
    src = _sub(src, r"(      enc_flush<NT>\(a, sh, s, s\.pos, false, tid\);\n)"
                    r"(    \}\n)(  \}\n\n  if \(tid == 0\) write_stat)",
               r"\1CLK_ADD(9, tc);\n\2CLK_ADD(3, t_ref);\n\3")
    return src


def launch(lib, batch, args):
    """One B1 (or, with ``batch``, B4) launch of ``lib`` on
    ``encoder.machine_args`` (``batch_machine_args``). Returns (words,
    stat)."""
    dev = args[0].device
    B = args[0].shape[0] if batch else 1
    caps = args[8] if batch else args[9]
    cw = args[9] if batch else args[10]
    lip, lis, lsp = encoder.scratch_queues(caps, B, dev)
    words = torch.empty(B, cw, dtype=torch.int32, device=dev)
    stat = torch.empty(B, encoder.STAT_LEN, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    tail = [lip.data_ptr(), caps[0], lis.data_ptr(), caps[1], lsp.data_ptr(),
            caps[2], words.data_ptr(), cw, stat.data_ptr(), stream]
    if batch:
        t1, t3s, child0, lip0, lis0, w, max_n, max_bits = args[:8]
        rc = lib.spiht_encode_batch_launch(
            B, t1.data_ptr(), t3s.data_ptr(), child0.data_ptr(),
            lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(),
            t1.shape[1], w, max_n.data_ptr(), max_bits.data_ptr(), *tail)
    else:
        t1, t3s, child0, lip0, lis0, w, max_n, mb, capped = args[:9]
        rc = lib.spiht_encode_launch(
            t1.data_ptr(), t3s.data_ptr(), child0.data_ptr(),
            lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(), w,
            max_n.data_ptr(), mb, int(capped), *tail)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return (words, stat) if batch else (words[0], stat[0])


def configs():
    """chip_smoke.py's A at 1 bpp (B1) and its A batch of 16 (B4):
    (label, batch, args)."""
    slices, _, _ = get_slices_and_h_w(512, 512, cs.CONFIG_A, None)
    ll = (slices[0][1].stop, slices[0][2].stop)
    arr, _, _ = forward(torch.as_tensor(cs.image(1, (3, 512, 512)),
                                        device=cs.DEV), cs.CONFIG_A, None)
    ims = np.stack([cs.image(100 + b, (3, 512, 512)) for b in range(16)])
    arrs, _, _ = forward(torch.as_tensor(ims, device=cs.DEV), cs.CONFIG_A,
                         None)
    mbs = [cs.BUDGETS_A[b % 4] for b in range(16)]
    return [("A", False, encoder.machine_args(arr, *ll, 512 * 512)),
            ("A batch of 16", True,
             encoder.batch_machine_args(arrs, *ll, mbs))]


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_clocks: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", type=Path)
    trees = ap.parse_args().csrc or [ROOT / "spiht_tpu_torch" / "csrc"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    keys = [(t, c) for t in trees for c in (False, True)]
    with ThreadPoolExecutor() as ex:
        libs = dict(zip(keys, ex.map(
            lambda k: build(*k, "spiht_encode", instrument), keys)))
    cfgs = configs()
    refs = {}
    for label, batch, args in cfgs:
        run = encoder.encode_machine_batch if batch else encoder.encode_machine
        refs[label] = run(*cs.to_cpu(args))
    for tree in trees:
        plain, clk = libs[(tree, False)], libs[(tree, True)]
        ptxas = [ln.strip() for ln in plain.ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(json.dumps({"csrc": str(tree), "ptxas": ptxas}))
        for label, batch, args in cfgs:
            same = True
            for lib in (plain, clk):
                got = launch(lib, batch, args)
                same &= all(torch.equal(g.cpu(), r)
                            for g, r in zip(got, refs[label]))
            clk.clk_reset()
            launch(clk, batch, args)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            clk.clk_read(buf)
            streams = args[0].shape[0] if batch else 1
            print(json.dumps({
                "csrc": str(tree), "config": label,
                "kernel": "spiht_encode_batch" if batch else "spiht_encode",
                "equals_the_plain_version": same,
                "ms": cs.time_kernel(launch, (plain, batch, args)),
                "instrumented_ms": cs.time_kernel(launch, (clk, batch, args)),
                "streams": streams,
                "cycles_per_stream": {n: buf[i] / streams
                                      for i, n in enumerate(COUNTERS)
                                      if buf[i]},
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
