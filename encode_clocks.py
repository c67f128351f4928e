"""Where the encode machines' cycles go (kernels B1, B4 and B7), and the
fused quantize pass's time (B6), on one CUDA card.

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

Then B7, the sequential machine, at A's 1 bpp and full stream: its time
(and ns a stream bit) and, where the source has the loaders' ring, the
counters: the decider's (thread 0) cycles in each kind of pass, its
cycles waiting on the ring in each, its entries in each and its waits,
and loader warp 1's cycles waiting for free slots, waiting on the LIS's
tail and loading, and its groups. A tree without the ring (the one-thread
B7 before it) gets the times alone.

Last, B6 alone (its launch on outputs allocated once) on chip_smoke.py's
phase-13 input, the A batch's 13.9 M scaled float32 coefficients: 21
launches after a 128 MB write that flushes the L2 and 21 back to back,
median, min and max (chip_smoke.quantize_cold_warm), for each tree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from decode_clocks import EPILOGUE, _sub, build
from spiht_tpu_torch.codec import api as tapi
from spiht_tpu_torch.codec import encoder
from spiht_tpu_torch.torch_transform import _scaled_coeffs, forward
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

ROOT = Path(__file__).resolve().parent
COUNTERS = ["total", "lip", "lis", "refine", "lip_gather", "lip_decide",
            "lis_gather", "lis_decide", "ref_gather", "ref_decide",
            "lip_chunks", "lis_chunks", "ref_chunks", "lis_short_chunks",
            "scan", "chunk_end"]
SEQ_COUNTERS = ["total", "lip", "lis", "refine", "lip_wait", "lis_wait",
                "refine_wait", "lip_entries", "lis_entries",
                "refine_entries", "waits", "passes", "loader_wait_free",
                "loader_wait_tail", "loader_load", "loader_groups"]
PROLOGUE = """
__device__ unsigned long long g_clk[16];
__shared__ unsigned long long s_clk[16];
#define CLK(v) long long v = clock64()
#define CLK_ADD(i, v) do { if (threadIdx.x == 0) s_clk[i] += clock64() - (v); } while (0)
#define CLK_INC(i) do { if (threadIdx.x == 0) s_clk[i] += 1; } while (0)
// loader warp 1's lane 0
#define CLKW_ADD(i, v) do { if (threadIdx.x == 32) s_clk[i] += clock64() - (v); } while (0)
#define CLKW_INC(i) do { if (threadIdx.x == 32) s_clk[i] += 1; } while (0)
"""
# around the machine's call: zero the block's counters, time the whole
# machine, then add them to the global ones
AROUND = (r"\n\1if (threadIdx.x < 16) s_clk[threadIdx.x] = 0;\n"
          r"\1__syncthreads();\n\1CLK(t_all);\n\1\2\n\1CLK_ADD(0, t_all);\n"
          r"\1__syncthreads();\n"
          r"\1if (threadIdx.x < 16) atomicAdd(&g_clk[threadIdx.x], "
          r"s_clk[threadIdx.x]);")


def _sub_text(src: str, old: str, new: str) -> str:
    """``src`` with the one occurrence of ``old`` replaced by ``new``."""
    return _sub(src, re.escape(old), new.replace("\\", "\\\\"))


def instrument_seq(src: str) -> str:
    """B7's counters (``SEQ_COUNTERS``), by anchors in its kernel, its feed
    and its loaders."""
    src = _sub_text(src, "  SeqPass p = seq_first(a);\n",
                    "  if (threadIdx.x < 16) s_clk[threadIdx.x] = 0;\n"
                    "  __syncthreads();\n  CLK(t_all);\n"
                    "  SeqPass p = seq_first(a);\n")
    src = _sub_text(src, "    p = q.pass[(p.id + 1) & 1];\n  }\n",
                    "    p = q.pass[(p.id + 1) & 1];\n  }\n"
                    "  CLK_ADD(0, t_all);\n  __syncthreads();\n"
                    "  if (threadIdx.x < 16) atomicAdd(&g_clk[threadIdx.x], "
                    "s_clk[threadIdx.x]);\n")
    src = _sub_text(src, "const SeqPass nx = seq_pass(a, f, s, p);",
                    "CLK(tp);\nconst SeqPass nx = seq_pass(a, f, s, p);\n"
                    "CLK_ADD(1 + p.kind, tp);\nCLK_INC(11);")
    wait = ("while ((int32_t)((f = ld_acquire(fr)) - at) <= 0) "
            "seq_watchdog(t0);")
    src = _sub_text(src, wait, "CLK(tw);\n" + wait +
                    "\nCLK_ADD(4 + p.kind, tw);\nCLK_INC(10);")
    src = _sub_text(src, "    st_release(&q.consumed, p.seq0 + (uint32_t)r);",
                    "    if (threadIdx.x == 0) s_clk[7 + p.kind] += r;\n"
                    "    st_release(&q.consumed, p.seq0 + (uint32_t)r);")
    src = _sub_text(src, "    if (!seq_wait_free(q, p, g0 + 32u - SEQ_RING)) "
                         "return;",
                    "    CLK(tf);\n    const bool free_ = seq_wait_free(q, p, "
                    "g0 + 32u - SEQ_RING);\n    CLKW_ADD(12, tf);\n"
                    "    if (!free_) return;")
    src = _sub_text(src, "      const uint32_t lim = lis ? seq_wait_tail(q, p, "
                         "filled) : end;",
                    "      CLK(tt);\n      const uint32_t lim = lis ? "
                    "seq_wait_tail(q, p, filled) : end;\n"
                    "      CLKW_ADD(13, tt);\n      CLK(tl);")
    src = _sub_text(src, "      filled = hi;\n",
                    "      filled = hi;\n      CLKW_ADD(14, tl);\n"
                    "      CLKW_INC(15);\n")
    return src


def instrument(src: str) -> str:
    """The encode source with counters. The passes are found by anchors
    common to the warp-0 design and the block-wide one; each
    chunk's parts by the anchors of the design the source has; B7's by
    ``instrument_seq`` where the source has its ring."""
    src = _sub(src, r'(#include "spiht_common.cuh"\n)', r"\1" + PROLOGUE)
    src = _sub(src, r"(#endif  // __CUDACC__\s*)$", EPILOGUE + r"\1")
    if "struct SeqRing" in src:
        src = instrument_seq(src)
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


def launch(lib, batch, args, seq=False):
    """One B1 (B7 with ``seq``; or, with ``batch``, B4) launch of ``lib``
    on ``encoder.machine_args`` (``batch_machine_args``). Returns (words,
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
        if seq:  # B7 takes the budget and its flag by value
            budget = (int(mb), int(capped))
        else:  # B1 reads them from device memory: alive until the launch
            held = (encoder.device_scalar("max_bits", mb, dev),
                    encoder.device_scalar("capped", capped, dev))
            budget = tuple(t.data_ptr() for t in held)
        run = lib.spiht_encode_seq_launch if seq else lib.spiht_encode_launch
        rc = run(
            t1.data_ptr(), t3s.data_ptr(), child0.data_ptr(),
            lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(), w,
            max_n.data_ptr(), *budget, *tail)
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
    seq_runs(trees, cfgs[0][2])
    quantize_runs(trees)
    return 0


def quantize_runs(trees):
    """B6 alone, cold and warm, for each tree; each build's outputs held
    to the wrapper's."""
    ims = [cs.image(100 + b, (3, 512, 512)) for b in range(16)]
    x = _scaled_coeffs(tapi._device_batch(ims, cs.DEV), cs.CONFIG_A, None,
                       torch.float32)[0].to(torch.float32)
    for tree in trees:
        lib = build(tree, False, "spiht_quantize")
        print(json.dumps({
            "csrc": str(tree), "kernel": "spiht_quantize_compact",
            "elements": x.numel(),
            "bound_ms": x.numel() * 11 / cs.HBM_BYTES_PER_S * 1e3,
            **cs.quantize_cold_warm(x, cs.CONFIG_A.quantization_scale, lib),
        }), flush=True)


def seq_runs(trees, args_a):
    """B7 at A's 1 bpp and full stream, for each tree: the time and, where
    the source has the ring, the instrumented build's time and counters."""
    slices, _, _ = get_slices_and_h_w(512, 512, cs.CONFIG_A, None)
    arr, _, _ = forward(torch.as_tensor(cs.image(1, (3, 512, 512)),
                                        device=cs.DEV), cs.CONFIG_A, None)
    full = encoder.machine_args(arr, slices[0][1].stop, slices[0][2].stop,
                                2**31 - 2)
    cfgs = [("A 1 bpp", args_a), ("A full", full)]
    refs = {label: encoder.encode_machine_seq(*cs.to_cpu(a))
            for label, a in cfgs}
    for tree in trees:
        ring = "struct SeqRing" in (tree / "spiht_encode.cu").read_text()
        keys = [False, True] if ring else [False]  # instrumented
        with ThreadPoolExecutor() as ex:
            libs = dict(zip(keys, ex.map(lambda k: build(
                tree, k, "spiht_encode", instrument), keys)))
        for label, a in cfgs:
            bits = int(refs[label][1][0])
            row = {"csrc": str(tree), "config": label,
                   "kernel": "spiht_encode_seq", "bits": bits, "ms": {}}
            for clocks, lib in libs.items():
                got = launch(lib, False, a, seq=True)
                check = all(torch.equal(g.cpu(), r)
                            for g, r in zip(got, refs[label]))
                name = "instrumented" if clocks else "source"
                if not check:
                    raise AssertionError(f"B7 {label} {name} != plain")
                row["ms"][name] = cs.time_kernel(
                    launch, (lib, False, a, True))
            row["ns_per_stream_bit"] = {k: v * 1e6 / bits
                                        for k, v in row["ms"].items()}
            if ring:
                clk = libs[True]
                clk.clk_reset()
                launch(clk, False, a, seq=True)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 16)()
                clk.clk_read(buf)
                row["counters"] = {n: buf[i] for i, n in
                                   enumerate(SEQ_COUNTERS) if buf[i]}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
