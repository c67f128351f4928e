"""Where the decode machines' cycles go, on one CUDA card.

Run from the repository root on a machine with a card:

    python3 decode_clocks.py [--csrc DIR ...]

For each ``csrc`` directory given (default: ``spiht_tpu_torch/csrc``; give
another tree's, e.g. a commit unpacked with ``git archive``, for a
before/after pair in one run), it builds ``spiht_decode.cu`` twice with
nvcc into ``spiht_tpu_torch/build/clocks/``: as it is, and with clock64
counters inserted at run time (the instrumented copy is never kept). It
then decodes chip_smoke.py's configuration A through B2 and B at B3 and
prints one JSON line each: the kernel's time by CUDA events (as
chip_smoke.py times it), the instrumented build's time, and its counters (cycles of the whole
machine, of the LIP and LIS chunks, the chunks' gathers and refinement;
steps of each pass; for a warp-step LIS, the cycles of its table, its
chain over type-A entries, the chain's length, and the rest of the step).
It also prints the event counts of A's stream by action, from B2-log.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
import spiht_tpu_torch as pt
from spiht_tpu_torch import _build
from spiht_tpu_torch.codec import decoder, encoder, meta_expand
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "spiht_tpu_torch" / "build" / "clocks"
COUNTERS = ["total", "lip_chunks", "lip_steps", "lis_chunks", "lis_steps",
            "gathers", "n_gathers", "refine", "lis_table", "lis_chain",
            "chain_len", "lis_rest"]
PROLOGUE = """
__device__ unsigned long long g_clk[16];
__shared__ unsigned long long s_clk[16];
#define CLK(v) long long v = clock64()
#define CLK_ADD(i, v) do { if (tid == 0) s_clk[i] += clock64() - (v); } while (0)
#define LANE_ADD(i, v) do { if (lane == 0) s_clk[i] += clock64() - (v); } while (0)
#define LANE_INC(i, n) do { if (lane == 0) s_clk[i] += (n); } while (0)
"""
EPILOGUE = """
extern "C" int clk_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
}
extern "C" int clk_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
"""


def _sub(src, pattern, repl, count=1):
    out, n = re.subn(pattern, repl, src, flags=re.S)
    if n != count:
        raise RuntimeError(f"instrumentation anchor found {n} times: {pattern}")
    return out


def instrument(src: str) -> str:
    """The decode source with counters (anchors common to the zero-run
    design of PR 3 and the warp-step design; the LIS step's parts only
    where the source has them)."""
    src = _sub(src, r'(#include "spiht_common.cuh"\n)', r"\1" + PROLOGUE)
    src = _sub(src, r"(#endif  // __CUDACC__\s*)$", EPILOGUE + r"\1")
    # the whole machine
    src = _sub(src, r"(sh\.pub = Published\{st\.lip_n, st\.lis_n, 0, 0\};\n)",
               r"\1  if (tid < 16) s_clk[tid] = 0;\n  CLK(t_all);\n")
    src = _sub(src, r"(\n  if \(tid != 0\) return;\n  a\.stat\[0\])",
               r"\n  CLK_ADD(0, t_all);\n"
               r"  if (tid < 16) atomicAdd(&g_clk[tid], s_clk[tid]);\1")
    # each chunk: its gather (to the barrier), then warp 0's pass (to the
    # next barrier)
    for first, k in ((r"for \(int32_t i = tid; i < m; i \+= nt\) sh\.e\[i\] = "
                      r"a\.lip\[r0 \+ i\];", 1),
                     (r"for \(int32_t i = tid; i < m; i \+= nt\) \{\n\s*"
                      r"const int32_t e = a\.lis\[r0 \+ i\];", 3)):
        src = _sub(src, rf"({first}.*?SPIHT_SYNC\(\);\n)(.*?)(\n\s*SPIHT_SYNC\(\);)",
                   rf"CLK(tg);\n\1CLK_ADD(5, tg);\nif (tid == 0) s_clk[6] += 1;\n"
                   rf"CLK(tc);\n\2\nCLK_ADD({k}, tc);\3")
    src = _sub(src, r"(// ---- refinement of the entries significant before "
                    r"this plane ----\n)(.*?SPIHT_SYNC\(\);\n)",
               r"\1CLK(tr);\n\2CLK_ADD(7, tr);\n")
    # steps: each iteration of the chunk functions' loops
    for fn, k in (("dec_lip_chunk", 2), ("dec_lis_chunk", 4)):
        src = _sub(src, rf"(SPIHT_HD bool {fn}\(.*?for \(int32_t k = 0; k < m;[^)]*\) \{{\n)",
                   rf"\1LANE_INC({k}, 1);\n")
    if "// the chain" in src:  # the warp-step LIS: table, chain, rest
        src = _sub(src, r"(for \(int32_t k = 0; k < m; k \+= SPIHT_WARP\) \{\n"
                        r"\s*LANE_INC\(4, 1\);\n)", r"\1CLK(t_tab);\n")
        src = _sub(src, r"(WARP_SYNC\(lane\);\n)(\s*// the chain)",
                   r"\1LANE_ADD(8, t_tab);\nCLK(t_ch);\n\2")
        src = _sub(src, r"(\n\s*const int32_t used = n \+ d;)",
                   r"\nLANE_ADD(9, t_ch);\nLANE_INC(10, n_var);\nCLK(t_rest);\1")
        src = _sub(src, r"(\n\s*st\.cur \+= used;\n\s*st\.keep \+= tot >> 24;)",
                   r"\nLANE_ADD(11, t_rest);\1")
    return src


def build(csrc: Path, clocks: bool, name: str = "spiht_decode",
          instrument_fn=None) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with nvcc (with clock64 counters inserted by
    ``instrument_fn`` when ``clocks``) into its own directory under ``OUT``,
    loaded with the argtypes of ``name``."""
    key = f"{csrc.resolve()} {name}"
    tag = hashlib.sha256(key.encode()).hexdigest()[:12]
    d = OUT / f"{tag}_{'clk' if clocks else 'plain'}"
    d.mkdir(parents=True, exist_ok=True)
    src = (csrc / f"{name}.cu").read_text()
    instrument_fn = instrument_fn or instrument
    (d / f"{name}.cu").write_text(instrument_fn(src) if clocks else src)
    so = d / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                        "-o", str(so), str(d / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {d}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ptxas = r.stdout + r.stderr  # registers, shared memory, spills
    return lib


def launch(lib, seq, args):
    """One B2 or B3 launch of ``lib`` on ``decoder.machine_args``."""
    words, nbits, max_n, geo, lip0, lis0, w, (lip_cap, lis_cap, lsp_cap) = args
    dev = words.device
    lip = torch.empty(lip_cap, dtype=torch.int32, device=dev)
    lis = torch.empty(lis_cap, dtype=torch.int32, device=dev)
    lsp = torch.empty(max(lsp_cap, 1), dtype=torch.int32, device=dev)
    stat = torch.empty(6, dtype=torch.int32, device=dev)
    nb = encoder.device_scalar("nbits", nbits, dev)
    mn = encoder.device_scalar("max_n", max_n, dev)
    head = [words.data_ptr(), nb.data_ptr(), mn.data_ptr(), geo.data_ptr(),
            lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(), w,
            lip.data_ptr(), lip_cap, lis.data_ptr(), lis_cap, lsp.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    if seq:
        rec = torch.empty(geo.numel(), dtype=torch.int32, device=dev)
        last = torch.empty(geo.numel(), dtype=torch.int64, device=dev)
        rc = lib.spiht_decode_seq_launch(*head, lsp_cap, rec.data_ptr(),
                                         last.data_ptr(), geo.numel(),
                                         stat.data_ptr(), stream)
        out = (rec,)
    else:
        val = torch.empty_like(lsp)
        rc = lib.spiht_decode_lsp_launch(*head, val.data_ptr(), lsp_cap,
                                         stat.data_ptr(), stream)
        out = (lsp, val)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out + (stat,)


def configs():
    """chip_smoke.py's A (B2) and B (B3) at 1 bpp: (label, seq, args, er,
    geometry)."""
    out = []
    for label, settings, level, seed, seq in (
            ("A", cs.CONFIG_A, None, 1, False), ("B", cs.CONFIG_B, 3, 2, True)):
        er = pt.encode_image_device(cs.image(seed, (3, 512, 512)), settings,
                                    level, 512 * 512, device=cs.DEV)
        slices, h, w = get_slices_and_h_w(512, 512, settings, level)
        geo = (3, h, w, slices[0][1].stop, slices[0][2].stop)
        words, nbits = decoder.words_tensor(er.encoded_bytes, cs.DEV)
        out.append((label, seq, decoder.machine_args(words, nbits, er.max_n,
                                                     *geo), er, geo))
    return out


def event_counts(er, geo):
    """A's stream by action (the log's ids): [bits, of which 1]."""
    _, log, words, nbits = meta_expand.decode_event_log(
        er.encoded_bytes, er.max_n, *geo, cs.DEV)
    t = torch.arange(nbits, device=cs.DEV)
    bits = (words[t >> 5] >> (t & 31)) & 1
    act = (log[:nbits] >> 24) & 7
    return {a: [int((act == a).sum()), int(bits[act == a].sum())]
            for a in range(7)}


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_clocks: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", type=Path)
    trees = ap.parse_args().csrc or [ROOT / "spiht_tpu_torch" / "csrc"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    keys = sorted({(t.resolve(), c) for t in trees for c in (False, True)})
    with ThreadPoolExecutor() as ex:
        libs = dict(zip(keys, ex.map(lambda k: build(*k), keys)))
    cfgs = configs()
    print(json.dumps({"event_counts_A": event_counts(*cfgs[0][3:])}))
    for tree in trees:
        plain, clk = libs[(tree.resolve(), False)], libs[(tree.resolve(), True)]
        for label, seq, args, _, _ in cfgs:
            ref = (decoder.decode_seq if seq else decoder.decode_lsp)(*args)
            got = launch(plain, seq, args)
            live = int(ref[-1][0])
            same = all(torch.equal(x[:live] if not seq else x,
                                   y[:live] if not seq else y)
                       for x, y in zip(got[:-1], ref[:-1]))
            same &= torch.equal(got[-1], ref[-1])
            clk.clk_reset()
            launch(clk, seq, args)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            clk.clk_read(buf)
            print(json.dumps({
                "csrc": str(tree), "config": label,
                "kernel": "spiht_decode_seq" if seq else "spiht_decode_lsp",
                "equals_the_port": same,
                "ms": cs.time_kernel(launch, (plain, seq, args)),
                "instrumented_ms": cs.time_kernel(launch, (clk, seq, args)),
                "cycles": {n: buf[i] for i, n in enumerate(COUNTERS) if buf[i]},
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
