"""The hybrid encoder's block primitives on the card: the port of
``tools/spike_pallas_block.py`` (its Pallas kernel, ``build``'s ``kernel``
:42, ``pallas_call`` :181; its numpy model ``ref_model`` :205).

Each block iteration takes row ``it % rows`` of 128 int32 magnitudes and,
at plane ``n = it % 8``, decides each lane's significance (``(uint32)mag
>> n != 0``), emits each lane's 2-bit group ``sig | sign << 1`` at the
stream offset ``pos + prefix(1 + sig)`` (OR-ed into the words buffer,
wrapping at its size), and appends each lane's magnitude, in lane order,
to the LSP (significant) or the LIP (not), both wrapping too. These are a
prefix scan, an order-keeping compaction and a variable-length emission:
what B1 and B4 do to each chunk of queue entries. ``block`` launches the
CUDA kernel (``csrc/spike_blocks.cu``: one block of 128 threads, a ballot
and popc a warp plus the four warp totals, atomicOr) for a CUDA tensor and
runs its plain version, ``ref_model`` copied, for a CPU one. The outputs
are the TPU kernel's: (1, 4) int32 [pos, lsp_cnt, lip_w, acc] and the
(rows, 128) int32 lsp, lip and words, zeroed first.

Run on the card: ``python -m spiht_tpu_torch.tools.spike_pallas_block
[K]`` (K = 2000 by default). It prints one JSON line: the marginal ns a
block iteration and ns an entry from K/4 and K iterations at 512 rows
(256 KB an array; CUDA events, median of 3), the outputs equal to the
plain version's, and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import card, event_ms

__all__ = ["LANES", "ROWS", "MAX_ITER", "mag_of", "ref_model", "block",
           "equals_plain", "run"]

LANES = 128
ROWS = 512  # 256 KB an array
MAX_ITER = 1 << 22  # pos (at most 256 bits an iteration) stays below 2^31


def mag_of(rows: int = ROWS) -> np.ndarray:
    """The spike's seeded (rows, 128) int32 magnitudes: small values (so
    the significance varies with the plane), half of them with bit 31."""
    rng = np.random.default_rng(0)
    mag = rng.integers(0, 512, (rows, LANES), np.int64)
    mag = (mag | (rng.integers(0, 2, mag.shape) << 31)).astype(np.int64)
    return mag.astype(np.uint32).view(np.int32).astype(np.int32)


def ref_model(mag2d, niter, rows_state):
    """The plain version: the spike's numpy model (``ref_model``, copied),
    returning acc too. Returns (pos, lsp_cnt, lip_w, acc, lsp, lip, words)
    with the arrays flat (int64 / uint64)."""
    pos = lsp_cnt = lip_w = acc = 0
    lsp = np.zeros(rows_state * LANES, np.int64)
    lip = np.zeros(rows_state * LANES, np.int64)
    words = np.zeros(rows_state * LANES, np.uint64)
    size = rows_state * LANES
    for it in range(niter):
        mag = mag2d[it % rows_state].astype(np.int64)
        n = it % 8
        sig = ((mag & 0xFFFFFFFF) >> n) != 0
        sgn = (mag >> 31) & 1
        grp = sig.astype(np.int64) | (sgn << 1)
        kk = 1 + sig.astype(np.int64)
        off = pos + np.concatenate([[0], np.cumsum(kk)[:-1]])
        for j in range(LANES):
            w = int(off[j]) >> 5
            s = int(off[j]) & 31
            words[w % size] |= np.uint64((int(grp[j]) << s) & 0xFFFFFFFF)
            if s and (int(grp[j]) >> (32 - s)):
                words[(w + 1) % size] |= np.uint64(
                    int(grp[j]) >> (32 - s)
                )
        for j in range(LANES):
            if sig[j]:
                lsp[lsp_cnt % size] = mag[j] & 0xFFFFFFFF
                lsp_cnt += 1
            else:
                lip[lip_w % size] = mag[j] & 0xFFFFFFFF
                lip_w += 1
        pos += int(kk.sum())
        acc ^= int(grp.sum()) & 0xFFFFFFFF
    return pos, lsp_cnt, lip_w, acc, lsp, lip, words


def _i32(a: np.ndarray, rows: int) -> torch.Tensor:
    return torch.from_numpy(
        a.astype(np.uint32).view(np.int32).reshape(rows, LANES))


def block(mag: torch.Tensor, niter: int):
    """``niter`` block iterations over ``mag`` ((rows, 128) int32): the
    CUDA kernel for a CUDA tensor, the plain version for a CPU one.
    Returns ((1, 4) int32 [pos, lsp_cnt, lip_w, acc], lsp, lip, words),
    the last three (rows, 128) int32."""
    if mag.dtype != torch.int32 or mag.dim() != 2 or mag.shape[1] != LANES:
        raise ValueError(f"mag must be a (rows, {LANES}) int32 tensor")
    rows = mag.shape[0]
    if rows < 1:
        raise ValueError("mag needs at least one row")
    if not 0 <= niter <= MAX_ITER:
        raise ValueError(f"niter must lie in [0, {MAX_ITER}]")
    mag = mag.contiguous()
    if mag.device.type == "cpu":
        pos, lsp_cnt, lip_w, acc, lsp, lip, words = ref_model(
            mag.numpy(), int(niter), rows)
        out = torch.tensor([[pos, lsp_cnt, lip_w, acc]],
                           dtype=torch.int64).to(torch.int32)
        return out, _i32(lsp, rows), _i32(lip, rows), _i32(words, rows)
    if mag.device.type != "cuda":
        raise ValueError(f"unsupported device {mag.device}")
    from .. import _build

    lib = _build.load("spike_blocks")
    out = torch.empty(1, 4, dtype=torch.int32, device=mag.device)
    lsp, lip, words = (torch.empty_like(mag) for _ in range(3))
    rc = lib.spike_block_launch(
        mag.data_ptr(), rows, int(niter), out.data_ptr(), lsp.data_ptr(),
        lip.data_ptr(), words.data_ptr(),
        torch.cuda.current_stream(mag.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spike_block launch failed: CUDA error {rc}")
    block.launches += 1
    return out, lsp, lip, words


block.launches = 0


def equals_plain(mag: torch.Tensor, niter: int) -> bool:
    """Whether every output of the kernel equals the plain version's."""
    got = block(mag, niter)
    want = block(mag.cpu(), niter)
    return all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def run(k: int = 2000, device=None, check=True):
    """The marginal ns a block iteration from K/4 and K iterations on the
    card (the arrays L2-resident: 768 KB in all at 512 rows); with
    ``check`` every output is held to the plain version's. Returns the
    result dict."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the spike measures the card")
    ks = [k // 4, k]
    mag = torch.as_tensor(mag_of(ROWS), device=dev)
    ms = [event_ms(lambda: block(mag, kk)) for kk in ks]
    ok = all(equals_plain(mag, kk) for kk in ks) if check else None
    slope = (ms[1] - ms[0]) * 1e6 / (ks[1] - ks[0])
    return {
        "spike": "spike_pallas_block", "K": ks, "rows": ROWS,
        "array_kb": ROWS * LANES * 4 // 1024,
        "cache": "L2 (written by the kernel's own zeroing)",
        "ms": dict(zip(map(str, ks), ms)),
        "ns_per_block_iter": slope, "ns_per_entry": slope / LANES,
        "equals_plain": ok,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    nums = [a for a in argv if not a.startswith("--")]
    out = run(int(nums[0]) if nums else 2000)
    out["card"] = card()
    print(json.dumps(out))
    return 0 if out["equals_plain"] else 1


if __name__ == "__main__":
    sys.exit(main())
