"""Per-step latency of a dependent scalar chain on the card: the port of
``tools/spike_pallas_seq.py`` (its Pallas kernel, ``make_onehot_kernel``'s
``kernel`` :66, ``pallas_call`` :105; the step ``_chain_step`` :35-41).

Each step reads the word at a data-dependent cursor, does scalar ALU work
and, in the ``rw`` variant, writes the cursor to a scratch array at a
data-dependent index: the step cost of one thread, which is the cost of
B7 and of the bit machines' bit-by-bit tails. ``seq_chain`` launches the
CUDA kernel (``csrc/spike_chains.cu``: one thread, direct indexing, no
one-hot extraction) for a CUDA tensor and runs its plain version, a numpy
loop, for a CPU one. The array lies in global memory at the spike's sizes,
1024 x 128 int32 (512 KB) or, with ``--big``, 32768 x 128 (16 MB), or in
shared memory at 2^15 words (512 KB do not fit there).

Run on the card: ``python -m spiht_tpu_torch.tools.spike_pallas_seq [K]
[--big] [--prime]`` (K = 100000 by default). It prints one JSON line: the
marginal ns per step of each variant from K/4 and K steps (CUDA events,
median of 3, each output equal to the plain version's), with the card's
name and power limit. Both global arrays are L2-resident (the 50 MB L2 holds
them): their lines are left by the warm-up launch or, with ``--prime``, by
a whole read of the array on every SM (``tools.cache_setup``).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import cache_setup, card, event_ms

__all__ = ["ROWS", "LANES", "SMEM_WORDS", "words_of", "seq_chain", "run"]

ROWS, LANES = 1024, 128  # 512 KB (--big: 32 x, 16 MB)
SMEM_WORDS = 1 << 15  # the shared-memory variant's array


def words_of(rows: int) -> np.ndarray:
    """The spike's seeded (rows, 128) int32 array."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2**31 - 1, (rows, LANES), dtype=np.int32)


def _i32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _seq_chain_plain(flat: np.ndarray, k: int, rw: bool):
    """The plain version: K steps of ``_chain_step`` as a numpy loop.
    Returns ((1, 2) int32 [pos, acc], the int32 scratch or None)."""
    size = flat.size
    scratch = np.zeros(size, np.int32) if rw else None
    pos = acc = 0
    for _ in range(k):
        word = int(flat[pos])
        step = (word >> (pos & 7)) & 7
        acc ^= _i32(word + pos)
        pos = (pos + 1 + step) & (size - 1)
        if rw:
            scratch[acc & (size - 1)] = pos
    return np.array([[pos, acc]], np.int32), scratch


def seq_chain(words: torch.Tensor, k: int, rw: bool = False,
              shared: bool = False):
    """K steps of the chain over ``words`` (int32, a power-of-two count;
    2^15 with ``shared``): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one. Returns ((1, 2) int32 [pos, acc], the scratch
    (int32, one entry a word, zeroed before) with ``rw``, else None)."""
    if words.dtype != torch.int32:
        raise ValueError(f"words must be int32, got {words.dtype}")
    flat = words.contiguous().reshape(-1)
    size = flat.numel()
    if size < 1 or size & (size - 1):
        raise ValueError("the chain masks with size - 1: size must be 2^m")
    if shared and size != SMEM_WORDS:
        raise ValueError(f"the shared-memory variant takes {SMEM_WORDS} words")
    dev = flat.device
    if dev.type == "cpu":
        out, scratch = _seq_chain_plain(flat.numpy(), k, rw)
        return (torch.from_numpy(out),
                None if scratch is None else torch.from_numpy(scratch))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build

    lib = _build.load("spike_chains")
    out = torch.empty(1, 2, dtype=torch.int32, device=dev)
    scratch = torch.zeros(size, dtype=torch.int32, device=dev) if rw else None
    rc = lib.spike_seq_launch(
        flat.data_ptr(), size, int(k), int(rw), int(shared),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spike_seq launch failed: CUDA error {rc}")
    seq_chain.launches += 1
    return out, scratch


seq_chain.launches = 0


def _equal_plain(words, k, rw, shared):
    out, scratch = seq_chain(words, k, rw, shared)
    pout, pscratch = seq_chain(words.cpu(), k, rw, shared)
    return torch.equal(out.cpu(), pout) and (
        not rw or torch.equal(scratch.cpu(), pscratch))


def run(k: int = 100_000, big: bool = False, device=None, check=True,
        prime: bool = False):
    """Each variant's marginal ns per step from K/4 and K steps on the
    card, the cache set up by ``tools.cache_setup`` (with ``prime``); with
    ``check`` every output (and rw scratch) is held to the plain version's.
    Returns the result dict."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the spike measures the card")
    ks = [k // 4, k]
    rows = ROWS * 32 if big else ROWS
    arrays = {
        "global": torch.as_tensor(words_of(rows), device=dev),
        "shared": torch.as_tensor(words_of(SMEM_WORDS // LANES), device=dev),
    }
    res = []
    for where, words in arrays.items():
        for rw in (False, True):
            shared = where == "shared"
            cache, before = cache_setup(words, prime)
            if shared:
                cache = "shared memory"
            ms = [event_ms(lambda: seq_chain(words, kk, rw, shared),
                           before=before) for kk in ks]
            ok = all(_equal_plain(words, kk, rw, shared) for kk in ks) \
                if check else None
            res.append({
                "variant": f"{where} {'rw' if rw else 'r'}",
                "words": words.numel(), "kb": words.numel() * 4 // 1024,
                "cache": cache,
                "ms": dict(zip(map(str, ks), ms)),
                "ns_per_step": (ms[1] - ms[0]) * 1e6 / (ks[1] - ks[0]),
                "equals_plain": ok,
            })
    return {"spike": "spike_pallas_seq", "K": ks, "results": res}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    nums = [a for a in argv if not a.startswith("--")]
    out = run(int(nums[0]) if nums else 100_000, "--big" in argv,
              prime="--prime" in argv)
    out["card"] = card()
    print(json.dumps(out))
    return 0 if all(r["equals_plain"] for r in out["results"]) else 1


if __name__ == "__main__":
    sys.exit(main())
