"""Whether the tensor cores can take the LIP token scan from the scalar
units, on the card: the port of ``tools/spike_token_matmul.py`` (its Pallas
kernel, ``build``'s ``kernel`` :48, ``pallas_call`` :133).

K iterations, each a 128-bit window ``b = (x[i % 64] ^ seed) & 1``: its
token heads (the lanes reachable from lane 0 under ``succ(p) = p + 1 +
b[p]``, the LIP grammar's {0, 1s} token starts), ``s`` = their count,
``acc += s`` and ``seed = (seed + s) & 1``, so each window waits for the
last. ``token_heads`` launches the CUDA kernel (``csrc/spike_blocks.cu``)
of one kind for a CUDA tensor and runs its plain version, the sequential
parse ``p = 0; while p < 128: heads[p] = 1; p += 1 + b[p]``, for a CPU
one. The kinds mirror the spike's:

- ``scan`` (the spike's ``vpu``): B2's carry arithmetic over the window's
  two 64-bit halves, one thread;
- ``mma_tf32`` (``mxu``) and ``mma_bf16`` (``mxu_bf16``): seven squarings
  of the 0/1 matrix I + S by ``mma.sync`` in one block of four warps, row 0
  the heads (exact: 0/1 entries, counts of at most 128 in f32);
- ``both``: all three, the heads' differences times 1,000,000 added to
  ``acc``, as the spike's body (:117-124) does: 0 when they agree.

The output is the (1, 1) int32 ``acc``.

Run on the card: ``python -m spiht_tpu_torch.tools.spike_token_matmul
[K]`` (K = 20000 by default). It first runs ``both`` at K = 512 against
the plain version, as the spike's ``main`` (:157-160) does, then prints
one JSON line: ns an iteration of each kind at K (CUDA events, median of
5), each output equal to the plain version's, and the card's name and
power limit.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import card, event_ms

__all__ = ["ROWS", "LANES", "KINDS", "x_of", "token_heads", "token_plain",
           "run"]

ROWS, LANES = 64, 128
KINDS = ("scan", "mma_tf32", "mma_bf16", "both")  # the launch's kind ids
BOTH_K = 512  # the equality run's windows


def x_of() -> np.ndarray:
    """The spike's seeded (64, 128) int32 input."""
    rng = np.random.default_rng(3)
    return rng.integers(0, 2**30, (ROWS, LANES)).astype(np.int32)


def token_plain(x: np.ndarray, k: int) -> np.ndarray:
    """The plain version: K windows, each parsed token by token. Every
    kind gives this (``both`` adds 0 when its three heads agree). Returns
    the (1, 1) int32 acc."""
    rows = (x & 1).tolist()
    acc = seed = 0
    for i in range(k):
        b = rows[i % ROWS]
        p = s = 0
        while p < LANES:
            s += 1
            p += 1 + (b[p] ^ seed)
        acc += s
        seed = (seed + s) & 1
    return np.array([[(acc + 2**31) % 2**32 - 2**31]], np.int32)


def token_heads(x: torch.Tensor, k: int, kind: str = "scan") -> torch.Tensor:
    """K windows of ``x`` ((64, 128) int32) through ``kind``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU one. Returns the
    (1, 1) int32 acc."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}")
    if x.dtype != torch.int32 or tuple(x.shape) != (ROWS, LANES):
        raise ValueError(f"x must be a ({ROWS}, {LANES}) int32 tensor")
    if not 0 <= k < 2**31:
        raise ValueError("k must lie in [0, 2^31)")
    x = x.contiguous()
    if x.device.type == "cpu":
        return torch.from_numpy(token_plain(x.numpy(), int(k)))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from .. import _build

    lib = _build.load("spike_blocks")
    out = torch.empty(1, 1, dtype=torch.int32, device=x.device)
    rc = lib.spike_token_launch(
        x.data_ptr(), int(k), KINDS.index(kind), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spike_token launch failed: CUDA error {rc}")
    token_heads.launches += 1
    return out


token_heads.launches = 0


def run(k: int = 20_000, device=None, check=True):
    """``both`` at K = 512 against the plain version, then ns an iteration
    of each kind at K on the card; with ``check`` each kind's output is
    held to the plain version's. Returns the result dict."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the spike measures the card")
    xc = torch.as_tensor(x_of())
    x = xc.to(dev)
    k_both = min(BOTH_K, k)
    both = int(token_heads(x, k_both, "both")[0, 0])
    res = {"both_K": k_both, "both_acc": both,
           "both_equals_plain": both == int(token_plain(xc.numpy(),
                                                        k_both)[0, 0])}
    want = int(token_plain(xc.numpy(), k)[0, 0]) if check else None
    kinds = []
    for kind in KINDS:
        ms = event_ms(lambda: token_heads(x, k, kind), reps=5)
        ok = int(token_heads(x, k, kind)[0, 0]) == want if check else None
        kinds.append({"kind": kind, "ms": ms, "ns_per_iter": ms * 1e6 / k,
                      "equals_plain": ok})
    return {"spike": "spike_token_matmul", "K": k, **res, "results": kinds}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    nums = [a for a in argv if not a.startswith("--")]
    out = run(int(nums[0]) if nums else 20_000)
    out["card"] = card()
    print(json.dumps(out))
    ok = out["both_equals_plain"] and all(r["equals_plain"]
                                          for r in out["results"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
