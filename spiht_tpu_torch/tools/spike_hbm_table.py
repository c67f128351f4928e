"""Latency of a dependent chain of random table reads on the card: the
port of ``tools/spike_hbm_table.py`` (its Pallas kernels ``_vmem_kernel``
:53, ``_hbm_kernel`` :63, ``_hbm_ilv_kernel`` :84 and ``_hbm_fire_kernel``
:128, all built by ``build``, ``pallas_call`` :210).

``x <- T[x]`` over a seeded random permutation T (the spike's, :227-228),
K steps: in one chain; in B chains with the B loads of a step in flight
together; or as the fire body, four loads {x, x+1, x+W, x+W+1} (W = 4243,
clamped) a chain a step. This is the latency behind B4's LIS gather (an L2
or HBM access the chunk cannot hide). ``table_chain`` and ``table_fire``
launch the CUDA kernels (``csrc/spike_chains.cu``, one thread) for a CUDA
tensor and run their plain versions, numpy loops, for a CPU one. The table
lies in shared memory at 2^15 words (the VMEM counterpart) or in global
memory at the spike's sizes: 2^17, 2^22 (both L2-resident; L2 is 50 MB)
and 2^25, 2^26 (HBM-resident), and at 2^15 beside the shared one.

Run on the card: ``python -m spiht_tpu_torch.tools.spike_hbm_table``. It
prints one JSON line: ns per dependent access of each variant and size at
the spike's K (CUDA events, median of 5, each output equal to the plain
version's), with the card's name and power limit. A table past 32 MB is
flushed out of L2 before each timed launch, so every access goes to HBM;
a smaller one is L2-resident, its lines left by the warm-up launch's walk
or, with ``--prime``, by a whole read of the table on every SM
(``tools.cache_setup``).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import cache_setup, card, event_ms

__all__ = ["LANES", "W_OFF", "SMEM_WORDS", "permutation", "table_chain",
           "table_fire", "run"]

LANES = 128  # the (1, 128) int32 output row of the TPU kernels
W_OFF = 4243  # the fire body's row offset (BASELINE.md round 5's width)
SMEM_WORDS = 1 << 15  # the shared-memory table


def permutation(n_log2: int) -> np.ndarray:
    """The spike's seeded random permutation of 2^n_log2 int32 words."""
    rng = np.random.default_rng(7)
    return rng.permutation(1 << n_log2).astype(np.int32)


def _table_plain(t: np.ndarray, k: int, chains: int, fire: bool,
                 w_off: int) -> np.ndarray:
    """The plain version: K steps of the chains as a numpy loop. Returns
    the (1, 128) int32 row: lane b chain b's head; the other lanes the
    head (one chain), 0 (B chains) or the fire body's int32 checksum."""
    n = t.size
    xs = np.arange(chains, dtype=np.int64)
    acc = 0
    for _ in range(k):
        if fire:
            for off in (1, w_off, w_off + 1):
                acc += int(t[np.minimum(xs + off, n - 1)].astype(np.int64)
                           .sum())
        xs = t[xs].astype(np.int64)
    rest = (acc + 2**31) % 2**32 - 2**31 if fire else (
        xs[0] if chains == 1 else 0)
    out = np.full((1, LANES), rest, np.int64)
    out[0, :chains] = xs
    return out.astype(np.int32)


def _launch(name, fn, table, *args):
    dev = table.device
    from .. import _build

    lib = _build.load("spike_chains")
    out = torch.empty(1, LANES, dtype=torch.int32, device=dev)
    rc = getattr(lib, f"{name}_launch")(
        table.data_ptr(), table.numel(), *args, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    fn.launches += 1
    return out


def _check_table(table: torch.Tensor):
    if table.dtype != torch.int32 or table.dim() != 1:
        raise ValueError("the table is a 1-d int32 tensor (a permutation)")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    return table.contiguous()


def table_chain(table: torch.Tensor, k: int, chains: int = 1,
                shared: bool = False) -> torch.Tensor:
    """K steps of ``chains`` (1, 8 or 16) chains x_b <- T[x_b] from x_b = b
    over ``table`` (a permutation; in shared memory with ``shared``, one
    chain over 2^15 words): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one. Returns the (1, 128) int32 row."""
    table = _check_table(table)
    if chains not in (1, 8, 16):
        raise ValueError("chains must be 1, 8 or 16")
    if shared and (chains != 1 or table.numel() != SMEM_WORDS):
        raise ValueError(f"the shared-memory table is one chain over "
                         f"{SMEM_WORDS} words")
    if table.device.type == "cpu":
        return torch.from_numpy(_table_plain(table.numpy(), k, chains, False,
                                             W_OFF))
    return _launch("spike_table", table_chain, table, int(k), chains,
                   int(shared))


table_chain.launches = 0


def table_fire(table: torch.Tensor, k: int, chains: int,
               w_off: int = W_OFF) -> torch.Tensor:
    """The fire body: K steps of ``chains`` (4, 8 or 16) chains, each step
    four loads {x, x+1, x+W, x+W+1} a chain (clamped to the table), x
    going on through T[x]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one. Returns the (1, 128) int32 row (lanes past the
    chains hold the checksum of the other three loads)."""
    table = _check_table(table)
    if chains not in (4, 8, 16):
        raise ValueError("chains must be 4, 8 or 16")
    if table.device.type == "cpu":
        return torch.from_numpy(_table_plain(table.numpy(), k, chains, True,
                                             w_off))
    return _launch("spike_fire", table_fire, table, int(k), chains,
                   int(w_off))


table_fire.launches = 0

# the spike's measurements (main :265-288): (kind, log2 words, chains, K);
# "shared" takes the place of its VMEM table, at 2^15 words
PLAN = (
    [("shared", 15, 1, 50_000)]
    + [("global", n, 1, 50_000) for n in (15, 17, 22, 25, 26)]
    + [("global", 25, 8, 50_000), ("global", 25, 16, 50_000),
       ("global", 26, 16, 50_000)]
    + [("fire", 25, b, 20_000) for b in (4, 8, 16)]
)


def _call(kind, table, k, chains):
    if kind == "fire":
        return table_fire(table, k, chains)
    return table_chain(table, k, chains, kind == "shared")


def run(plan=PLAN, device=None, check=True, reps=5, prime=False):
    """ns per dependent access of each (kind, log2 words, chains, K) of
    ``plan`` on the card, the cache set up by ``tools.cache_setup`` (with
    ``prime``); with ``check`` every output is held to the plain version's.
    Returns the result dict."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the spike measures the card")
    tables, res = {}, []
    for kind, n_log2, chains, k in plan:
        if n_log2 not in tables:
            tables[n_log2] = torch.as_tensor(permutation(n_log2), device=dev)
        table = tables[n_log2]
        cache, before = cache_setup(table, prime)
        if kind == "shared":
            cache = "shared memory"
        ms = event_ms(lambda: _call(kind, table, k, chains), reps, before)
        ok = None
        if check:
            ok = torch.equal(_call(kind, table, k, chains).cpu(),
                             _call(kind, table.cpu(), k, chains))
        accesses = k * chains * (4 if kind == "fire" else 1)
        res.append({
            "kind": kind, "n_log2": n_log2,
            "mb": (1 << n_log2) * 4 / 2**20, "chains": chains, "K": k,
            "cache": cache,
            "ms": ms, "ns_per_access": ms * 1e6 / accesses,
            "equals_plain": ok,
        })
    return {"spike": "spike_hbm_table", "results": res}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = run(prime="--prime" in argv)
    out["card"] = card()
    print(json.dumps(out))
    return 0 if all(r["equals_plain"] for r in out["results"]) else 1


if __name__ == "__main__":
    sys.exit(main())
