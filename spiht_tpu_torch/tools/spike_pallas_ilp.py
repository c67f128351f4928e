"""Whether B chains of the decoder's per-bit body hide each other's latency
on the card: the port of ``tools/spike_pallas_ilp.py`` (its Pallas kernel,
``build``'s ``kernel`` :40, ``pallas_call`` :102).

The body is ``spike_pallas_machine``'s (S4), in B chains, each with its
own four state arrays of ``mb`` MB (2 MB by default: 8 MB a chain, 64 MB
at B = 8, past the 50 MB L2) and its own start (37b, 101b, 0); chain 0 is
S4's. ``chains`` launches the CUDA kernel (``csrc/spike_chains.cu``) in
one of two layouts for a CUDA tensor and runs the plain version (S4's
Python loop, chain by chain) for a CPU one:

- ``ilp``: one thread steps the B chains, the B chains' loads of a step
  issued together (``spike_machine_ilp_kernel<B>``), the TPU spike's
  design;
- ``warp``: B lanes of one warp, one chain a lane
  (``spike_machine_warp_kernel``), the GPU's own way to run B chains.

The output row is (1, 3B + 1) int32: chain b's (pos, acc, cnt) at 3b..3b+2
and INT32_MIN last, the entry the TPU kernel never writes.

Run on the card: ``python -m spiht_tpu_torch.tools.spike_pallas_ilp [K]
[--mb N]`` (K = 100000 by default). It prints one JSON line: for B in
{1, 2, 4, 8} and each layout, the marginal ns a step from K/4 and K steps
(CUDA events, median of 3), ns a chain-step, the ILP factor
B * slope(1) / slope(B) (as the spike's ``main`` :122 prints it), where
the state lies (L2, or HBM with L2 flushed past 32 MB), each output and
the state after it equal to the plain version's, and the card's name and
power limit.
"""

from __future__ import annotations

import json
import sys

import torch

from ..device import resolve_device
from . import card, event_ms
from .spike_pallas_machine import (
    CHAINS, equals_plain, k_mb, launch, new_state, state_size, timed_state,
    words_of,
)

__all__ = ["LAYOUTS", "chains", "equals_plain", "run"]

LAYOUTS = ("ilp", "warp")


def chains(words: torch.Tensor, k: int, state: torch.Tensor,
           layout: str = "ilp") -> torch.Tensor:
    """K steps of B chains over ``words`` (int32) and ``state`` ((B, 4,
    size) int32, B in {1, 2, 4, 8}, INT32_MIN-filled by ``new_state``;
    updated in place) in ``layout`` ("ilp" or "warp"): the CUDA kernel for
    CUDA tensors, the plain version for CPU ones. Returns the (1, 3B + 1)
    int32 row."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")
    return launch(chains, words, k, state, layout == "warp")


chains.launches = 0


def run(k: int = 100_000, mb: float = 2.0, device=None, check=True):
    """For each B in {1, 2, 4, 8} and layout: the marginal ns a step from
    K/4 and K steps on the card, the state refilled (and, past 32 MB, L2
    flushed) before each timed launch; with ``check`` each output and the
    state after it are held to the plain version's. Returns the result
    dict."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the spike measures the card")
    ks = [k // 4, k]
    words = torch.as_tensor(words_of(), device=dev)
    size = state_size(mb)
    res, slope1 = [], {}
    for b in CHAINS:
        state = new_state(b, size, dev)
        cache, before = timed_state(state)
        for layout in LAYOUTS:
            ms = [event_ms(lambda: chains(words, kk, state, layout),
                           before=before) for kk in ks]
            ok = all(equals_plain(chains, words, kk, state, layout)
                     for kk in ks) if check else None
            slope = (ms[1] - ms[0]) * 1e6 / (ks[1] - ks[0])
            slope1.setdefault(layout, slope)
            res.append({
                "chains": b, "layout": layout,
                "state_mb": 4 * state.numel() / 2**20, "cache": cache,
                "ms": dict(zip(map(str, ks), ms)),
                "ns_per_step": slope, "ns_per_chain_step": slope / b,
                "ilp_factor": b * slope1[layout] / slope,
                "equals_plain": ok,
            })
        del state
    return {"spike": "spike_pallas_ilp", "K": ks, "state_words": size,
            "l2_mb": 50, "results": res}


def main(argv=None) -> int:
    out = run(*k_mb(sys.argv[1:] if argv is None else argv, 2.0))
    out["card"] = card()
    print(json.dumps(out))
    return 0 if all(r["equals_plain"] for r in out["results"]) else 1


if __name__ == "__main__":
    sys.exit(main())
