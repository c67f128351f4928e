"""Microbenchmarks of the port on the card: the Hopper counterparts of the
JAX package's six TPU spikes in ``tools/`` (``spike_hbm_table``,
``spike_pallas_seq``, ``spike_pallas_ilp``, ``spike_pallas_machine``,
``spike_pallas_block``, ``spike_token_matmul``), each a ``python -m
spiht_tpu_torch.tools.<name>`` that prints one JSON line with the card's
name and power limit."""

from __future__ import annotations

import statistics
import subprocess

import torch

__all__ = ["card", "cache_setup", "event_ms"]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# the H100's L2 cache, and the largest array taken as L2-resident
L2_BYTES = 50 * 2**20
L2_RESIDENT = 32 * 2**20


def cache_setup(array: torch.Tensor, prime: bool = False):
    """(where a timed launch finds ``array``, a callable that puts it there
    before the launch, or None). Past L2_RESIDENT bytes, a buffer of twice
    L2's size is written first, so every access goes to HBM. Below, the
    warm-up launch has walked the same chain, so the timed walk finds its
    lines in L2, cached near the walking SM; with ``prime``, the array is
    read whole by a kernel on every SM first instead (lines cached where
    those SMs put them)."""
    if array.numel() * array.element_size() > L2_RESIDENT:
        flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32,
                            device=array.device)
        return "HBM (L2 flushed)", flush.zero_
    if prime:
        return "L2 (primed by a whole read)", lambda: array.sum()
    return "L2 (warm-up walk)", None


def event_ms(fn, reps: int = 3, before=None) -> float:
    """Median ms of ``fn()`` on the card by CUDA events, after a warm-up;
    ``before()`` runs ahead of each timed launch, outside the events."""
    fn()
    ts = []
    for _ in range(reps):
        if before is not None:
            before()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)
