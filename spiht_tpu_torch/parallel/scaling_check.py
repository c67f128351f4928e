"""Noise-hardened scaling-floor canary.

Copy of ``spiht_tpu/parallel/scaling_check.py``, kept identical
(tests/test_torch_copies.py). A check that sharded work at fixed total
size costs no more than ``floor`` x the single-device run is a canary for
collective / repartition overhead regressions; on a noisy host a single
pair of medians can go red on a hiccup. So each attempt draws NEW medians
for both sides; the check passes as soon as one attempt is under the
floor and fails only if every attempt is over it. A real regression fails
all attempts; a noise spike has to recur ``attempts`` times in a row to
produce a false red (p^3 for per-attempt false-positive rate p).
"""

from __future__ import annotations

from typing import Callable, Optional


def passes_scaling_floor(
    measure_single: Callable[[], float],
    measure_sharded: Callable[[], float],
    floor: float = 1.5,
    attempts: int = 3,
    log: Optional[Callable[[str], None]] = None,
) -> bool:
    """True iff some attempt has measure_sharded() <= floor *
    measure_single(); each attempt calls BOTH measurers afresh."""
    for k in range(attempts):
        t1 = measure_single()
        tn = measure_sharded()
        ok = tn <= floor * t1
        if log is not None:
            log(
                f"scaling floor attempt {k + 1}/{attempts}: sharded "
                f"{tn * 1e3:.1f} ms vs single {t1 * 1e3:.1f} ms "
                f"(ratio {tn / t1 if t1 > 0 else float('inf'):.2f}, "
                f"floor {floor}) -> {'ok' if ok else 'over'}"
            )
        if ok:
            return True
    return False
