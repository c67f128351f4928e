"""The stream's starting bit plane ``max_n`` on the device, the port of
``spiht_tpu/codec/device_encoder.py:638-683`` (``_max_n_thresholds``,
``device_max_n``), and of its per-image ``jax.vmap`` over a batch
(``jax_transform.py:591``).

The reference computes ``(max as f32).log2() as u8``. Here the abs max is
cast to float32 (round to nearest, as the host cast does), its exponent is
read from the bits, and its mantissa is compared with a per-exponent
threshold where float32 ``log2`` truncation jumps to e+1: integer
operations only, no ``log2`` on the device. The magnitude is the native
scheduler's uint32 one (``spiht_tpu/native/spiht_kernel.cpp:164-177``): a
coefficient of -2^31 gives max_n 31.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import constant

__all__ = ["max_n_thresholds", "device_max_n"]


@lru_cache(maxsize=None)
def max_n_thresholds() -> tuple:
    """Per-exponent mantissa threshold where float32 log2 truncation
    jumps to e+1, found by binary search against numpy's float32 log2."""
    th = []
    for e in range(32):
        lo, hi = 0, 1 << 23
        while lo < hi:
            mid = (lo + hi) // 2
            x = np.array([((e + 127) << 23) | mid], np.uint32).view(
                np.float32
            )[0]
            if float(np.log2(x)) >= e + 1:
                hi = mid
            else:
                lo = mid + 1
        th.append(lo)
    return tuple(th)


@constant
def _thresholds_on(device) -> torch.Tensor:
    """``max_n_thresholds`` as int32 on ``device``, copied there once."""
    return torch.tensor(max_n_thresholds(), dtype=torch.int32, device=device)


def device_max_n(arr: torch.Tensor) -> torch.Tensor:
    """max_n of an int32 coefficient array (..., c, h, w), one per array
    over its last three dims (a 0-d tensor for one (c, h, w) array, (B,)
    for a batch), int32 on the array's device, bit-exact with
    ``oracle.compute_max_n``. No host sync."""
    absx = torch.abs(arr)
    m = absx.amax(dim=(-3, -2, -1)).to(torch.int32)
    # abs leaves -2^31 negative; as uint32 (the native scheduler's
    # magnitude) it is 2^31, whose max_n is 31
    top = absx.amin(dim=(-3, -2, -1)) < 0
    bits = m.to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m23 = bits & 0x7FFFFF
    th = _thresholds_on(arr.device)
    # take, not th[...]: a 0-d index tensor would be read on the host
    n = e + (m23 >= torch.take(th, e.clamp(0, 31).long())).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=arr.device)
    n = torch.where(m <= 0, zero, n.clamp(0, 255))
    return torch.where(top, torch.full_like(n, 31), n).to(torch.int32)
