"""Quantization with truncation-toward-zero semantics.

Copy of ``spiht_tpu/ops/quantize.py``, kept identical
(tests/test_torch_copies.py): the host transform backends' quantize step.
The reference quantizes by multiplying by the (per-channel and global)
scales and casting to int32 with numpy ``astype`` truncation, not
rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["quantize", "dequantize", "apply_channel_scales", "unapply_channel_scales"]


def quantize(arr: np.ndarray, q_scale: float = 10.0) -> np.ndarray:
    """coeffs * q_scale, truncated toward zero to int32."""
    return (arr * q_scale).astype(np.int32)


def dequantize(arr: np.ndarray, q_scale: float = 10.0) -> np.ndarray:
    return arr / q_scale


def apply_channel_scales(arr: np.ndarray, scales: Optional[Sequence[float]]):
    if scales is None:
        return arr
    mults = np.array(scales, dtype=arr.dtype if arr.dtype.kind == "f" else np.float64)
    return mults[:, None, None] * arr


def unapply_channel_scales(arr: np.ndarray, scales: Optional[Sequence[float]]):
    if scales is None:
        return arr
    mults = np.array(scales, dtype=np.float64)
    return arr / mults[:, None, None]
