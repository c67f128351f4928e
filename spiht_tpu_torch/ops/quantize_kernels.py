"""Kernel B6: the fused quantize / int16 compaction / element level map,
the port of ``spiht_tpu/ops/pallas_kernels.py`` (``_kernel`` :36, ``_run``
:61, ``quantize_compact_m`` :88).

``quantize_compact`` launches ``csrc/spiht_quantize.cu`` for a CUDA tensor
and runs the plain version, torch ops on the same inputs, for a CPU one.
``quantize_compact_m`` is the JAX package's name and signature for it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["quantize_compact", "quantize_compact_m"]


def _quantize_compact_plain(x: torch.Tensor, scale: torch.Tensor):
    """The plain version: B6's four outputs with torch ops."""
    q = (x * scale).to(torch.int32)  # truncates toward zero
    a = torch.abs(q)
    a16 = torch.clamp(q, -32767, 32767).to(torch.int16)
    # floor(log2 |q|), -1 for 0: 31 exact integer thresholds
    m = torch.full_like(q, -1)
    for k in range(31):
        m += (a >= (1 << k)).to(torch.int32)
    return q, a16, m.to(torch.int8), (a > 32767).any()


def quantize_compact(
    x: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6 (or, for a CPU tensor, its plain version).

    x: float32 coefficients of any shape (the per-channel scales already
    applied); scale: the quantization scale, rounded to float32 as the
    Pallas kernel's operand. Returns (q int32, a16 int16, m int8 with x's
    shape, overflow 0-d bool) on x's device: q = trunc(x * scale), a16 its
    clip to +-32767, m = floor(log2 |q|) (-1 for 0), overflow whether any
    |q| > 32767. Nothing is read back to the host.
    """
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    x = x.contiguous()
    dev = x.device
    scale32 = float(np.float32(scale))  # on the host: no tensor read
    if dev.type == "cpu":
        return _quantize_compact_plain(
            x, torch.tensor(scale32, dtype=torch.float32))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build

    lib = _build.load("spiht_quantize")
    arr = torch.empty(x.shape, dtype=torch.int32, device=dev)
    a16 = torch.empty(x.shape, dtype=torch.int16, device=dev)
    m = torch.empty(x.shape, dtype=torch.int8, device=dev)
    ofl = torch.zeros((), dtype=torch.int32, device=dev)
    rc = lib.spiht_quantize_compact_launch(
        x.data_ptr(), x.numel(), scale32, arr.data_ptr(),
        a16.data_ptr(), m.data_ptr(), ofl.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spiht_quantize_compact launch failed: CUDA error {rc}")
    quantize_compact.launches += 1
    return arr, a16, m, ofl != 0


quantize_compact.launches = 0


def quantize_compact_m(
    coeffs: torch.Tensor, q_scale
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6 under the JAX package's name: (arr_i32, arr_i16, M_i8,
    overflow_bool) of float32 (..., H, W) scaled coefficients, with the
    input's leading shape, on its device (``quantize_compact``)."""
    return quantize_compact(coeffs, q_scale)
