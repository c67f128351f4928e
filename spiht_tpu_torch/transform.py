"""Forward/inverse transform pipelines (colour + DWT + quantization), the
port of ``spiht_tpu/transform.py``.

Three interchangeable backends, all producing the packed coefficient
layout:
  * 'numpy'  - float64 host reference: ``wavelets/ref_dwt.py``, the
               ``color/models.py`` copy and ``ops/quantize.py``.
  * 'native' - the C++ DWT and quantization (``native/runtime.py``) on
               the host, colour conversion in numpy.
  * 'torch'  - ``torch_transform.forward`` / ``inverse`` on the caller's
               device (the CUDA card unless ``device="cpu"``).

``SPIHT_TPU_TRANSFORM`` picks the backend at import, as in the JAX
package; 'auto' (the default) and 'jax' both mean 'torch', the
counterpart of the JAX package's device transform, so one environment
drives both packages alike. Set ``_BACKEND`` to change it later.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .color import models as color_models
from .device import resolve_device
from .ops.quantize import dequantize, quantize
from .settings import SpihtSettings
from .wavelets import ref_dwt
from .wavelets.geometry import get_slices_and_h_w

__all__ = [
    "forward_numpy",
    "inverse_numpy",
    "forward_native",
    "inverse_native",
    "forward",
    "inverse",
    "get_backend",
]

_BACKEND = os.environ.get("SPIHT_TPU_TRANSFORM", "auto")


def get_backend() -> str:
    """'numpy', 'native' or 'torch' ('auto', 'jax' and anything else map
    to 'torch')."""
    if _BACKEND in ("numpy", "native"):
        return _BACKEND
    return "torch"


def forward_numpy(
    image: np.ndarray, settings: SpihtSettings, level: Optional[int]
) -> Tuple[np.ndarray, int, int]:
    """image (C,H,W) float -> (quantized i32 packed coeff array, ll_h, ll_w)."""
    if settings.color_model is not None:
        image = color_models.convert(image, "RGB", settings.color_model)
    coeffs = ref_dwt.wavedec2(
        image, settings.wavelet, mode=settings.mode, level=level, axes=(-2, -1)
    )
    ll_h, ll_w = coeffs[0].shape[1], coeffs[0].shape[2]
    arr, _ = ref_dwt.coeffs_to_array(coeffs, axes=(-2, -1))
    if settings.per_channel_quant_scales is not None:
        mults = np.array(settings.per_channel_quant_scales, dtype=np.float64)
        arr = mults[:, None, None] * arr
    arr = quantize(arr, settings.quantization_scale)
    return arr, ll_h, ll_w


def inverse_numpy(
    rec_arr: np.ndarray,
    h: int,
    w: int,
    level: Optional[int],
    settings: SpihtSettings,
    slices=None,
) -> np.ndarray:
    """Packed i32 array -> reconstructed (C,H,W) float image."""
    if slices is None:
        slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    rec = np.asarray(rec_arr, dtype=np.float64)
    if settings.per_channel_quant_scales is not None:
        mults = np.array(settings.per_channel_quant_scales, dtype=np.float64)
        rec = rec / mults[:, None, None]
    rec = dequantize(rec, settings.quantization_scale)
    coeffs = ref_dwt.array_to_coeffs(rec, slices)
    image = ref_dwt.waverec2(coeffs, settings.wavelet, mode=settings.mode)
    if settings.color_model is not None:
        image = color_models.convert(image, settings.color_model, "RGB")
    return image


def _levels(h: int, w: int, level, dec_len: int) -> int:
    from .wavelets.filters import dwt_max_level

    if level is not None:
        return level
    return min(dwt_max_level(h, dec_len), dwt_max_level(w, dec_len))


def forward_native(
    image: np.ndarray,
    settings: SpihtSettings,
    level: Optional[int],
    precision: Optional[str] = None,
) -> Tuple[np.ndarray, int, int]:
    """The native C++ DWT + quantization (the host production path).

    Same semantics as ``forward_numpy``; colour conversion stays in numpy.
    Periodization and level < 1, which the C++ kernel does not implement,
    run ``forward_numpy``, and so does everything under
    ``SPIHT_TPU_NO_NATIVE``, as in the JAX package. precision: 'f64'
    (default, bit-compatible with the numpy reference) or 'f32' (also via
    ``SPIHT_TPU_PRECISION``). The native library is built at first use
    and raises if it cannot be.
    """
    if precision is None:
        precision = os.environ.get("SPIHT_TPU_PRECISION", "f64")
    from .native import runtime
    from .wavelets.filters import build_wavelet

    image = np.asarray(image)
    h, w = image.shape[-2], image.shape[-1]
    wav = build_wavelet(settings.wavelet)
    lv = _levels(h, w, level, wav.dec_len)
    if lv < 1 or settings.mode == "periodization" or runtime.disabled():
        return forward_numpy(image, settings, level)
    nat = runtime.load()
    if settings.color_model is not None:
        image = color_models.convert(image, "RGB", settings.color_model)
    _, ph, pw = get_slices_and_h_w(h, w, settings, level)
    return nat.dwt_forward(
        image,
        wav.dec_lo,
        wav.dec_hi,
        settings.mode,
        lv,
        ph,
        pw,
        chan_scales=settings.per_channel_quant_scales,
        q_scale=settings.quantization_scale,
        precision=precision,
    )


def inverse_native(
    rec_arr: np.ndarray,
    h: int,
    w: int,
    level: Optional[int],
    settings: SpihtSettings,
    slices=None,
    precision: Optional[str] = None,
) -> np.ndarray:
    """The native C++ dequantize + inverse DWT, then the inverse colour in
    numpy. Same semantics as ``inverse_numpy`` (no final crop); it runs
    ``inverse_numpy`` where ``forward_native`` runs ``forward_numpy``."""
    if precision is None:
        precision = os.environ.get("SPIHT_TPU_PRECISION", "f64")
    from .native import runtime
    from .wavelets.filters import build_wavelet

    rec_arr = np.asarray(rec_arr)
    wav = build_wavelet(settings.wavelet)
    lv = _levels(h, w, level, wav.dec_len)
    if lv < 1 or settings.mode == "periodization" or runtime.disabled():
        return inverse_numpy(rec_arr, h, w, level, settings, slices)
    nat = runtime.load()
    if slices is None:
        slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
    F = wav.rec_len
    lvl_rects = []
    ah, aw = ll_h, ll_w
    for d in slices[1:]:
        s = d["dd"]
        dh, dw = s[1].stop - s[1].start, s[2].stop - s[2].start
        lvl_rects.append((s[1].start, s[2].start, dh, dw))
        ah, aw = 2 * dh - F + 2, 2 * dw - F + 2
    image = nat.dwt_inverse(
        rec_arr,
        wav.rec_lo,
        wav.rec_hi,
        lv,
        ll_h,
        ll_w,
        lvl_rects,
        ah,
        aw,
        chan_scales=settings.per_channel_quant_scales,
        q_scale=settings.quantization_scale,
        precision=precision,
    )
    if settings.color_model is not None:
        image = color_models.convert(image, settings.color_model, "RGB")
    return image


def forward(
    image,
    settings: SpihtSettings,
    level: Optional[int],
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """(C,H,W) image -> (int32 packed coefficients, ll_h, ll_w) under the
    backend: a numpy array on the host for 'numpy' and 'native', an int32
    tensor on ``device`` (the card unless ``device="cpu"``) for 'torch',
    in the working ``dtype``: a fresh tensor from the cached forward
    program of the image's shape (``torch_transform.forward_program``),
    the image staged into it where it lies."""
    backend = get_backend()
    if backend == "native":
        return forward_native(image, settings, level)
    if backend == "numpy":
        return forward_numpy(image, settings, level)
    from . import torch_transform

    img = torch.as_tensor(np.ascontiguousarray(image)) if not isinstance(
        image, torch.Tensor) else image
    prog = torch_transform.forward_program(
        settings, img.shape, level, dtype, False, img.dtype,
        resolve_device(device))
    return prog(img)[0], prog.ll[0], prog.ll[1]


def inverse(
    rec_arr,
    h: int,
    w: int,
    level,
    settings: SpihtSettings,
    slices=None,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """Packed int32 coefficients -> (C,H,W) image under the backend: a
    numpy array for 'numpy' and 'native', a tensor on ``device`` for
    'torch' (leading batch dims allowed there): a fresh tensor from the
    cached inverse program of the array's shape
    (``torch_transform.inverse_program``)."""
    backend = get_backend()
    if backend == "native":
        return inverse_native(rec_arr, h, w, level, settings, slices)
    if backend == "numpy":
        return inverse_numpy(rec_arr, h, w, level, settings, slices)
    from . import torch_transform

    rec = rec_arr if isinstance(rec_arr, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(rec_arr))
    return torch_transform.inverse_program(
        settings, rec.shape, h, w, level, dtype, False, rec.dtype,
        resolve_device(device))(rec)[0]
