"""Transform pipelines in PyTorch, the port of ``spiht_tpu/jax_transform.py``.

* ``forward`` (``_forward_jit`` :66-85): colour model -> packed multilevel
  DWT -> per-channel scales -> ``* quantization_scale`` -> truncating int32
  cast.
* ``inverse`` (``_inverse_jit`` :149-193): ``/ per-channel scales``,
  ``/ quantization_scale``, ``waverec2``, inverse colour, optional uint8.
  No crop to (h, w): like the reference, the output can exceed the
  original dims for odd sizes.
* ``encode_pipeline_fn`` / ``decode_pipeline_fn`` (:343-389, :242-293): the
  whole encode (image -> stream words) and decode (stream words -> image)
  on one device, through the bit-machine kernels.
* ``encode_pipeline_batch_fn`` / ``decode_pipeline_batch_fn`` (:535-662,
  :393-500): the same over a (B, C, H, W) batch of one shape, through the
  batched kernels (B4; B5 or batched B3), one launch per direction.

* ``forward_compact`` (``_forward_compact_jit`` :103-146): the forward
  transform to int16 coefficients and an overflow flag, for the
  host-scheduled batch codec; with the float32 working dtype the quantize
  step is kernel B6 (``ops/quantize_kernels.py``).
* ``forward_plan`` and ``narrow`` (``_forward_plan_jit`` :701-733,
  ``_narrow_jit`` :736-746): the two device phases of the budget-narrowed
  batch encode.

* ``analysis_fn``, ``synthesis_fn``, ``forward_with_maps`` and
  ``default_dtype`` (:196, :214, :681, :48): the JAX package's factories
  and host step, over ``forward`` and ``inverse``. ``default_dtype`` is
  float64, the port's working default on every device (the JAX package
  picks float32 without x64).

``forward`` and ``inverse`` take leading batch dims: every step is
elementwise or works along H and W, so no value depends on the batch and
each image of a batch gets exactly what it gets alone.

The working dtype defaults to float64 on every device, so streams equal
the host float64 path. float32 is accepted with the JAX float32 path's
caveat: borderline truncations may flip.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .codec.decoder import decode_coeffs, decode_coeffs_batch
from .codec.encoder import encode_coeffs, encode_coeffs_batch
from .codec.maps import significance_maps
from .codec.planning import bits_per_plane_from_maps
from .ops.quantize_kernels import quantize_compact
from .color import torch_models
from .settings import SpihtSettings
from .wavelets import dwt
from .wavelets.geometry import get_slices_and_h_w

__all__ = [
    "forward",
    "forward_with_maps",
    "forward_compact",
    "forward_plan",
    "narrow",
    "inverse",
    "encode_pipeline_fn",
    "decode_pipeline_fn",
    "encode_pipeline_batch_fn",
    "decode_pipeline_batch_fn",
    "analysis_fn",
    "synthesis_fn",
    "default_dtype",
]


def default_dtype() -> torch.dtype:
    """The working dtype: float64 on every device, so that streams equal
    the host float64 path."""
    return torch.float64


def _as_dtype(dtype: Optional[str]) -> torch.dtype:
    """The factories' dtype, as the JAX package takes it: None
    (``default_dtype``) or a name such as "float32"."""
    if dtype is None:
        return default_dtype()
    return getattr(torch, np.dtype(dtype).name)


def _mults(pcs, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(pcs, dtype=x.dtype, device=x.device)[:, None, None]


def _scaled_coeffs(image, settings, level, dtype):
    """Colour model -> packed DWT -> per-channel scales, in ``dtype``."""
    image = image.to(dtype)
    if settings.color_model is not None:
        image = torch_models.convert(image, "RGB", settings.color_model)
    arr, ll_h, ll_w = dwt.wavedec2_packed(
        image, settings.wavelet, settings.mode, level
    )
    if settings.per_channel_quant_scales is not None:
        arr = arr * _mults(settings.per_channel_quant_scales, arr)
    return arr, ll_h, ll_w


def forward(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
) -> Tuple[torch.Tensor, int, int]:
    """(..., C, H, W) image(s) -> (int32 packed coefficients (..., C,
    enc_h, enc_w), ll_h, ll_w), on the images' device."""
    arr, ll_h, ll_w = _scaled_coeffs(image, settings, level, dtype)
    # truncate toward zero, as the reference's integer cast
    arr = (arr * float(settings.quantization_scale)).to(torch.int32)
    return arr, ll_h, ll_w


def forward_with_maps(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
):
    """``forward`` in ``default_dtype`` plus the significance maps: (arr
    int32, (M, D, G) int8, ll_h, ll_w), tensors on the image's device."""
    arr, ll_h, ll_w = forward(image, settings, level, default_dtype())
    return arr, significance_maps(arr, ll_h, ll_w), ll_h, ll_w


def analysis_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    with_maps: bool = True,
    dtype: Optional[str] = None,
):
    """fn(image(s) (..., C, H, W) tensor) -> arr int32, or (arr, M, D, G)
    with ``with_maps``: colour, DWT, scales and quantization
    (``forward``), then the maps, on the image's device. ``dtype``: None
    (``default_dtype``) or a name such as "float32"."""
    dt = _as_dtype(dtype)

    def fn(image: torch.Tensor):
        arr, ll_h, ll_w = forward(image, settings, level, dt)
        if with_maps:
            return (arr,) + significance_maps(arr, ll_h, ll_w)
        return arr

    return fn


def synthesis_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int] = None,
    dtype: Optional[str] = None,
    as_uint8: bool = False,
):
    """fn(rec_arr int32 (..., C, enc_h, enc_w) tensor) -> image(s) on the
    array's device: ``inverse`` in ``dtype`` (as ``analysis_fn`` takes
    it)."""
    dt = _as_dtype(dtype)

    def fn(rec_arr: torch.Tensor):
        return inverse(rec_arr, h, w, level, settings, dt, as_uint8)

    return fn


def forward_compact(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(..., C, H, W) image(s) -> (int16 coefficients clipped to +-32767,
    overflow 0-d bool: whether any |coefficient| > 32767, ll_h, ll_w), on
    the images' device; no host sync.

    With the float32 working dtype the quantize, the clip and the
    overflow check are one pass of kernel B6 over the scaled float32
    coefficients, as the JAX package's TPU path runs them; otherwise they
    are torch ops on ``forward``'s int32 array (B6 quantizes in float32,
    which could flip a borderline truncation of the float64 path).
    ``SPIHT_TPU_PALLAS`` routes as in the JAX package (``_use_pallas``
    :88-101): set, "1" runs B6 (float32 only) and any other value the
    torch ops; unset, B6 runs on float32."""
    flag = os.environ.get("SPIHT_TPU_PALLAS")
    if dtype == torch.float32 and (flag is None or flag == "1"):
        coeffs, ll_h, ll_w = _scaled_coeffs(image, settings, level, dtype)
        _, arr16, _, overflow = quantize_compact(
            coeffs.to(torch.float32), settings.quantization_scale
        )
        return arr16, overflow, ll_h, ll_w
    arr, ll_h, ll_w = forward(image, settings, level, dtype)
    overflow = (torch.abs(arr) > 32767).any()
    return torch.clamp(arr, -32767, 32767).to(torch.int16), overflow, ll_h, ll_w


def forward_plan(
    images: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """Device phase 1 of the budget-narrowed batch encode: (B, C, H, W)
    images -> (arr int32 (B, C, enc_h, enc_w), mx (B,) max |x| per image,
    counts (B, 32) exact full-stream bits per plane, max_n_dev (B,),
    ll_h, ll_w), all on the images' device. The counts are computed at
    the exact per-image max(M) (max_n_dev); the caller extends them to
    the reference's f32-rule max_n (the planes in between emit one
    all-zero test per initial LIP/LIS entity). Even LL dims only."""
    arr, ll_h, ll_w = forward(images, settings, level, dtype)
    mx = torch.abs(arr).amax(dim=(-3, -2, -1))
    m, d, g = significance_maps(arr, ll_h, ll_w)
    max_n_dev = m.amax(dim=(-3, -2, -1)).to(torch.int32).clamp(min=0)
    counts = bits_per_plane_from_maps(m, d, g, ll_h, ll_w, max_n_dev)
    return arr, mx, counts, max_n_dev, ll_h, ll_w


def narrow(
    arr: torch.Tensor, shifts: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Device phase 2: each image's magnitudes shifted right by its
    shift, sign kept, narrowed to ``out_dtype``. arr (B, C, H, W) int32;
    shifts (B,) int32 on arr's device."""
    mag = torch.abs(arr) >> shifts.reshape(-1, 1, 1, 1)
    return torch.where(arr >= 0, mag, -mag).to(out_dtype)


def inverse(
    rec_arr: torch.Tensor,
    h: int,
    w: int,
    level: Optional[int],
    settings: SpihtSettings,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
) -> torch.Tensor:
    """Packed (..., C, enc_h, enc_w) coefficients -> image(s) on their
    device."""
    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    rec = rec_arr.to(dtype)
    if settings.per_channel_quant_scales is not None:
        rec = rec / _mults(settings.per_channel_quant_scales, rec)
    rec = rec / float(settings.quantization_scale)
    coeffs = [rec[(...,) + slices[0][1:]]]
    for d in slices[1:]:
        coeffs.append({k: rec[(...,) + v[1:]] for k, v in d.items()})
    image = dwt.waverec2(coeffs, settings.wavelet, settings.mode)
    if settings.color_model is not None:
        image = torch_models.convert(image, settings.color_model, "RGB")
    if as_uint8:
        image = torch.round(torch.clamp(image, 0.0, 1.0) * 255.0).to(
            torch.uint8
        )
    return image


def encode_pipeline_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """fn(image (C,H,W) tensor, max_bits) -> (words int32, stat, max_n),
    all on the image's device: colour -> DWT -> quantize -> max_n (exact
    float32-truncation semantics, no log2) -> maps -> kernel B1. Nothing
    is read back to the host."""

    def fn(image: torch.Tensor, max_bits: int):
        arr, ll_h, ll_w = forward(image, settings, level, dtype)
        return encode_coeffs(arr, ll_h, ll_w, max_bits)

    return fn


def decode_pipeline_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
):
    """fn(words int32 tensor, nbits, max_n) -> image on the words' device:
    kernel B2 (+ rec scatter) or B3 -> dequantize -> ``waverec2`` ->
    inverse colour."""
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop

    def fn(words: torch.Tensor, nbits: int, max_n: int):
        rec = decode_coeffs(words, nbits, max_n, c, enc_h, enc_w, ll_h, ll_w)
        return inverse(rec, h, w, level, settings, dtype, as_uint8)

    return fn


def encode_pipeline_batch_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """fn(images (B,C,H,W) tensor, max_bits: B ints) -> (words (B,
    cap_words), stat (B, STAT_LEN), max_n (B,)), all on the images'
    device: the batched transform -> per-image max_n -> maps -> kernel B4.
    Nothing is read back to the host."""

    def fn(images: torch.Tensor, max_bits):
        arr, ll_h, ll_w = forward(images, settings, level, dtype)
        return encode_coeffs_batch(arr, ll_h, ll_w, max_bits)

    return fn


def decode_pipeline_batch_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
):
    """fn(words int32 (B, cap_words), nbits: B ints, max_n: B ints) ->
    images (B, ...) on the words' device: kernel B5 (+ one rec scatter) or
    batched B3 -> dequantize -> ``waverec2`` -> inverse colour."""
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop

    def fn(words: torch.Tensor, nbits, max_ns):
        rec = decode_coeffs_batch(words, nbits, max_ns, c, enc_h, enc_w,
                                  ll_h, ll_w)
        return inverse(rec, h, w, level, settings, dtype, as_uint8)

    return fn
