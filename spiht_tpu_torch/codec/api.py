"""Public on-device codec, the port of ``spiht_tpu/codec/api.py:176-215``
(``encode_image_device``), ``:218-274`` (``encode_images_device``),
``:635-678`` (``decode_image_device``) and ``:681-728``
(``decode_images_device``).

Both run on the CUDA card unless the caller passes ``device="cpu"`` (the
plain versions, as the tests use them). There is no host fallback: the
word buffer is sized from the real budget, so the stream cannot overflow
it, and a machine that reports an error raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..settings import ENCODER_DECODER_VERSION, EncodingResult, SpihtSettings
from ..torch_transform import (
    decode_pipeline_batch_fn,
    decode_pipeline_fn,
    encode_pipeline_batch_fn,
    encode_pipeline_fn,
)
from .decoder import words_batch, words_tensor
from .encoder import batch_stream_bytes, check_stat, stream_bytes

__all__ = [
    "encode_image_device",
    "decode_image_device",
    "encode_images_device",
    "decode_images_device",
]

_MAX_BITS = 2**31 - 2  # the most an int32 bit count holds


def _as_image(image, device: torch.device) -> torch.Tensor:
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.ascontiguousarray(image))
    if image.dim() != 3:
        raise ValueError("image ndim must be 3: c,h,w")
    return image.to(device)


def encode_image_device(
    image,
    spiht_settings: SpihtSettings = SpihtSettings(),
    level: Optional[int] = None,
    max_bits: Optional[int] = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> EncodingResult:
    """Encode a (C, H, W) image (numpy or tensor) on the device: colour ->
    DWT -> quantize -> max_n -> SPIHT bit emission (kernel B1). Only the
    finished stream comes back to the host."""
    dev = resolve_device(device)
    img = _as_image(image, dev)
    c, h, w = img.shape
    fn = encode_pipeline_fn(spiht_settings, level, dtype)
    # machine_args clamps the budget to what an int32 bit count holds
    words, stat, max_n = fn(img, _MAX_BITS if max_bits is None else max_bits)
    total = check_stat(stat, "spiht_encode")[0]
    return EncodingResult(
        stream_bytes(words, total), h, w, c, int(max_n), level
    )


def decode_image_device(
    encoding_result: EncodingResult,
    spiht_settings: SpihtSettings,
    as_uint8: bool = False,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Decode an EncodingResult on the device: bit parse (kernel B2 and the
    rec scatter, or B3 for odd-LL geometries) -> dequantize -> inverse DWT
    -> inverse colour. Returns the image as a tensor on the device."""
    if encoding_result._encoding_version != ENCODER_DECODER_VERSION:
        raise ValueError(encoding_result._encoding_version)
    dev = resolve_device(device)
    h, w, c = encoding_result.h, encoding_result.w, encoding_result.c
    words, nbits = words_tensor(encoding_result.encoded_bytes, dev)
    fn = decode_pipeline_fn(
        spiht_settings, h, w, encoding_result.level, c, dtype, as_uint8
    )
    return fn(words, nbits, int(encoding_result.max_n))


def _budgets(max_bits, n: int) -> list:
    """Per-image budgets from None, one number, or a list of n."""
    if max_bits is None:
        return [_MAX_BITS] * n
    if np.ndim(max_bits) == 0:
        return [int(max_bits)] * n
    mbs = [int(m) for m in max_bits]
    if len(mbs) != n:
        raise ValueError(f"max_bits has {len(mbs)} budgets for {n} images")
    return mbs


def encode_images_device(
    images,
    spiht_settings: SpihtSettings = SpihtSettings(),
    level: Optional[int] = None,
    max_bits=None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> list:
    """Encode a list of (C, H, W) images (numpy or tensors) on the device.

    A batch of one shape is one pipeline: the batched transform and
    per-image max_n, then kernel B4 encodes every stream in one launch.
    ``max_bits`` is None (full streams), one budget, or one per image.
    Images of mixed shapes go one by one through ``encode_image_device``.
    Every stream is encoded on the card (odd LL and max_n > 15 included)
    and equals the JAX API's; results come back in input order.
    """
    ims = [
        im if isinstance(im, torch.Tensor)
        else torch.as_tensor(np.ascontiguousarray(im))
        for im in images
    ]
    if not ims:
        return []
    mbs = _budgets(max_bits, len(ims))
    dev = resolve_device(device)
    if any(im.dim() != 3 for im in ims):
        raise ValueError("image ndim must be 3: c,h,w")
    if len({tuple(im.shape) for im in ims}) != 1:
        return [
            encode_image_device(im, spiht_settings, level, mb, dev, dtype)
            for im, mb in zip(ims, mbs)
        ]
    c, h, w = ims[0].shape
    # each image straight into one device batch: no host-side stack of the
    # whole batch (at 128 images of 3x512x512 that copy alone costs more
    # than the transform on the card)
    batch = torch.empty(
        (len(ims), c, h, w), device=dev,
        dtype=functools.reduce(torch.promote_types, (im.dtype for im in ims)),
    )
    for b, im in enumerate(ims):
        batch[b].copy_(im)
    fn = encode_pipeline_batch_fn(spiht_settings, level, dtype)
    words, stat, max_ns = fn(batch, mbs)
    totals = [row[0] for row in check_stat(stat, "spiht_encode_batch")]
    return [
        EncodingResult(data, h, w, c, int(mn), level)
        for data, mn in zip(batch_stream_bytes(words, totals), max_ns.tolist())
    ]


def decode_images_device(
    encoding_results,
    spiht_settings: SpihtSettings,
    as_uint8: bool = False,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> list:
    """Decode a list of EncodingResults on the device; returns a list of
    image tensors on the device, in input order.

    Streams of one (h, w, c, level) are one pipeline: kernel B5 and one rec
    scatter (batched B3 for odd-LL geometries) decode every stream in one
    launch, each on its own length, then the batched inverse transform.
    Mixed geometries go one by one through ``decode_image_device``.
    """
    ers = list(encoding_results)
    if not ers:
        return []
    if len({(er.h, er.w, er.c, er.level) for er in ers}) != 1:
        return [
            decode_image_device(er, spiht_settings, as_uint8, device, dtype)
            for er in ers
        ]
    for er in ers:
        if er._encoding_version != ENCODER_DECODER_VERSION:
            raise ValueError(er._encoding_version)
    dev = resolve_device(device)
    er0 = ers[0]
    words, nbits = words_batch([er.encoded_bytes for er in ers], dev)
    fn = decode_pipeline_batch_fn(
        spiht_settings, er0.h, er0.w, er0.level, er0.c, dtype, as_uint8
    )
    images = fn(words, nbits, [int(er.max_n) for er in ers])
    return list(images.unbind(0))
