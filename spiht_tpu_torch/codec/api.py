"""Public single-image on-device codec, the port of
``spiht_tpu/codec/api.py:176-215`` (``encode_image_device``) and
``:635-678`` (``decode_image_device``).

Both run on the CUDA card unless the caller passes ``device="cpu"`` (the
plain versions, as the tests use them). There is no host fallback: the
word buffer is sized from the real budget, so the stream cannot overflow
it, and a machine that reports an error raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..settings import ENCODER_DECODER_VERSION, EncodingResult, SpihtSettings
from ..torch_transform import decode_pipeline_fn, encode_pipeline_fn
from .decoder import words_tensor
from .encoder import check_stat, stream_bytes

__all__ = ["encode_image_device", "decode_image_device"]


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
    words, stat, max_n = fn(img, 2**31 - 2 if max_bits is None else max_bits)
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
