"""End-to-end sharded encode of one huge image across a device mesh, the
port of ``spiht_tpu/parallel/codec.py``.

Composes the pieces: the colour conversion and the quantization are
elementwise; the DWT runs with W sharded and halo exchange
(parallel/spatial.py); the SPIHT encode consumes the gathered coefficient
array on the axis's first device through the port's ``codec.api.encode``
(kernel B1 on the card). On a mesh over the ranks of a process group
every rank converts the colours and transforms its shards on its own
device, gets the replicated coefficient array and runs B1 on it, so
every rank returns the same result, as every JAX process does. The
emitted stream is identical to the single-device path (``encode_image`` under the 'torch' backend, and the
JAX package's ``encode_image`` under 'jax' with x64) at the float64
working dtype.

This is the "8K image tiled across chips" configuration (BASELINE.json
config 5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..codec import api as codec_api
from ..color import torch_models
from ..settings import EncodingResult, SpihtSettings
from ..torch_transform import _mults
from ..wavelets.filters import build_wavelet, dwt_max_level
from ..wavelets.geometry import get_slices_and_h_w
from .mesh import Mesh
from .spatial import sharded_wavedec2_packed

__all__ = ["encode_image_sharded"]


def _sharded_forward(image: torch.Tensor, settings: SpihtSettings,
                     level: int, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """Colour model -> sharded packed DWT -> per-channel scales ->
    ``* quantization_scale`` -> truncating int32 cast, in float64; the
    int32 array on the axis's first device (over ranks, on each rank's)."""
    if settings.color_model is not None:
        image = torch_models.convert(image, "RGB", settings.color_model)
    arr, _, _ = sharded_wavedec2_packed(
        image, settings.wavelet, settings.mode, level, mesh, axis_name
    )
    if settings.per_channel_quant_scales is not None:
        arr = arr * _mults(settings.per_channel_quant_scales, arr)
    # truncate toward zero, as the reference's integer cast
    return (arr * float(settings.quantization_scale)).to(torch.int32)


def encode_image_sharded(
    image,
    settings: SpihtSettings,
    mesh: Mesh,
    level: Optional[int] = None,
    max_bits: Optional[int] = None,
    axis_name: str = "tile",
) -> EncodingResult:
    """Encode one (C, H, W) image (numpy or tensor) with its W axis sharded
    over the mesh.

    Any width: the recursive sharded DWT pads to equal blocks internally
    and shards every level whose geometry permits (parallel/spatial.py),
    so the image is not padded here (the JAX package pads W to the axis
    size only so that ``device_put`` can split it; the values are the
    same). The colour conversion runs on the axis's first device before
    the split: it is per pixel, so a shard's values are those of a
    per-shard conversion. The working dtype is float64, which gives the
    host float64 path's streams. On a mesh over ranks every rank passes
    the same image, and its own device does the work above.
    """
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.ascontiguousarray(image))
    if image.dim() != 3:
        raise ValueError("image must be (c, h, w)")
    c, h, w = image.shape
    wav = build_wavelet(settings.wavelet)
    lv = level
    if lv is None:
        lv = min(dwt_max_level(h, wav.dec_len), dwt_max_level(w, wav.dec_len))
    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop

    dev = mesh.output_device(axis_name)
    arr = _sharded_forward(image.to(dev, torch.float64), settings, lv, mesh,
                           axis_name)
    if max_bits is None:
        max_bits = codec_api._MAX_BITS_DEFAULT
    data, max_n = codec_api.encode(arr, ll_h, ll_w, max_bits, dev)
    return EncodingResult(data, h, w, c, int(max_n), level)
