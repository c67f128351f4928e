"""The decode's synthesis on the card: the inverse DWT, packed integer
coefficients -> the plane that the colour model reads, one launch a level
of ``csrc/spiht_synthesis.cu`` (kernel ``spiht_idwt_level``); and IPT's
inverse colour model, one launch of ``spiht_ipt_inverse`` (``rgb_from_ipt``).

``waverec2_packed`` dequantizes the packed array (``/`` the per-channel
scales, then ``/ quantization_scale``) and runs ``waverec2`` over it:
through the kernel for a CUDA tensor, through the plain version,
``waverec2_packed_plain`` (the torch ops of ``dwt.waverec2``), for a CPU
one. The kernel computes the plain version's values bit for bit, in
float64 and in float32.

``rgb_from_ipt`` is ``torch_models.convert(image, "ipt", "RGB")``: through
the kernel for a CUDA tensor, the same values as those torch ops on the card
bit for bit, in float64 and in float32; through the torch ops for a CPU one.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..color import models as _models
from ..color import torch_models
from ..device import constant
from ..wavelets import dwt
from ..wavelets.filters import build_wavelet

__all__ = ["waverec2_packed", "waverec2_packed_plain", "rgb_from_ipt"]

# the packed coefficients' dtypes the kernel reads as they are (in_kind)
_IN_KINDS = {torch.int16: 0, torch.int32: 1}
_DTYPES = {torch.float32: 0, torch.float64: 1}


@constant
def _consts(wavelet: str, q: float, pcs, dtype, device) -> torch.Tensor:
    """rec_lo, rec_hi, quantization_scale and the per-channel scales, in
    ``dtype`` on ``device``: the kernel's constants, and the plain
    version's divisors as views."""
    w = build_wavelet(wavelet)
    vals = [*w.rec_lo, *w.rec_hi, q, *(pcs or ())]
    return torch.tensor(vals, dtype=dtype, device=device)


def _divisors(settings, dtype, device):
    """(the consts, their per-channel scales as (C, 1, 1) or None, the
    quantization scale as a 0-d tensor). A 0-d tensor on the device, not a
    Python float: CUDA divides by a host scalar as a multiply by its
    reciprocal, the CPU by a true division."""
    pcs = settings.per_channel_quant_scales
    pcs = tuple(float(v) for v in pcs) if pcs is not None else None
    c = _consts(settings.wavelet, float(settings.quantization_scale), pcs,
                dtype, device)
    F = build_wavelet(settings.wavelet).rec_len
    scales = c[2 * F + 1:].reshape(-1, 1, 1) if pcs is not None else None
    return c, scales, c[2 * F]


def _dequantize(rec_arr, settings, dtype) -> torch.Tensor:
    """``rec_arr.to(dtype)`` / the per-channel scales / the quantization
    scale, op by op."""
    _, scales, q = _divisors(settings, dtype, rec_arr.device)
    rec = rec_arr.to(dtype)
    if scales is not None:
        rec = rec / scales
    return rec / q


def waverec2_packed_plain(rec_arr: torch.Tensor, slices, settings,
                          dtype: torch.dtype) -> torch.Tensor:
    """The plain version: dequantize, cut the subbands out of the packed
    array at ``slices`` (``get_slices_and_h_w``'s), ``dwt.waverec2``."""
    rec = _dequantize(rec_arr, settings, dtype)
    coeffs = [rec[(...,) + slices[0][1:]]]
    for d in slices[1:]:
        coeffs.append({k: rec[(...,) + v[1:]] for k, v in d.items()})
    return dwt.waverec2(coeffs, settings.wavelet, settings.mode)


def _span(s: slice):
    return s.start or 0, s.stop


def _level_args(slices, F: int, periodic: bool) -> List[dict]:
    """Each level's geometry, coarse to fine, as the kernel takes it: the
    subband shape (h, w), the offsets of ll (the coarsest level's aa), ad,
    da and dd in the packed plane, the previous level's output shape
    (prev_h, prev_w; None at the coarsest, which reads the LL) and the
    output's (out_h, out_w)."""
    prev, out = None, []
    for d in slices[1:]:
        (dd_r, dd_r1), (dd_c, dd_c1) = _span(d["dd"][1]), _span(d["dd"][2])
        h, w = dd_r1 - dd_r, dd_c1 - dd_c
        shape = (2 * h, 2 * w) if periodic else (2 * h - F + 2, 2 * w - F + 2)
        out.append(dict(
            h=h, w=w, ll=(0, 0), prev=prev, out=shape,
            **{k: (_span(d[k][1])[0], _span(d[k][2])[0]) for k in d}))
        prev = shape
    return out


def _levels(rec_arr: torch.Tensor, slices, settings, dtype: torch.dtype,
            launch) -> torch.Tensor:
    """The kernel's levels, coarse to fine: ``launch(*args)`` takes each
    level's arguments of ``spiht_idwt_level_launch`` but the stream, with
    the output allocated on ``rec_arr``'s device. Returns the last
    level's output."""
    if dtype not in _DTYPES:
        raise ValueError(f"the working dtype must be float32 or float64, "
                         f"got {dtype}")
    dev = rec_arr.device
    if len(slices) == 1:  # no level: the dequantized LL
        return _dequantize(rec_arr, settings, dtype)[(...,) + slices[0][1:]]
    consts, scales, _ = _divisors(settings, dtype, dev)
    rec = rec_arr
    if scales is not None:  # the scales' broadcast, as ``rec / scales``
        rec = torch.broadcast_tensors(rec, scales)[0]
    if rec.dtype not in _IN_KINDS:
        rec = rec.to(dtype)
    rec = rec.contiguous()
    lead, (enc_h, enc_w) = tuple(rec.shape[:-2]), tuple(rec.shape[-2:])
    need = (max(_span(v[1])[1] for v in slices[-1].values()),
            max(_span(v[2])[1] for v in slices[-1].values()))
    if enc_h < need[0] or enc_w < need[1]:  # the kernel reads every band
        raise ValueError(f"packed coefficients {enc_h}x{enc_w} do not hold "
                         f"the subbands' {need[0]}x{need[1]}")
    F = build_wavelet(settings.wavelet).rec_len
    periodic = settings.mode == "periodization"
    n_scales = scales.shape[0] if scales is not None else 0
    prev = None
    for g in _level_args(slices, F, periodic):
        out = torch.empty(lead + g["out"], dtype=dtype, device=dev)
        launch(
            _DTYPES[dtype], _IN_KINDS.get(rec.dtype, 2), rec.data_ptr(),
            enc_h, enc_w, prev.data_ptr() if prev is not None else None,
            *(g["prev"] or (0, 0)), *g["ll"], *g["ad"], *g["da"], *g["dd"],
            g["h"], g["w"], math.prod(lead), consts.data_ptr(), F, n_scales,
            int(periodic), out.data_ptr(), *g["out"],
        )
        prev = out
    return prev


def waverec2_packed(rec_arr: torch.Tensor, slices, settings,
                    dtype: torch.dtype) -> torch.Tensor:
    """The packed (..., C, enc_h, enc_w) coefficients -> the synthesized
    (..., C, out_h, out_w) plane in ``dtype``, on their device: one launch
    of ``spiht_idwt_level`` a level for a CUDA tensor (int16 and int32
    coefficients read as they are, any other dtype cast to ``dtype``
    first), the plain version for a CPU one."""
    dev = rec_arr.device
    if dev.type == "cpu":
        return waverec2_packed_plain(rec_arr, slices, settings, dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build

    lib = _build.load("spiht_synthesis")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(*args):
        rc = lib.spiht_idwt_level_launch(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"spiht_idwt_level launch failed: CUDA error {rc}")
        waverec2_packed.launches += 1

    return _levels(rec_arr, slices, settings, dtype, launch)


waverec2_packed.launches = 0


@constant
def _ipt_consts(dtype, device) -> torch.Tensor:
    """LMS_FROM_IPT, XYZ_FROM_LMS_IPT and XYZ_TO_RGB row by row, then
    1 / IPT_EXP, in ``dtype`` on ``device``: each rounded from the Python
    float as torch rounds a scalar operand of a ``dtype`` tensor."""
    vals = [float(v) for m in (_models.LMS_FROM_IPT, _models.XYZ_FROM_LMS_IPT,
                               _models.XYZ_TO_RGB) for row in m for v in row]
    return torch.tensor(vals + [1.0 / _models.IPT_EXP], dtype=dtype,
                        device=device)


def _ipt_inverse(image: torch.Tensor, launch) -> torch.Tensor:
    """The kernel's launch: ``launch(*args)`` takes the arguments of
    ``spiht_ipt_inverse_launch`` but the stream, with the output allocated
    on ``image``'s device. Returns the output."""
    h, w = image.shape[-2:]
    x = image.reshape(-1, 3, h, w)  # a view wherever the leading dims allow
    out = torch.empty(image.shape, dtype=image.dtype, device=image.device)
    if out.numel():
        launch(_DTYPES[image.dtype], x.data_ptr(), x.shape[0], h, w,
               *x.stride(), _ipt_consts(image.dtype, image.device).data_ptr(),
               out.data_ptr())
    return out


def rgb_from_ipt(image: torch.Tensor) -> torch.Tensor:
    """A (..., 3, H, W) IPT image in float32 or float64 -> RGB in a fresh
    contiguous tensor of its dtype, on its device: one launch of
    ``spiht_ipt_inverse`` for a CUDA tensor (any strides), the plain
    version (``torch_models.convert(image, "ipt", "RGB")``) for a CPU one."""
    if image.dim() < 3 or image.shape[-3] != 3:
        raise ValueError(f"an IPT image is (..., 3, H, W), got "
                         f"{tuple(image.shape)}")
    if image.dtype not in _DTYPES:
        raise ValueError(f"the working dtype must be float32 or float64, "
                         f"got {image.dtype}")
    dev = image.device
    if dev.type == "cpu":
        return torch_models.convert(image, "ipt", "RGB")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build

    lib = _build.load("spiht_synthesis")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(*args):
        rc = lib.spiht_ipt_inverse_launch(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"spiht_ipt_inverse launch failed: CUDA error {rc}")
        rgb_from_ipt.launches += 1

    return _ipt_inverse(image, launch)


rgb_from_ipt.launches = 0
