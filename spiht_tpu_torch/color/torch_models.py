"""Colour-model conversions in PyTorch, the port of
``spiht_tpu/color/jax_models.py:223 convert``.

Channels-first over (..., C, H, W). Each 3x3 product is written out as a
weighted sum in a fixed order (``M[o,0]*x0 + M[o,1]*x1 + M[o,2]*x2``), not
an einsum or matmul, so no TF32 or reordered reduction can touch the
coefficients. IPT's ``sign(x)*|x|**0.43`` uses the device's ``pow``: the
card's float64 ``pow`` and the host's libm may differ by an ulp.

This slice ports RGB <-> IPT (the README's configuration). The JAX
package's other models are ROADMAP.md Queue A item "colour models other
than IPT" and raise NotImplementedError here.
"""

from __future__ import annotations

import torch

from . import models as _nm

__all__ = ["convert", "SUPPORTED_MODELS", "REFERENCE_MODELS"]

# every model name the JAX package accepts (spiht_tpu.color.models)
REFERENCE_MODELS = frozenset({
    "cam02lcd", "cam02scd", "cam02ucs", "cam16lcd", "cam16scd", "cam16ucs",
    "cie lab", "cie luv", "cie ucs", "cie uvw", "cie xyy", "cie xyz",
    "din99", "hdr-cielab", "hdr-ipt", "hunter lab", "hunter rdab", "icacb",
    "ictcp", "igpgtg", "ipt", "ipt ragoo", "jzazbz", "lab", "oklab",
    "osa ucs", "prolab", "rgb", "xyz", "ycbcr", "ycocg", "yrg",
})
SUPPORTED_MODELS = frozenset({"rgb", "ipt"})


def _apply_mat(im: torch.Tensor, M) -> torch.Tensor:
    x0, x1, x2 = im[..., 0, :, :], im[..., 1, :, :], im[..., 2, :, :]
    rows = [
        x0 * float(M[o][0]) + x1 * float(M[o][1]) + x2 * float(M[o][2])
        for o in range(3)
    ]
    return torch.stack(rows, dim=-3)


def _signed_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** p


def _ipt_from_rgb(im):
    xyz = _apply_mat(im, _nm.RGB_TO_XYZ)
    lms = _apply_mat(xyz, _nm.XYZ_TO_LMS_IPT)
    return _apply_mat(_signed_pow(lms, _nm.IPT_EXP), _nm.LMS_TO_IPT)


def _rgb_from_ipt(im):
    lms_p = _apply_mat(im, _nm.LMS_FROM_IPT)
    lms = _signed_pow(lms_p, 1.0 / _nm.IPT_EXP)
    return _apply_mat(_apply_mat(lms, _nm.XYZ_FROM_LMS_IPT), _nm.XYZ_TO_RGB)


_FORWARD = {"ipt": _ipt_from_rgb, "rgb": lambda x: x}
_INVERSE = {"ipt": _rgb_from_ipt, "rgb": lambda x: x}


def convert(im: torch.Tensor, src: str, dest: str) -> torch.Tensor:
    """Convert a (..., C, H, W) image between colour models."""
    src_l, dest_l = src.lower(), dest.lower()
    for m in (src_l, dest_l):
        if m not in REFERENCE_MODELS:
            raise ValueError(
                f"{m!r} is not a supported color model. "
                f"Supported models are {sorted(REFERENCE_MODELS)}"
            )
        if m not in SUPPORTED_MODELS:
            raise NotImplementedError(
                f"colour model {m!r} is not ported yet (ROADMAP.md Queue A, "
                "'colour models other than IPT')"
            )
    if src_l == "rgb":
        return _FORWARD[dest_l](im)
    if dest_l == "rgb":
        return _INVERSE[src_l](im)
    return _FORWARD[dest_l](_INVERSE[src_l](im))
