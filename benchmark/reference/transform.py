"""Plain PyTorch reference of the codec's transforms, float64.

The configuration's transform chain, written from the published
definitions and nothing of the program:

* RGB -> IPT (Ebner & Fairchild 1998): sRGB's RGB -> XYZ (D65) matrix,
  XYZ -> LMS, a signed power of 0.43, LMS' -> IPT; the inverse runs the
  inverted matrices and the power 1 / 0.43.
* The bior2.2 (CDF 5/3) DWT in pywt's 'reflect' mode (whole-sample
  symmetric extension, output length (n + F - 1) // 2), multilevel to
  pywt's ``dwt_max_level``, packed in the ``coeffs_to_array`` layout: LL
  top-left, then each level coarse -> fine with 'ad' top-right, 'da'
  bottom-left and 'dd' bottom-right.
* Per-channel scales, then the quantization scale, then truncation
  toward zero to int32 (a value outside int32, or NaN, gives -2^31, as
  numpy's cast does); dequantization divides by the same scales.

Every filter pass is a sum of shifted products in a fixed tap order, one
multiply and one add a tap, so that a float64 run gives the same bits on
any device; 3x3 colour products are fixed-order weighted sums.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

# sRGB (BT.709 primaries, D65) linear RGB -> XYZ, as colour-science gives it
RGB_TO_XYZ = np.array([
    [0.4123907992659595, 0.35758433938387796, 0.18048078840183429],
    [0.21263900587151036, 0.7151686787677559, 0.07219231536073371],
    [0.01933081871559185, 0.11919477979462599, 0.9505321522496607],
])
# IPT (Ebner & Fairchild 1998)
XYZ_TO_LMS = np.array([
    [0.4002, 0.7075, -0.0807],
    [-0.2280, 1.1500, 0.0612],
    [0.0000, 0.0000, 0.9184],
])
LMS_TO_IPT = np.array([
    [0.4000, 0.4000, 0.2000],
    [4.4550, -4.8510, 0.3960],
    [0.8056, 0.3572, -1.1628],
])
IPT_EXP = 0.43

# bior2.2 (CDF 5/3) as pywt lists it: decomposition and reconstruction
_S = 0.1767766952966369
_Q = 0.3535533905932738
_H = 0.7071067811865476
_T = 1.0606601717798214
BIOR22 = {
    "dec_lo": [0.0, -_S, _Q, _T, _Q, -_S],
    "dec_hi": [0.0, _Q, -_H, _Q, 0.0, 0.0],
    "rec_lo": [0.0, _Q, _H, _Q, 0.0, 0.0],
    "rec_hi": [0.0, _S, _Q, -_T, _Q, _S],
}
F = 6  # taps of each bior2.2 filter


def _mat3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """The 3x3 product ``m @ x`` over the channel axis -3."""
    x0, x1, x2 = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    return torch.stack([
        x0 * float(m[o, 0]) + x1 * float(m[o, 1]) + x2 * float(m[o, 2])
        for o in range(3)
    ], dim=-3)


def _signed_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** p


def ipt_from_rgb(x: torch.Tensor) -> torch.Tensor:
    lms = _mat3(_mat3(x, RGB_TO_XYZ), XYZ_TO_LMS)
    return _mat3(_signed_pow(lms, IPT_EXP), LMS_TO_IPT)


def rgb_from_ipt(x: torch.Tensor) -> torch.Tensor:
    lms = _signed_pow(_mat3(x, np.linalg.inv(LMS_TO_IPT)), 1.0 / IPT_EXP)
    xyz = _mat3(lms, np.linalg.inv(XYZ_TO_LMS))
    return _mat3(xyz, np.linalg.inv(RGB_TO_XYZ))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def max_level(n: int) -> int:
    """pywt's ``dwt_max_level`` for a filter of F taps."""
    if n < F - 1:
        return 0
    return int(math.floor(math.log2(n / (F - 1.0))))


def band_lengths(n: int, level: int) -> List[int]:
    """Lengths along one axis, finest level first: n_1, ..., n_level."""
    out = []
    for _ in range(level):
        n = (n + F - 1) // 2
        out.append(n)
    return out


def geometry(h: int, w: int, level=None) -> dict:
    """The packed layout of an h x w image: level, ll_h, ll_w, enc_h,
    enc_w and each level's detail band sizes, coarse -> fine."""
    if level is None:
        level = min(max_level(h), max_level(w))
    hs, ws = band_lengths(h, level), band_lengths(w, level)
    ll_h, ll_w = hs[-1], ws[-1]
    return {
        "level": level, "ll_h": ll_h, "ll_w": ll_w,
        "enc_h": ll_h + sum(hs), "enc_w": ll_w + sum(ws),
        "bands": list(zip(hs[::-1], ws[::-1])),  # coarse -> fine
    }


# ---------------------------------------------------------------------------
# DWT
# ---------------------------------------------------------------------------


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = np.arange(-pad, n + pad)
    if n == 1:
        return torch.zeros(i.size, dtype=torch.long, device=device)
    period = 2 * n - 2
    i = np.mod(i, period)
    return torch.as_tensor(np.where(i < n, i, period - i), device=device)


def _analysis(x: torch.Tensor, taps) -> torch.Tensor:
    """One filter of the last axis: out[o] = sum_t taps[t] x[2o + 1 - t]
    over the reflect-extended signal, summed from t = F - 1 down to 0."""
    n = x.shape[-1]
    out = (n + F - 1) // 2
    ext = torch.index_select(x, -1, _reflect_index(n, F - 1, x.device))
    acc = None
    for j in range(F):  # ext[1 + 2o + j] = x[2o + 1 - (F - 1 - j)]
        term = ext[..., 1 + j: 1 + j + 2 * (out - 1) + 1: 2] * float(
            taps[F - 1 - j])
        acc = term if acc is None else acc + term
    return acc


def _synthesis(c: torch.Tensor, taps) -> torch.Tensor:
    """pywt's ``idwt`` branch of one filter over the last axis:
    out[i] = sum_k c[k] taps[i + F - 2 - 2k], of length 2n - F + 2."""
    n = c.shape[-1]
    out_len = 2 * n - F + 2
    half = (out_len + 1) // 2
    cp = torch.cat([c, c.new_zeros(c.shape[:-1] + (F // 2,))], dim=-1)
    even = odd = None
    for u in range(F // 2):  # out[2m] = sum_u c[m + u] taps[F - 2 - 2u]
        term = cp[..., u: u + half] * float(taps[F - 2 - 2 * u])
        even = term if even is None else even + term
    for v in range(F // 2):  # out[2m + 1] = sum_v c[m + v] taps[F - 1 - 2v]
        term = cp[..., v: v + out_len // 2] * float(taps[F - 1 - 2 * v])
        odd = term if odd is None else odd + term
    if out_len % 2:
        odd = torch.cat([odd, odd.new_zeros(odd.shape[:-1] + (1,))], -1)
    return torch.stack([even, odd], -1).reshape(
        c.shape[:-1] + (2 * half,))[..., :out_len]


def _dwt_axis(x: torch.Tensor, axis: int):
    x = torch.movedim(x, axis, -1)
    a = _analysis(x, BIOR22["dec_lo"])
    d = _analysis(x, BIOR22["dec_hi"])
    return torch.movedim(a, -1, axis), torch.movedim(d, -1, axis)


def _idwt_axis(a: torch.Tensor, d: torch.Tensor, axis: int):
    a, d = torch.movedim(a, axis, -1), torch.movedim(d, axis, -1)
    out = _synthesis(a, BIOR22["rec_lo"]) + _synthesis(d, BIOR22["rec_hi"])
    return torch.movedim(out, -1, axis)


def wavedec2_packed(x: torch.Tensor, level: int) -> torch.Tensor:
    """(..., H, W) -> the packed (..., enc_h, enc_w) coefficients."""
    details = []
    a = x
    for _ in range(level):
        lo, hi = _dwt_axis(a, -2)
        aa, ad = _dwt_axis(lo, -1)
        da, dd = _dwt_axis(hi, -1)
        details.append((ad, da, dd))
        a = aa
    ll_h, ll_w = a.shape[-2:]
    enc_h = ll_h + sum(t[2].shape[-2] for t in details)
    enc_w = ll_w + sum(t[2].shape[-1] for t in details)
    arr = a.new_zeros(a.shape[:-2] + (enc_h, enc_w))
    arr[..., :ll_h, :ll_w] = a
    sh, sw = ll_h, ll_w
    for ad, da, dd in details[::-1]:
        bh, bw = dd.shape[-2:]
        arr[..., :bh, sw: sw + bw] = ad
        arr[..., sh: sh + bh, :bw] = da
        arr[..., sh: sh + bh, sw: sw + bw] = dd
        sh, sw = sh + bh, sw + bw
    return arr


def waverec2_packed(arr: torch.Tensor, geo: dict, h: int, w: int):
    """The packed coefficients -> the image, as pywt's ``waverec2``
    returns it (one row or column past an odd h or w)."""
    ll_h, ll_w = geo["ll_h"], geo["ll_w"]
    a = arr[..., :ll_h, :ll_w]
    sh, sw = ll_h, ll_w
    for bh, bw in geo["bands"]:
        ad = arr[..., :bh, sw: sw + bw]
        da = arr[..., sh: sh + bh, :bw]
        dd = arr[..., sh: sh + bh, sw: sw + bw]
        a = a[..., :bh, :bw]  # pywt's crop of an approximation one longer
        lo = _idwt_axis(a, ad, -1)
        hi = _idwt_axis(da, dd, -1)
        a = _idwt_axis(lo, hi, -2)
        sh, sw = sh + bh, sw + bw
    return a


# ---------------------------------------------------------------------------
# the whole chain
# ---------------------------------------------------------------------------


def _scales(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(cfg["per_channel_quant_scales"], dtype=x.dtype,
                        device=x.device)[:, None, None]


def quantize(x: torch.Tensor) -> torch.Tensor:
    """Truncation toward zero to int32; outside int32 (or NaN): -2^31."""
    inside = (x > -2.0**31 - 1) & (x < 2.0**31)
    return torch.where(inside, x.to(torch.int32),
                       torch.full_like(x, -2**31, dtype=torch.int32))


SUPPORTED = {"wavelet": "bior2.2", "mode": "reflect", "color_model": "ipt"}


def _supported(cfg: dict) -> None:
    for k, v in SUPPORTED.items():
        if cfg[k] != v:
            raise ValueError(f"the reference computes {k}={v!r}, not "
                             f"{cfg[k]!r}")


def forward(image: torch.Tensor, cfg: dict, dtype=torch.float64):
    """(C, H, W) RGB image -> int32 packed coefficients, with ``cfg``'s
    settings (a configuration's ``settings`` and ``level``: IPT, bior2.2
    in reflect mode, per-channel and quantization scales)."""
    _supported(cfg)
    x = ipt_from_rgb(image.to(dtype))
    geo = geometry(image.shape[-2], image.shape[-1], cfg.get("level"))
    arr = wavedec2_packed(x, geo["level"]) * _scales(cfg, x)
    return quantize(arr * float(cfg["quantization_scale"]))


def inverse(rec: torch.Tensor, cfg: dict, h: int, w: int,
            dtype=torch.float64) -> torch.Tensor:
    """Packed integer coefficients -> the RGB image."""
    _supported(cfg)
    geo = geometry(h, w, cfg.get("level"))
    x = rec.to(dtype) / _scales(cfg, rec.to(dtype))
    x = x / float(cfg["quantization_scale"])
    return rgb_from_ipt(waverec2_packed(x, geo, h, w))


def ll_size(h: int, w: int, level=None) -> Tuple[int, int]:
    geo = geometry(h, w, level)
    return geo["ll_h"], geo["ll_w"]
