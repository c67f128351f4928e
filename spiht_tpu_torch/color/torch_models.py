"""Colour-model conversions in PyTorch, the port of
``spiht_tpu/color/jax_models.py``.

Channels-first over (..., C, H, W), for every model name the JAX package
accepts, in float64 or float32 on any device. The layout follows the JAX
module so a reader finds each counterpart: channels-first functions for
the matrix models, Lab, Oklab and IPT; channels-last core functions named
as in ``models.py`` (``jzazbz_from_xyz``, ``xyz_from_osa_ucs``,
``cam16ucs_from_xyz(variant=)``, ...) chained by ``_via_cl``; the
``_FORWARD`` and ``_INVERSE`` tables; ``convert``.

* Every 3x3 product is written out as a weighted sum in a fixed order
  (``M[o,0]*x0 + M[o,1]*x1 + M[o,2]*x2``), not an einsum or a matmul, so
  no TF32 pass or reordered reduction can touch the coefficients.
* The cube root is ``sign(x) * |x| ** (1/3)`` (torch has no ``cbrt``):
  on the CPU it matches ``np.cbrt`` to ~2e-16 relative. Every ``pow``,
  ``exp``, ``log1p``, ``atan2`` and trigonometric function is the
  device's own: the card's float64 results may differ from the host's
  libm by an ulp, which can move a borderline quantization truncation.
* Iterative inverses (OSA UCS: 80 bisection halvings, 60 damped Newton
  steps) run their fixed counts with no host read inside the loops.
* float32 is accepted: the PQ curves of JzAzBz, ICtCp and ICaCb raise
  ``|x|`` to powers near 134 and can over- or underflow there.
"""

from __future__ import annotations

import functools

import torch

from ..device import constant
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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _apply_mat(im: torch.Tensor, M) -> torch.Tensor:
    """Channels-first 3x3 product over axis -3."""
    x0, x1, x2 = im[..., 0, :, :], im[..., 1, :, :], im[..., 2, :, :]
    rows = [
        x0 * float(M[o][0]) + x1 * float(M[o][1]) + x2 * float(M[o][2])
        for o in range(3)
    ]
    return torch.stack(rows, dim=-3)


def _mat(x: torch.Tensor, M) -> torch.Tensor:
    """Channels-last ``x @ M.T``."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    rows = [
        x0 * float(M[o][0]) + x1 * float(M[o][1]) + x2 * float(M[o][2])
        for o in range(3)
    ]
    return torch.stack(rows, dim=-1)


def _dot(x: torch.Tensor, v) -> torch.Tensor:
    """Channels-last ``x @ v`` for a 3-vector ``v``."""
    return (x[..., 0] * float(v[0]) + x[..., 1] * float(v[1])
            + x[..., 2] * float(v[2]))


@constant
def _const_vec(values: tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _vec(v, x: torch.Tensor) -> torch.Tensor:
    """A constant vector in ``x``'s dtype and device (elementwise use),
    copied to the device once (``device.constant``)."""
    return _const_vec(tuple(float(e) for e in v), x.dtype, x.device)


def _signed_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** p


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _stack(parts) -> torch.Tensor:
    return torch.stack(parts, dim=-1)


# ---------------------------------------------------------------------------
# channels-first models (jax_models.py:39-81)
# ---------------------------------------------------------------------------


def _ipt_from_rgb(im):
    xyz = _apply_mat(im, _nm.RGB_TO_XYZ)
    lms = _apply_mat(xyz, _nm.XYZ_TO_LMS_IPT)
    return _apply_mat(_signed_pow(lms, _nm.IPT_EXP), _nm.LMS_TO_IPT)


def _rgb_from_ipt(im):
    lms_p = _apply_mat(im, _nm.LMS_FROM_IPT)
    lms = _signed_pow(lms_p, 1.0 / _nm.IPT_EXP)
    return _apply_mat(_apply_mat(lms, _nm.XYZ_FROM_LMS_IPT), _nm.XYZ_TO_RGB)


def _lab_f(t):
    d = 6.0 / 29.0
    return torch.where(t > d**3, _cbrt(t), t / (3 * d * d) + 4.0 / 29.0)


def _lab_finv(t):
    d = 6.0 / 29.0
    return torch.where(t > d, t**3, 3 * d * d * (t - 4.0 / 29.0))


def _lab_from_rgb(im):
    xyz = _apply_mat(im, _nm.RGB_TO_XYZ)
    xr = xyz / _vec(_nm.D65_WHITE, im)[:, None, None]
    f = _lab_f(xr)
    fx, fy, fz = f[..., 0, :, :], f[..., 1, :, :], f[..., 2, :, :]
    return torch.stack(
        [116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)], dim=-3
    )


def _rgb_from_lab(im):
    L, a, b = im[..., 0, :, :], im[..., 1, :, :], im[..., 2, :, :]
    fy = (L + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200
    xyz = torch.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], dim=-3)
    return _apply_mat(
        xyz * _vec(_nm.D65_WHITE, im)[:, None, None], _nm.XYZ_TO_RGB
    )


def _oklab_from_rgb(im):
    return _apply_mat(
        _signed_pow(_apply_mat(im, _nm.RGB_TO_LMS_OKLAB), 1.0 / 3.0),
        _nm.LMS_TO_OKLAB,
    )


def _rgb_from_oklab(im):
    return _apply_mat(
        _apply_mat(im, _nm.LMS_FROM_OKLAB) ** 3, _nm.RGB_FROM_LMS_OKLAB
    )


# ---------------------------------------------------------------------------
# channels-last core functions, as in models.py:243-1072
# ---------------------------------------------------------------------------


def _via_cl(fn_chain):
    """jax_models.py:84-93: move channels last, run the chain, move back."""

    def run(im):
        x = torch.movedim(im, -3, -1)
        for fn in fn_chain:
            x = fn(x)
        return torch.movedim(x, -1, -3).contiguous()

    return run


def _xyz_fwd(x):
    return _mat(x, _nm.RGB_TO_XYZ)


def _xyz_inv(x):
    return _mat(x, _nm.XYZ_TO_RGB)


def _lab_fwd_cl(x):
    xr = x / _vec(_nm.D65_WHITE, x)
    f = _lab_f(xr)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return _stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)])


def _lab_inv_cl(x):
    L, a, b = x[..., 0], x[..., 1], x[..., 2]
    fy = (L + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200
    return _stack(
        [_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)]
    ) * _vec(_nm.D65_WHITE, x)


def _pq_fwd(x, p):
    y = torch.sign(x) * torch.abs(x) ** _nm._PQ_N
    return torch.sign(x) * (
        (_nm._PQ_C1 + _nm._PQ_C2 * torch.abs(y))
        / (1.0 + _nm._PQ_C3 * torch.abs(y))
    ) ** p


def _pq_inv(x, p):
    y = torch.sign(x) * torch.abs(x) ** (1.0 / p)
    num = _nm._PQ_C1 - torch.abs(y)
    den = _nm._PQ_C3 * torch.abs(y) - _nm._PQ_C2
    return torch.sign(x) * torch.abs(num / den) ** (1.0 / _nm._PQ_N)


def jzazbz_from_xyz(x):
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    Xp = _nm._JZ_B * X - (_nm._JZ_B - 1.0) * Z
    Yp = _nm._JZ_G * Y - (_nm._JZ_G - 1.0) * X
    lms = _mat(_stack([Xp, Yp, Z]), _nm.XYZ_TO_LMS_JZ)
    iab = _mat(_pq_fwd(lms, _nm._PQ_P_JZ), _nm.LMS_TO_IAB_JZ)
    Iz = iab[..., 0]
    Jz = (1.0 + _nm._JZ_D) * Iz / (1.0 + _nm._JZ_D * Iz) - _nm._JZ_D0
    return _stack([Jz, iab[..., 1], iab[..., 2]])


def xyz_from_jzazbz(x):
    Jz, az, bz = x[..., 0], x[..., 1], x[..., 2]
    Jd = Jz + _nm._JZ_D0
    Iz = Jd / (1.0 + _nm._JZ_D - _nm._JZ_D * Jd)
    lms_p = _mat(_stack([Iz, az, bz]), _nm.LMS_FROM_IAB_JZ)
    lms = _pq_inv(lms_p, _nm._PQ_P_JZ)
    xyz_p = _mat(lms, _nm.XYZ_FROM_LMS_JZ)
    Xp, Yp, Z = xyz_p[..., 0], xyz_p[..., 1], xyz_p[..., 2]
    X = (Xp + (_nm._JZ_B - 1.0) * Z) / _nm._JZ_B
    Y = (Yp + (_nm._JZ_G - 1.0) * X) / _nm._JZ_G
    return _stack([X, Y, Z])


def ictcp_from_xyz(x):
    rgb2020 = _mat(x, _nm.XYZ_TO_BT2020)
    lms = _mat(rgb2020, _nm.RGB2020_TO_LMS)
    return _mat(_pq_fwd(lms, _nm._PQ_P_ICTCP), _nm.LMS_TO_ICTCP)


def xyz_from_ictcp(x):
    lms = _pq_inv(_mat(x, _nm.LMS_FROM_ICTCP), _nm._PQ_P_ICTCP)
    return _mat(_mat(lms, _nm.LMS_TO_RGB2020), _nm.BT2020_TO_XYZ)


def xyy_from_xyz(x):
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    s = X + Y + Z
    safe = torch.where(s == 0, 1.0, s)
    cx = torch.where(s == 0, _nm._D65_XY[0], X / safe)
    cy = torch.where(s == 0, _nm._D65_XY[1], Y / safe)
    return _stack([cx, cy, Y])


def xyz_from_xyy(x):
    cx, cy, Y = x[..., 0], x[..., 1], x[..., 2]
    safe = torch.where(cy == 0, 1.0, cy)
    X = torch.where(cy == 0, 0.0, cx * Y / safe)
    Z = torch.where(cy == 0, 0.0, (1.0 - cx - cy) * Y / safe)
    return _stack([X, Y, Z])


def _uv_prime(X, Y, Z):
    d = X + 15.0 * Y + 3.0 * Z
    safe = torch.where(d == 0, 1.0, d)
    return (
        torch.where(d == 0, 0.0, 4.0 * X / safe),
        torch.where(d == 0, 0.0, 9.0 * Y / safe),
    )


def luv_from_xyz(x):
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    yr = Y / _nm.D65_WHITE[1]
    e = (6.0 / 29.0) ** 3
    L = torch.where(yr > e, 116.0 * _cbrt(yr) - 16.0,
                    (29.0 / 3.0) ** 3 * yr)
    up, vp = _uv_prime(X, Y, Z)
    return _stack([L, 13.0 * L * (up - _nm._UN_PRIME),
                   13.0 * L * (vp - _nm._VN_PRIME)])


def xyz_from_luv(x):
    L, u, v = x[..., 0], x[..., 1], x[..., 2]
    safeL = torch.where(L == 0, 1.0, L)
    up = torch.where(L == 0, _nm._UN_PRIME, u / (13.0 * safeL)
                     + _nm._UN_PRIME)
    vp = torch.where(L == 0, _nm._VN_PRIME, v / (13.0 * safeL)
                     + _nm._VN_PRIME)
    Y = torch.where(
        L > 8.0,
        _nm.D65_WHITE[1] * ((L + 16.0) / 116.0) ** 3,
        _nm.D65_WHITE[1] * L * (3.0 / 29.0) ** 3,
    )
    safev = torch.where(vp == 0, 1.0, vp)
    X = torch.where(vp == 0, 0.0, Y * 9.0 * up / (4.0 * safev))
    Z = torch.where(vp == 0, 0.0,
                    Y * (12.0 - 3.0 * up - 20.0 * vp) / (4.0 * safev))
    return _stack([X, Y, Z])


def din99_from_lab(x):
    L, a, b = x[..., 0], x[..., 1], x[..., 2]
    L99 = 105.509 * torch.log1p(0.0158 * L)
    e = a * _nm._DIN99_COS16 + b * _nm._DIN99_SIN16
    f = 0.7 * (b * _nm._DIN99_COS16 - a * _nm._DIN99_SIN16)
    G = torch.sqrt(e * e + f * f)
    k = torch.where(G == 0, 0.0, torch.log1p(0.045 * G)
                    / (0.045 * torch.where(G == 0, 1.0, G)))
    return _stack([L99, k * e, k * f])


def lab_from_din99(x):
    L99, a99, b99 = x[..., 0], x[..., 1], x[..., 2]
    L = (torch.exp(L99 / 105.509) - 1.0) / 0.0158
    C99 = torch.sqrt(a99 * a99 + b99 * b99)
    G = (torch.exp(0.045 * C99) - 1.0) / 0.045
    scale = torch.where(C99 == 0, 0.0,
                        G / torch.where(C99 == 0, 1.0, C99))
    e = a99 * scale
    f = b99 * scale
    a = e * _nm._DIN99_COS16 - (f / 0.7) * _nm._DIN99_SIN16
    b = e * _nm._DIN99_SIN16 + (f / 0.7) * _nm._DIN99_COS16
    return _stack([L, a, b])


def hunter_lab_from_xyz(x):
    X, Y, Z = x[..., 0] * 100.0, x[..., 1] * 100.0, x[..., 2] * 100.0
    Xn, Yn, Zn = _nm.D65_WHITE * 100.0
    yr = Y / Yn
    sq = torch.sqrt(torch.clamp(yr, min=0.0))
    safe = torch.where(sq == 0, 1.0, sq)
    L = 100.0 * sq
    a = torch.where(sq == 0, 0.0, _nm._HUNTER_KA * (X / Xn - yr) / safe)
    b = torch.where(sq == 0, 0.0, _nm._HUNTER_KB * (yr - Z / Zn) / safe)
    return _stack([L, a, b])


def xyz_from_hunter_lab(x):
    L, a, b = x[..., 0], x[..., 1], x[..., 2]
    Xn, Yn, Zn = _nm.D65_WHITE * 100.0
    sq = L / 100.0
    yr = sq * sq
    X = Xn * (a * sq / _nm._HUNTER_KA + yr)
    Z = Zn * (yr - b * sq / _nm._HUNTER_KB)
    return _stack([X / 100.0, yr * Yn / 100.0, Z / 100.0])


def _cam16_adapt(rgb_c):
    t = (_nm._CAM16_FL * torch.abs(rgb_c) / 100.0) ** 0.42
    return torch.sign(rgb_c) * 400.0 * t / (t + 27.13) + 0.1


def _cam16_adapt_inv(rgb_a):
    v = rgb_a - 0.1
    av = torch.clamp(torch.abs(v), max=399.99)
    return (
        torch.sign(v)
        * (100.0 / _nm._CAM16_FL)
        * ((27.13 * av) / (400.0 - av)) ** (1.0 / 0.42)
    )


def ucs_from_xyz(x):
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    return _stack([2.0 * X / 3.0, Y, 0.5 * (-X + 3.0 * Y + Z)])


def xyz_from_ucs(x):
    U, V, W = x[..., 0], x[..., 1], x[..., 2]
    X = 1.5 * U
    return _stack([X, V, X - 3.0 * V + 2.0 * W])


def uvw_from_xyz(x):
    X, Y, Z = x[..., 0] * 100.0, x[..., 1] * 100.0, x[..., 2] * 100.0
    d = X + 15.0 * Y + 3.0 * Z
    safe = torch.where(d == 0, 1.0, d)
    u = torch.where(d == 0, _nm._UVW_UN, 4.0 * X / safe)
    v = torch.where(d == 0, _nm._UVW_VN, 6.0 * Y / safe)
    W = 25.0 * _cbrt(torch.clamp(Y, min=0.0)) - 17.0
    return _stack([13.0 * W * (u - _nm._UVW_UN),
                   13.0 * W * (v - _nm._UVW_VN), W])


def xyz_from_uvw(x):
    Us, Vs, W = x[..., 0], x[..., 1], x[..., 2]
    Y = ((W + 17.0) / 25.0) ** 3
    safew = torch.where(W == 0, 1.0, W)
    u = torch.where(W == 0, _nm._UVW_UN, Us / (13.0 * safew) + _nm._UVW_UN)
    v = torch.where(W == 0, _nm._UVW_VN, Vs / (13.0 * safew) + _nm._UVW_VN)
    safev = torch.where(v == 0, 1.0, v)
    X = torch.where(v == 0, 0.0, 1.5 * u * Y / safev)
    Z = torch.where(v == 0, 0.0, (6.0 * Y / safev - X - 15.0 * Y) / 3.0)
    return _stack([X / 100.0, Y / 100.0, Z / 100.0])


def _ucs_from_cam(R, G, B, aw, variant):
    """The CAM16/CAM02 forward from post-adaptation responses to the Luo
    2006 UCS coordinates (models.py:536-561, :855-875)."""
    a = R - 12.0 * G / 11.0 + B / 11.0
    b = (R + G - 2.0 * B) / 9.0
    h = torch.atan2(b, a)
    et = (torch.cos(h + 2.0) + 3.8) / 4.0
    A = (2.0 * R + G + B / 20.0 - 0.305) * _nm._CAM16_NBB
    J = 100.0 * torch.abs(A / aw) ** (_nm._CAM16_C * _nm._CAM16_Z)
    denom = R + G + 21.0 * B / 20.0 + 0.305
    t = (
        (50000.0 / 13.0)
        * _nm._CAM16_NC
        * _nm._CAM16_NCB
        * et
        * torch.sqrt(a * a + b * b)
        / denom
    )
    C = (
        torch.abs(t) ** 0.9
        * torch.sqrt(J / 100.0)
        * (1.64 - 0.29**_nm._CAM16_N) ** 0.73
    )
    M = C * _nm._CAM16_FL**0.25
    KL, c1, c2 = _nm._LUO2006[variant]
    Jp = (1.0 + 100.0 * c1) * J / (1.0 + c1 * J) / KL
    Mp = torch.log1p(c2 * M) / c2
    return _stack([Jp, Mp * torch.cos(h), Mp * torch.sin(h)])


def _cam_from_ucs(x, aw, variant):
    """The CAM16/CAM02 inverse from Luo 2006 UCS coordinates to the
    post-adaptation responses, in closed form (models.py:565-598,
    :879-906)."""
    Jp, ap, bp = x[..., 0], x[..., 1], x[..., 2]
    KL, c1, c2 = _nm._LUO2006[variant]
    Jk = Jp * KL
    J = Jk / (1.0 + 100.0 * c1 - c1 * Jk)
    Mp = torch.sqrt(ap * ap + bp * bp)
    M = (torch.exp(c2 * Mp) - 1.0) / c2
    h = torch.atan2(bp, ap)
    C = M / _nm._CAM16_FL**0.25
    Jsafe = torch.clamp(J, min=1e-10)
    t = (
        C / (torch.sqrt(Jsafe / 100.0)
             * (1.64 - 0.29**_nm._CAM16_N) ** 0.73)
    ) ** (1.0 / 0.9)
    et = (torch.cos(h + 2.0) + 3.8) / 4.0
    A = aw * (Jsafe / 100.0) ** (1.0 / (_nm._CAM16_C * _nm._CAM16_Z))
    p1t = (50000.0 / 13.0) * _nm._CAM16_NC * _nm._CAM16_NCB * et
    p2 = A / _nm._CAM16_NBB + 0.305
    beta, gamma = -11.0 / 23.0, -108.0 / 23.0
    sh, ch = torch.sin(h), torch.cos(h)
    den = p1t - t * (beta * ch + gamma * sh)
    s_rad = t * (p2 + 0.305) / torch.where(torch.abs(den) < 1e-12, 1e-12,
                                           den)
    a = s_rad * ch
    b = s_rad * sh
    Ra = (460.0 * p2 + 451.0 * a + 288.0 * b) / 1403.0
    Ga = (460.0 * p2 - 891.0 * a - 261.0 * b) / 1403.0
    Ba = (460.0 * p2 - 220.0 * a - 6300.0 * b) / 1403.0
    return _cam16_adapt_inv(_stack([Ra, Ga, Ba]))


def cam16ucs_from_xyz(x, variant="ucs"):
    rgb = _mat(x * 100.0, _nm.M16)
    rgb_c = rgb * _vec(_nm._CAM16_D_RGB, x)
    ra = _cam16_adapt(rgb_c)
    return _ucs_from_cam(ra[..., 0], ra[..., 1], ra[..., 2], _nm._CAM16_AW,
                         variant)


def xyz_from_cam16ucs(x, variant="ucs"):
    rgb_c = _cam_from_ucs(x, _nm._CAM16_AW, variant)
    rgb = rgb_c / _vec(_nm._CAM16_D_RGB, x)
    return _mat(rgb, _nm.M16_INV) / 100.0


def hunter_rdab_from_xyz(x):
    u = x[..., 0] / _nm.D65_WHITE[0]
    v = x[..., 1] / _nm.D65_WHITE[1]
    w = x[..., 2] / _nm.D65_WHITE[2]
    safe = torch.where(v == 0, 1.0, v)
    a = torch.where(v == 0, 0.0, _nm._HUNTER_KA * (u - v) / safe)
    b = torch.where(v == 0, 0.0, _nm._HUNTER_KB * (v - w) / safe)
    return _stack([100.0 * v, a, b])


def xyz_from_hunter_rdab(x):
    Rd, a, b = x[..., 0], x[..., 1], x[..., 2]
    v = Rd / 100.0
    u = v + a * v / _nm._HUNTER_KA
    w = v - b * v / _nm._HUNTER_KB
    return _stack([u * _nm.D65_WHITE[0], v * _nm.D65_WHITE[1],
                   w * _nm.D65_WHITE[2]])


def prolab_from_xyz(x):
    xyz_n = x / _vec(_nm.D65_WHITE, x)
    num = _mat(xyz_n, _nm.PROLAB_Q)
    den = _dot(xyz_n, _nm.PROLAB_q) + 1.0
    return num / den[..., None]


def xyz_from_prolab(x):
    y0 = _mat(x, _nm.PROLAB_Q_INV)
    qy = _dot(y0, _nm.PROLAB_q)
    xyz_n = y0 / (1.0 - qy)[..., None]
    return xyz_n * _vec(_nm.D65_WHITE, x)


def yrg_from_xyz(x):
    lms = _mat(x, _nm.YRG_XYZ_TO_LMS)
    L, M, S = lms[..., 0], lms[..., 1], lms[..., 2]
    Y = _nm._YRG_YL * L + _nm._YRG_YM * M
    t = L + M + S
    safe = torch.where(t == 0, 1.0, t)
    l = torch.where(t == 0, 0.0, L / safe)
    m = torch.where(t == 0, 0.0, M / safe)
    A, off = _nm._YRG_A, _nm._YRG_OFF
    r = A[0, 0] * l + A[0, 1] * m + off[0]
    g = A[1, 0] * l + A[1, 1] * m + off[1]
    return _stack([Y, r, g])


def xyz_from_yrg(x):
    Y, r, g = x[..., 0], x[..., 1], x[..., 2]
    rr = r - _nm._YRG_OFF[0]
    gg = g - _nm._YRG_OFF[1]
    Ai = _nm._YRG_A_INV
    l = Ai[0, 0] * rr + Ai[0, 1] * gg
    m = Ai[1, 0] * rr + Ai[1, 1] * gg
    d = _nm._YRG_YL * l + _nm._YRG_YM * m
    safe = torch.where(d == 0, 1.0, d)
    t = torch.where(d == 0, 0.0, Y / safe)  # L+M+S
    lms = _stack([t * l, t * m, t * (1.0 - l - m)])
    return _mat(lms, _nm.YRG_LMS_FROM_XYZ_INV)


def igpgtg_from_xyz(x):
    lms = _mat(x * 100.0, _nm.IGPGTG_XYZ_TO_LMS)
    lms_n = lms / _vec(_nm.IGPGTG_LMS_NORM, x)
    lms_p = _signed_pow(lms_n, _nm._IGPGTG_EXP)
    return _mat(lms_p, _nm.IGPGTG_LMS_TO_IGPGTG)


def xyz_from_igpgtg(x):
    lms_p = _mat(x, _nm.IGPGTG_LMS_FROM_IGPGTG)
    lms_n = _signed_pow(lms_p, 1.0 / _nm._IGPGTG_EXP)
    lms = lms_n * _vec(_nm.IGPGTG_LMS_NORM, x)
    return _mat(lms, _nm.IGPGTG_XYZ_FROM_LMS) / 100.0


def icacb_from_xyz(x):
    lms = _mat(x, _nm.ICACB_XYZ_TO_LMS)
    return _mat(_pq_fwd(lms, _nm._PQ_P_ICTCP), _nm.ICACB_LMS_TO_ICACB)


def xyz_from_icacb(x):
    lms = _pq_inv(_mat(x, _nm.ICACB_LMS_FROM_ICACB), _nm._PQ_P_ICTCP)
    return _mat(lms, _nm.ICACB_XYZ_FROM_LMS)


def ipt_ragoo_from_xyz(x):
    lms = _mat(x, _nm.IPT_RAGOO_XYZ_TO_LMS)
    return _mat(_signed_pow(lms, _nm.IPT_EXP), _nm.LMS_TO_IPT)


def xyz_from_ipt_ragoo(x):
    lms_p = _mat(x, _nm.LMS_FROM_IPT)
    lms = _signed_pow(lms_p, 1.0 / _nm.IPT_EXP)
    return _mat(lms, _nm.IPT_RAGOO_XYZ_FROM_LMS)


def cam02ucs_from_xyz(x, variant="ucs"):
    rgb = _mat(x * 100.0, _nm.M_CAT02)
    rgb_c = rgb * _vec(_nm._CAM02_D_RGB, x)
    rgb_p = _mat(rgb_c, _nm.M_HPE_FROM_CAT02)
    ra = _cam16_adapt(rgb_p)
    return _ucs_from_cam(ra[..., 0], ra[..., 1], ra[..., 2], _nm._CAM02_AW,
                         variant)


def xyz_from_cam02ucs(x, variant="ucs"):
    rgb_p = _cam_from_ucs(x, _nm._CAM02_AW, variant)
    rgb_c = _mat(rgb_p, _nm.M_CAT02_FROM_HPE)
    rgb = rgb_c / _vec(_nm._CAM02_D_RGB, x)
    return _mat(rgb, _nm.M_CAT02_INV) / 100.0


def _mm_lightness(y, eps, vmax):
    ye = torch.abs(y) ** eps
    return torch.sign(y) * (vmax * ye / (ye + 2.0**eps)) + 0.02


def _mm_lightness_inv(L, eps, vmax):
    v = L - 0.02
    av = torch.clamp(torch.abs(v), 0.0, vmax - 1e-9)
    ye = 2.0**eps * av / (vmax - av)
    return torch.sign(v) * ye ** (1.0 / eps)


def hdr_cielab_from_xyz(x):
    eps, w = _nm._HDR_EPS_LAB, _nm.D65_WHITE
    fx = _mm_lightness(x[..., 0] / w[0], eps, 247.0)
    fy = _mm_lightness(x[..., 1] / w[1], eps, 247.0)
    fz = _mm_lightness(x[..., 2] / w[2], eps, 247.0)
    return _stack([fy, 5.0 * (fx - fy), 2.0 * (fy - fz)])


def xyz_from_hdr_cielab(x):
    L, a, b = x[..., 0], x[..., 1], x[..., 2]
    eps, w = _nm._HDR_EPS_LAB, _nm.D65_WHITE
    fx = a / 5.0 + L
    fz = L - b / 2.0
    X = _mm_lightness_inv(fx, eps, 247.0) * w[0]
    Y = _mm_lightness_inv(L, eps, 247.0) * w[1]
    Z = _mm_lightness_inv(fz, eps, 247.0) * w[2]
    return _stack([X, Y, Z])


def hdr_ipt_from_xyz(x):
    lms = _mat(x, _nm.XYZ_TO_LMS_IPT)
    lms_p = _mm_lightness(lms, _nm._HDR_EPS_IPT, 246.0)
    return _mat(lms_p, _nm.LMS_TO_IPT)


def xyz_from_hdr_ipt(x):
    lms_p = _mat(x, _nm.LMS_FROM_IPT)
    lms = _mm_lightness_inv(lms_p, _nm._HDR_EPS_IPT, 246.0)
    return _mat(lms, _nm.XYZ_FROM_LMS_IPT)


def _osa_y0(X, Y, Z):
    s = X + Y + Z
    safe = torch.where(s == 0, 1.0, s)
    x = torch.where(s == 0, _nm._D65_XY[0], X / safe)
    y = torch.where(s == 0, _nm._D65_XY[1], Y / safe)
    return Y * (
        4.4934 * x * x + 4.3034 * y * y - 4.276 * x * y
        - 1.3744 * x - 2.5643 * y + 1.8103
    )


def _osa_lambda(Y0):
    return 5.9 * (
        _cbrt(torch.clamp(Y0, min=0.0)) - 2.0 / 3.0
        + 0.042 * torch.sign(Y0 - 30.0) * torch.abs(Y0 - 30.0) ** (1.0 / 3.0)
    )


def osa_ucs_from_xyz(x):
    X = x[..., 0] * 100.0
    Y = x[..., 1] * 100.0
    Z = x[..., 2] * 100.0
    Y0 = _osa_y0(X, Y, Z)
    lam = _osa_lambda(Y0)
    L = (lam - 14.4) / _nm._OSA_SQ2
    denom = 5.9 * (_cbrt(torch.clamp(Y0, min=0.0)) - 2.0 / 3.0)
    C = lam / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    rgb = _mat(_stack([X, Y, Z]), _nm.OSA_XYZ_TO_RGB)
    cb = _signed_pow(rgb, 1.0 / 3.0)
    u, v, w = cb[..., 0], cb[..., 1], cb[..., 2]
    a = -13.7 * u + 17.7 * v - 4.0 * w
    b = 1.7 * u + 8.0 * v - 9.7 * w
    return _stack([L, C * b, C * a])  # (L, j, g)


def xyz_from_osa_ucs(x):
    """models.py:1020-1072: Y0 by 80 bisection halvings, then the
    chromatic system by 60 damped Newton steps; fixed counts, no host
    read."""
    L, j, g = x[..., 0], x[..., 1], x[..., 2]
    lam = L * _nm._OSA_SQ2 + 14.4
    lo = torch.zeros_like(lam)
    hi = torch.maximum(
        torch.full_like(lam, 1200.0),
        (torch.clamp(lam, min=0.0) / 5.9 + 2.0 / 3.0) ** 3 + 1.0,
    )
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        below = _osa_lambda(mid) < lam
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    Y0 = torch.clamp(0.5 * (lo + hi), min=1e-9)
    denom = 5.9 * (_cbrt(Y0) - 2.0 / 3.0)
    C = lam / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    Csafe = torch.where(torch.abs(C) < 1e-9, 1e-9, C)
    a = g / Csafe
    b = j / Csafe
    # chromatic system: -13.7 u + 17.7 v = a + 4 w ; 1.7 u + 8 v = b + 9.7 w
    det = -13.7 * 8.0 - 17.7 * 1.7  # -139.69
    u0 = (8.0 * a - 17.7 * b) / det
    uw = (8.0 * 4.0 - 17.7 * 9.7) / det
    v0 = (-13.7 * b - 1.7 * a) / det
    vw = (-13.7 * 9.7 - 1.7 * 4.0) / det

    def xyz_of(wc):
        u = u0 + uw * wc
        v = v0 + vw * wc
        return _mat(_stack([u**3, v**3, wc**3]), _nm.OSA_RGB_TO_XYZ)

    def resid(wc):
        xyz = xyz_of(wc)
        return _osa_y0(xyz[..., 0], xyz[..., 1], xyz[..., 2]) - Y0

    wc = _cbrt(torch.clamp(Y0, min=1e-6))  # neutral-axis init
    eps = 1e-5
    for _ in range(60):
        f = resid(wc)
        df = (resid(wc + eps) - f) / eps
        step = f / torch.where(torch.abs(df) < 1e-12, 1e-12, df)
        step = torch.clamp(step, -1.0, 1.0)  # damped: cube-law far field
        wc = wc - step
    return xyz_of(wc) / 100.0


# ---------------------------------------------------------------------------
# tables (jax_models.py:124-220)
# ---------------------------------------------------------------------------


def _variant(fn, variant):
    return functools.partial(fn, variant=variant)


_FORWARD = {
    "ipt": _ipt_from_rgb,
    "cie xyz": lambda x: _apply_mat(x, _nm.RGB_TO_XYZ),
    "xyz": lambda x: _apply_mat(x, _nm.RGB_TO_XYZ),
    "cie lab": _lab_from_rgb,
    "lab": _lab_from_rgb,
    "ycbcr": lambda x: _apply_mat(x, _nm.RGB_TO_YCBCR),
    "oklab": _oklab_from_rgb,
    "rgb": lambda x: x,
    "jzazbz": _via_cl([_xyz_fwd, jzazbz_from_xyz]),
    "ictcp": _via_cl([_xyz_fwd, ictcp_from_xyz]),
    "cie xyy": _via_cl([_xyz_fwd, xyy_from_xyz]),
    "cie luv": _via_cl([_xyz_fwd, luv_from_xyz]),
    "din99": _via_cl([_xyz_fwd, _lab_fwd_cl, din99_from_lab]),
    "hunter lab": _via_cl([_xyz_fwd, hunter_lab_from_xyz]),
    "cam16ucs": _via_cl([_xyz_fwd, cam16ucs_from_xyz]),
    "cam16lcd": _via_cl([_xyz_fwd, _variant(cam16ucs_from_xyz, "lcd")]),
    "cam16scd": _via_cl([_xyz_fwd, _variant(cam16ucs_from_xyz, "scd")]),
    "cie ucs": _via_cl([_xyz_fwd, ucs_from_xyz]),
    "cie uvw": _via_cl([_xyz_fwd, uvw_from_xyz]),
    "hunter rdab": _via_cl([_xyz_fwd, hunter_rdab_from_xyz]),
    "prolab": _via_cl([_xyz_fwd, prolab_from_xyz]),
    "yrg": _via_cl([_xyz_fwd, yrg_from_xyz]),
    "igpgtg": _via_cl([_xyz_fwd, igpgtg_from_xyz]),
    "icacb": _via_cl([_xyz_fwd, icacb_from_xyz]),
    "ipt ragoo": _via_cl([_xyz_fwd, ipt_ragoo_from_xyz]),
    "ycocg": lambda x: _apply_mat(x, _nm.RGB_TO_YCOCG),
    "cam02ucs": _via_cl([_xyz_fwd, cam02ucs_from_xyz]),
    "cam02lcd": _via_cl([_xyz_fwd, _variant(cam02ucs_from_xyz, "lcd")]),
    "cam02scd": _via_cl([_xyz_fwd, _variant(cam02ucs_from_xyz, "scd")]),
    "hdr-cielab": _via_cl([_xyz_fwd, hdr_cielab_from_xyz]),
    "hdr-ipt": _via_cl([_xyz_fwd, hdr_ipt_from_xyz]),
    "osa ucs": _via_cl([_xyz_fwd, osa_ucs_from_xyz]),
}
_INVERSE = {
    "ipt": _rgb_from_ipt,
    "cie xyz": lambda x: _apply_mat(x, _nm.XYZ_TO_RGB),
    "xyz": lambda x: _apply_mat(x, _nm.XYZ_TO_RGB),
    "cie lab": _rgb_from_lab,
    "lab": _rgb_from_lab,
    "ycbcr": lambda x: _apply_mat(x, _nm.YCBCR_TO_RGB),
    "oklab": _rgb_from_oklab,
    "rgb": lambda x: x,
    "jzazbz": _via_cl([xyz_from_jzazbz, _xyz_inv]),
    "ictcp": _via_cl([xyz_from_ictcp, _xyz_inv]),
    "cie xyy": _via_cl([xyz_from_xyy, _xyz_inv]),
    "cie luv": _via_cl([xyz_from_luv, _xyz_inv]),
    "din99": _via_cl([lab_from_din99, _lab_inv_cl, _xyz_inv]),
    "hunter lab": _via_cl([xyz_from_hunter_lab, _xyz_inv]),
    "cam16ucs": _via_cl([xyz_from_cam16ucs, _xyz_inv]),
    "cam16lcd": _via_cl([_variant(xyz_from_cam16ucs, "lcd"), _xyz_inv]),
    "cam16scd": _via_cl([_variant(xyz_from_cam16ucs, "scd"), _xyz_inv]),
    "cie ucs": _via_cl([xyz_from_ucs, _xyz_inv]),
    "cie uvw": _via_cl([xyz_from_uvw, _xyz_inv]),
    "hunter rdab": _via_cl([xyz_from_hunter_rdab, _xyz_inv]),
    "prolab": _via_cl([xyz_from_prolab, _xyz_inv]),
    "yrg": _via_cl([xyz_from_yrg, _xyz_inv]),
    "igpgtg": _via_cl([xyz_from_igpgtg, _xyz_inv]),
    "icacb": _via_cl([xyz_from_icacb, _xyz_inv]),
    "ipt ragoo": _via_cl([xyz_from_ipt_ragoo, _xyz_inv]),
    "ycocg": lambda x: _apply_mat(x, _nm.YCOCG_TO_RGB),
    "cam02ucs": _via_cl([xyz_from_cam02ucs, _xyz_inv]),
    "cam02lcd": _via_cl([_variant(xyz_from_cam02ucs, "lcd"), _xyz_inv]),
    "cam02scd": _via_cl([_variant(xyz_from_cam02ucs, "scd"), _xyz_inv]),
    "hdr-cielab": _via_cl([xyz_from_hdr_cielab, _xyz_inv]),
    "hdr-ipt": _via_cl([xyz_from_hdr_ipt, _xyz_inv]),
    "osa ucs": _via_cl([xyz_from_osa_ucs, _xyz_inv]),
}

SUPPORTED_MODELS = frozenset(_FORWARD)


def convert(im: torch.Tensor, src: str, dest: str) -> torch.Tensor:
    """Convert a (..., C, H, W) image between colour models."""
    src_l, dest_l = src.lower(), dest.lower()
    for m in (src_l, dest_l):
        if m not in SUPPORTED_MODELS:
            raise ValueError(
                f"{m!r} is not a supported color model. "
                f"Supported models are {sorted(SUPPORTED_MODELS)}"
            )
    if src_l == "rgb":
        return _FORWARD[dest_l](im)
    if dest_l == "rgb":
        return _INVERSE[src_l](im)
    return _FORWARD[dest_l](_INVERSE[src_l](im))
