"""Multilevel 2D DWT in PyTorch, the port of ``spiht_tpu/wavelets/dwt.py``.

Same transform semantics as the JAX module (and, through it, the float64
numpy reference ``ref_dwt``), written as the same static gathers and
shifted multiply-accumulates:

* Boundary extension is an ``index_select`` with index maps built in
  numpy from the shapes alone, kept on the device by
  ``device.constant`` (one copy a shape, not one a call).
* Each filter pass is F shifted multiply-accumulates (`_shift_mac`), in
  the JAX module's tap order: one multiply and one add per tap, never a
  convolution, a matrix product or a fused multiply-add. So float64 runs
  give the JAX module's bits, and no float32 run can fall into TF32.
* Everything operates on (..., H, W); leading dims ride along.

The packed layout of `wavedec2_packed` is the reference coeffs_to_array
layout (spiht/spiht_wrapper.py:111-134).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import constant
from .filters import Wavelet, build_wavelet, dwt_coeff_len, dwt_max_level

__all__ = [
    "extend",
    "dwt1d",
    "idwt1d",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
    "wavedec2_packed",
    "pack",
]


def _as_wavelet(wavelet: Union[str, Wavelet]) -> Wavelet:
    if isinstance(wavelet, Wavelet):
        return wavelet
    return build_wavelet(wavelet)


def _sym_idx(i: np.ndarray, n: int) -> np.ndarray:
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i < n, i, period - 1 - i)


def _refl_idx(i: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.mod(i, period)
    return np.where(i < n, i, period - i)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, -1, idx)


@constant
def _ext_index(mode: str, n: int, pad: int, device) -> torch.Tensor:
    """The gather of ``extend``'s index modes over n samples, ``pad`` on
    each end ("antisymmetric" gathers as "symmetric"), int64 on
    ``device``."""
    i = np.arange(-pad, n + pad)
    if mode == "constant":
        idx = np.clip(i, 0, n - 1)
    elif mode in ("symmetric", "antisymmetric"):
        idx = _sym_idx(i, n)
    elif mode == "reflect":
        idx = _refl_idx(i, n)
    else:  # periodic, periodization
        idx = i % n
    return torch.as_tensor(idx, dtype=torch.long, device=device)


@constant
def _ext_sign(n: int, pad: int, dtype, device) -> torch.Tensor:
    """The antisymmetric extension's signs."""
    i = np.arange(-pad, n + pad)
    sign = np.where(np.mod(i, 2 * n) < n, 1.0, -1.0)
    return torch.as_tensor(sign, dtype=dtype, device=device)


@constant
def _ramp(pad: int, left: bool, dtype, device) -> torch.Tensor:
    """The smooth extension's slopes 1..pad (reversed on the left)."""
    k = np.arange(1, pad + 1)
    return torch.as_tensor(k[::-1].copy() if left else k, dtype=dtype,
                           device=device)


@constant
def _antireflect_index(n: int, pad: int, left: bool, device) -> torch.Tensor:
    """The reflected samples the antireflect extension subtracts."""
    i = np.arange(pad, 0, -1) if left else np.arange(n - 2, n - 2 - pad, -1)
    return torch.as_tensor(_refl_idx(i, n), dtype=torch.long, device=device)


def extend(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Extend the last axis of ``x`` by ``pad`` samples on both ends."""
    if pad == 0:
        return x
    n = x.shape[-1]
    dev = x.device
    if mode == "zero":
        z = x.new_zeros(x.shape[:-1] + (pad,))
        return torch.cat([z, x, z], dim=-1)
    if mode in ("constant", "symmetric", "reflect", "periodic",
                "periodization"):
        return _take(x, _ext_index(mode, n, pad, dev))
    if mode == "antisymmetric":
        return _take(x, _ext_index(mode, n, pad, dev)) * _ext_sign(
            n, pad, x.dtype, dev)
    if mode == "smooth":
        if n == 1:
            return x.repeat_interleave(2 * pad + 1, dim=-1)
        kl = _ramp(pad, True, x.dtype, dev)
        kr = _ramp(pad, False, x.dtype, dev)
        left = x[..., :1] + (x[..., :1] - x[..., 1:2]) * kl
        right = x[..., -1:] + (x[..., -1:] - x[..., -2:-1]) * kr
        return torch.cat([left, x, right], dim=-1)
    if mode == "antireflect":
        left = 2 * x[..., :1] - _take(x, _antireflect_index(n, pad, True, dev))
        right = 2 * x[..., -1:] - _take(
            x, _antireflect_index(n, pad, False, dev))
        return torch.cat([left, x, right], dim=-1)
    raise ValueError(f"unsupported mode {mode!r}")


def _shift_mac(ext2: torch.Tensor, taps, stride: int, out_len: int):
    """out[o] = sum_j taps[j] * ext2[stride*o + j], as F shifted
    multiply-adds in tap order (the JAX module's order)."""
    acc = None
    for j, t in enumerate(taps):
        term = ext2[..., j : j + stride * (out_len - 1) + 1 : stride] * float(t)
        acc = term if acc is None else acc + term
    return acc


def dwt1d(
    x: torch.Tensor,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axis: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level 1D DWT along ``axis``. Returns (cA, cD)."""
    w = _as_wavelet(wavelet)
    F = w.dec_len
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    out_len = dwt_coeff_len(n, F, mode)
    if mode == "periodization":
        if n % 2 == 1:
            x = torch.cat([x, x[..., -1:]], dim=-1)
        ext2 = extend(x, F - 1, "periodic")[..., 1:]
    else:
        ext2 = extend(x, F - 1, mode)[..., 1:]
    cA = _shift_mac(ext2, np.asarray(w.dec_lo)[::-1], 2, out_len)
    cD = _shift_mac(ext2, np.asarray(w.dec_hi)[::-1], 2, out_len)
    return torch.movedim(cA, -1, axis), torch.movedim(cD, -1, axis)


def idwt1d(
    cA: Optional[torch.Tensor],
    cD: Optional[torch.Tensor],
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axis: int = -1,
) -> torch.Tensor:
    """Single-level inverse DWT along ``axis`` (pywt.idwt semantics),
    polyphase: even and odd output samples are separate shifted-MAC
    chains over the coefficients, interleaved at the end."""
    w = _as_wavelet(wavelet)
    F = w.rec_len
    if cA is None and cD is None:
        raise ValueError("need at least one of cA, cD")
    ref = cA if cA is not None else cD
    ref = torch.movedim(ref, axis, -1)
    n = ref.shape[-1]
    if mode == "periodization":
        p = F
        idx = _ext_index("periodic", n, p, ref.device)

        def _pad(c):
            if c is None:
                return None
            return _take(torch.movedim(c, axis, -1), idx)

        full = idwt1d(_pad(cA), _pad(cD), w, "zero", axis=-1)
        return torch.movedim(full[..., 2 * p : 2 * p + 2 * n], -1, axis)
    out_len = 2 * n - F + 2
    lead = tuple(ref.shape[:-1])
    n_half = (out_len + 1) // 2
    pad = F // 2
    out = ref.new_zeros(lead + (out_len,))

    def acc_branch(out, c, filt):
        if c is None:
            return out
        c = torch.movedim(c, axis, -1)
        cp = torch.cat([c, c.new_zeros(lead + (pad,))], dim=-1)
        even = None
        for u in range((F - 1) // 2 + 1):
            t = 2 * u + 1
            if t >= F:
                break
            term = cp[..., u : u + n_half] * float(filt[F - 1 - t])
            even = term if even is None else even + term
        odd = None
        for v in range(F // 2):
            t = 2 * v
            term = cp[..., v : v + (out_len // 2)] * float(filt[F - 1 - t])
            odd = term if odd is None else odd + term
        if out_len % 2 == 1:
            odd = torch.cat([odd, odd.new_zeros(lead + (1,))], dim=-1)
            inter = torch.stack([even, odd], dim=-1).reshape(
                lead + (2 * n_half,)
            )[..., :out_len]
        else:
            inter = torch.stack([even, odd], dim=-1).reshape(lead + (out_len,))
        return out + inter

    out = acc_branch(out, cA, np.asarray(w.rec_lo))
    out = acc_branch(out, cD, np.asarray(w.rec_hi))
    return torch.movedim(out, -1, axis)


def dwt2(
    x: torch.Tensor,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axes: Tuple[int, int] = (-2, -1),
):
    """Single-level 2D DWT -> dict with keys 'aa','ad','da','dd'."""
    ax0, ax1 = axes
    a, d = dwt1d(x, wavelet, mode, axis=ax0)
    aa, ad = dwt1d(a, wavelet, mode, axis=ax1)
    da, dd = dwt1d(d, wavelet, mode, axis=ax1)
    return {"aa": aa, "ad": ad, "da": da, "dd": dd}


def idwt2(
    coeffs,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axes: Tuple[int, int] = (-2, -1),
) -> torch.Tensor:
    ax0, ax1 = axes
    a = idwt1d(coeffs.get("aa"), coeffs.get("ad"), wavelet, mode, axis=ax1)
    d = idwt1d(coeffs.get("da"), coeffs.get("dd"), wavelet, mode, axis=ax1)
    return idwt1d(a, d, wavelet, mode, axis=ax0)


def wavedec2(
    x: torch.Tensor,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    level: Optional[int] = None,
    axes: Tuple[int, int] = (-2, -1),
) -> List:
    """Multilevel 2D DWT -> [cA_n, {'ad','da','dd'}_n, ..., level1]."""
    w = _as_wavelet(wavelet)
    if level is None:
        level = min(
            dwt_max_level(x.shape[axes[0]], w.dec_len),
            dwt_max_level(x.shape[axes[1]], w.dec_len),
        )
    if level < 0:
        raise ValueError("level must be >= 0")
    coeffs: List = []
    a = x
    for _ in range(level):
        d = dwt2(a, w, mode, axes)
        a = d.pop("aa")
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def waverec2(
    coeffs: Sequence,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axes: Tuple[int, int] = (-2, -1),
) -> torch.Tensor:
    """Inverse of wavedec2 (incl. pywt's odd-length cA crops)."""
    w = _as_wavelet(wavelet)
    a = coeffs[0]
    for d in coeffs[1:]:
        dd_shape = d["dd"].shape
        slices = [slice(None)] * a.ndim
        for ax in axes:
            if a.shape[ax] == dd_shape[ax] + 1:
                slices[ax] = slice(0, dd_shape[ax])
        a = a[tuple(slices)]
        a = idwt2({"aa": a, **d}, w, mode, axes)
    return a


def wavedec2_packed(
    x: torch.Tensor,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    level: Optional[int] = None,
) -> Tuple[torch.Tensor, int, int]:
    """Multilevel DWT of (..., H, W) -> (packed array, ll_h, ll_w): LL at
    the top-left, then per level 'ad' top-right / 'da' bottom-left /
    'dd' bottom-right."""
    return pack(wavedec2(x, wavelet, mode, level, axes=(-2, -1)), x.dtype)


def pack(coeffs, dtype: torch.dtype) -> Tuple[torch.Tensor, int, int]:
    """``wavedec2``'s coefficient list -> (packed ``dtype`` array on cA's
    device, ll_h, ll_w), in ``wavedec2_packed``'s layout."""
    a = coeffs[0]
    ll_h, ll_w = a.shape[-2], a.shape[-1]
    total_h = ll_h + sum(d["dd"].shape[-2] for d in coeffs[1:])
    total_w = ll_w + sum(d["dd"].shape[-1] for d in coeffs[1:])
    arr = a.new_zeros(tuple(a.shape[:-2]) + (total_h, total_w), dtype=dtype)
    arr[..., :ll_h, :ll_w] = a
    sh, sw = ll_h, ll_w
    for d in coeffs[1:]:
        ad, da, dd = d["ad"], d["da"], d["dd"]
        arr[..., : ad.shape[-2], sw : sw + ad.shape[-1]] = ad
        arr[..., sh : sh + da.shape[-2], : da.shape[-1]] = da
        arr[..., sh : sh + dd.shape[-2], sw : sw + dd.shape[-1]] = dd
        sh += dd.shape[-2]
        sw += dd.shape[-1]
    return arr, ll_h, ll_w
