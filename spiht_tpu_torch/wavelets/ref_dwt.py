"""Trusted numpy reference implementation of the 2D multilevel DWT.

Copy of ``spiht_tpu/wavelets/ref_dwt.py``, kept identical (tests/test_torch_copies.py).

Reproduces the PyWavelets semantics the reference framework relies on
(reference: spiht/spiht_wrapper.py:163 ``pywt.wavedec2``, :165
``coeffs_to_array``, :102-108 ``wavedecn_shapes``, :275-276
``array_to_coeffs`` / ``waverec2``), re-derived from the published pywt
algorithm definitions:

  cA[o] = sum_j dec_lo[j] * x_ext[2o + 1 - j]    (x extended F-1 both sides)
  out_len = floor((N + F - 1) / 2)               (non-periodization modes)

The torch DWT in ``spiht_tpu_torch.wavelets.dwt`` is checked against the
JAX one, which is verified against this module. This module is float64 and host-only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .filters import Wavelet, build_wavelet, dwt_coeff_len, dwt_max_level

__all__ = [
    "extend",
    "dwt1d",
    "idwt1d",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
    "coeffs_to_array",
    "array_to_coeffs",
    "wavedecn_shapes",
]

_MODES = (
    "zero",
    "constant",
    "symmetric",
    "reflect",
    "periodic",
    "smooth",
    "antisymmetric",
    "antireflect",
    "periodization",
)


def _as_wavelet(wavelet: Union[str, Wavelet]) -> Wavelet:
    if isinstance(wavelet, Wavelet):
        return wavelet
    return build_wavelet(wavelet)


def extend(x: np.ndarray, pad: int, mode: str, axis: int = -1) -> np.ndarray:
    """Extend ``x`` by ``pad`` samples on both ends of ``axis`` (pywt modes)."""
    if pad == 0:
        return x
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if mode == "zero":
        out = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    elif mode == "constant":
        out = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    elif mode == "symmetric":
        out = _ext_indexed(x, pad, n, _sym_idx)
    elif mode == "reflect":
        out = _ext_indexed(x, pad, n, _refl_idx)
    elif mode in ("periodic", "periodization"):
        idx = np.arange(-pad, n + pad) % n
        out = x[..., idx]
    elif mode == "smooth":
        if n == 1:
            out = np.repeat(x, 2 * pad + 1, axis=-1)
        else:
            k = np.arange(1, pad + 1)
            left = x[..., :1] + (x[..., :1] - x[..., 1:2]) * k[::-1]
            right = x[..., -1:] + (x[..., -1:] - x[..., -2:-1]) * k
            out = np.concatenate([left, x, right], axis=-1)
    elif mode == "antisymmetric":
        out = _ext_indexed(x, pad, n, _sym_idx, _sym_sign)
    elif mode == "antireflect":
        # odd (point) reflection about the edge values
        idx_l = np.arange(pad, 0, -1)
        idx_r = np.arange(n - 2, n - 2 - pad, -1)
        left = 2 * x[..., :1] - _take_refl(x, idx_l, n)
        right = 2 * x[..., -1:] - _take_refl(x, idx_r, n)
        out = np.concatenate([left, x, right], axis=-1)
    else:
        raise ValueError(f"unsupported mode {mode!r}")
    return np.moveaxis(out, -1, axis)


def _sym_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Half-sample symmetric index map: ... x1 x0 | x0 x1 ... xn-1 | xn-1 ..."""
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i < n, i, period - 1 - i)


def _sym_sign(i: np.ndarray, n: int) -> np.ndarray:
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i < n, 1.0, -1.0)


def _refl_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample reflect index map: ... x2 x1 | x0 x1 ... xn-1 | xn-2 ..."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.mod(i, period)
    return np.where(i < n, i, period - i)


def _ext_indexed(x, pad, n, idx_fn, sign_fn=None):
    i = np.arange(-pad, n + pad)
    idx = idx_fn(i, n)
    out = x[..., idx]
    if sign_fn is not None:
        out = out * sign_fn(i, n)
    return out


def _take_refl(x, i, n):
    idx = _refl_idx(i, n)
    return x[..., idx]


def _downconv(ext: np.ndarray, filt: np.ndarray, out_len: int) -> np.ndarray:
    """out[o] = sum_j filt[j] * ext[2o + (F-1) ... ] along the last axis.

    ``ext`` is the signal already extended by F-1 on both sides; equivalent
    to full convolution evaluated at positions F + 2o.
    """
    F = len(filt)
    # correlate ext with reversed filter: conv(ext, filt)[m] for m = F + 2o
    # conv(ext, filt)[m] = sum_j ext[m - j] filt[j]
    windows = np.lib.stride_tricks.sliding_window_view(ext, F, axis=-1)
    # window starting at s covers ext[s .. s+F-1]; conv at m uses ext[m-F+1 .. m]
    # with reversed filter -> out[o] = windows[F + 2o - F + 1] . filt[::-1]
    starts = 1 + 2 * np.arange(out_len)
    sel = windows[..., starts, :]
    return sel @ filt[::-1]


def dwt1d(
    x: np.ndarray, wavelet: Union[str, Wavelet], mode: str = "reflect", axis: int = -1
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-level 1D DWT along ``axis``. Returns (cA, cD)."""
    w = _as_wavelet(wavelet)
    F = w.dec_len
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    n = x.shape[-1]
    out_len = dwt_coeff_len(n, F, mode)
    if mode == "periodization":
        # pywt periodization: odd-length input is first extended by
        # duplicating the last sample, then the signal is treated as
        # periodic; out_len = ceil(n/2). Same conv phase as other modes.
        if n % 2 == 1:
            x = np.concatenate([x, x[..., -1:]], axis=-1)
        ext = extend(x, F - 1, "periodic")
    else:
        ext = extend(x, F - 1, mode)
    cA = _downconv(ext, np.asarray(w.dec_lo), out_len)
    cD = _downconv(ext, np.asarray(w.dec_hi), out_len)
    return np.moveaxis(cA, -1, axis), np.moveaxis(cD, -1, axis)


def _upconv(c: np.ndarray, filt: np.ndarray, out_len: int) -> np.ndarray:
    """'valid' upsampling convolution: insert zeros, convolve, trim.

    out = full_conv(upsample2(c), filt)[F-2 : F-2+out_len].
    """
    F = len(filt)
    n = c.shape[-1]
    up = np.zeros(c.shape[:-1] + (2 * n,), dtype=c.dtype)
    up[..., ::2] = c
    full = np.apply_along_axis(lambda v: np.convolve(v, filt), -1, up)
    return full[..., F - 2 : F - 2 + out_len]


def idwt1d(
    cA: Optional[np.ndarray],
    cD: Optional[np.ndarray],
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axis: int = -1,
) -> np.ndarray:
    """Single-level inverse DWT along ``axis`` (pywt.idwt semantics)."""
    w = _as_wavelet(wavelet)
    F = w.rec_len
    if cA is None and cD is None:
        raise ValueError("need at least one of cA, cD")
    ref = cA if cA is not None else cD
    ref = np.moveaxis(np.asarray(ref, dtype=np.float64), axis, -1)
    n = ref.shape[-1]
    if mode == "periodization":
        # circular synthesis, out_len = 2n: periodically pad the
        # coefficients far enough (p = F covers every wrapped
        # contribution for any n >= 1), run the linear synthesis, and
        # take the central window [2p, 2p + 2n).
        p = F
        idx = np.arange(-p, n + p) % n

        def _pad(c):
            if c is None:
                return None
            c = np.moveaxis(np.asarray(c, dtype=np.float64), axis, -1)
            return c[..., idx]

        full = idwt1d(_pad(cA), _pad(cD), w, "zero", axis=-1)
        return np.moveaxis(full[..., 2 * p : 2 * p + 2 * n], -1, axis)
    out_len = 2 * n - F + 2
    out = np.zeros(ref.shape[:-1] + (out_len,), dtype=np.float64)
    for c, filt in ((cA, w.rec_lo), (cD, w.rec_hi)):
        if c is None:
            continue
        c = np.moveaxis(np.asarray(c, dtype=np.float64), axis, -1)
        out = out + _upconv(c, np.asarray(filt), out_len)
    return np.moveaxis(out, -1, axis)


def dwt2(
    x: np.ndarray,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    axes: Tuple[int, int] = (-2, -1),
):
    """Single-level 2D DWT. Returns dict with keys 'aa','ad','da','dd'.

    Key convention (pywt dwtn): first char = axes[0] (rows), second =
    axes[1] (cols); 'a' approximation, 'd' detail.
    """
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
) -> np.ndarray:
    ax0, ax1 = axes
    a = idwt1d(coeffs.get("aa"), coeffs.get("ad"), wavelet, mode, axis=ax1)
    d = idwt1d(coeffs.get("da"), coeffs.get("dd"), wavelet, mode, axis=ax1)
    return idwt1d(a, d, wavelet, mode, axis=ax0)


def wavedec2(
    x: np.ndarray,
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    level: Optional[int] = None,
    axes: Tuple[int, int] = (-2, -1),
) -> List:
    """Multilevel 2D DWT. Returns [cA_n, {'ad','da','dd'}_n, ..., level1].

    Matches pywt.wavedec2 structure except detail triples are dicts keyed by
    subband name instead of (cH, cV, cD) tuples ('ad' = cH top-right block,
    'da' = cV bottom-left, 'dd' = cD, per pywt coeffs_to_array layout).
    """
    w = _as_wavelet(wavelet)
    x = np.asarray(x, dtype=np.float64)
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
) -> np.ndarray:
    """Inverse of wavedec2 (pywt.waverec2 semantics incl. odd-length crops)."""
    w = _as_wavelet(wavelet)
    a = np.asarray(coeffs[0], dtype=np.float64)
    for d in coeffs[1:]:
        dd_shape = np.asarray(d["dd"]).shape
        # pywt: crop cA by one along axes where it outgrew the details
        slices = [slice(None)] * a.ndim
        for ax in axes:
            if a.shape[ax] == dd_shape[ax] + 1:
                slices[ax] = slice(0, dd_shape[ax])
        a = a[tuple(slices)]
        a = idwt2({"aa": a, **d}, w, mode, axes)
    return a


def wavedecn_shapes(
    shape: Tuple[int, ...],
    wavelet: Union[str, Wavelet],
    mode: str = "reflect",
    level: Optional[int] = None,
    axes: Tuple[int, int] = (-2, -1),
):
    """Coefficient shapes of wavedec2 (pywt.wavedecn_shapes semantics).

    Returns [approx_shape, {'ad': s, 'da': s, 'dd': s}, ...] coarse->fine.
    Mirrors the geometry used at reference spiht/spiht_wrapper.py:102-108.
    """
    w = _as_wavelet(wavelet)
    shape = tuple(shape)
    ax0 = axes[0] % len(shape)
    ax1 = axes[1] % len(shape)
    if level is None:
        level = min(
            dwt_max_level(shape[ax0], w.dec_len),
            dwt_max_level(shape[ax1], w.dec_len),
        )
    h, wd = shape[ax0], shape[ax1]
    per_level = []
    for _ in range(level):
        h = dwt_coeff_len(h, w.dec_len, mode)
        wd = dwt_coeff_len(wd, w.dec_len, mode)
        per_level.append((h, wd))
    per_level = per_level[::-1]  # coarse -> fine

    def full_shape(hh, ww):
        s = list(shape)
        s[ax0] = hh
        s[ax1] = ww
        return tuple(s)

    if level == 0:
        return [full_shape(shape[ax0], shape[ax1])]
    out: List = [full_shape(*per_level[0])]
    for lh, lw in per_level:
        out.append(
            {
                "ad": full_shape(lh, lw),
                "da": full_shape(lh, lw),
                "dd": full_shape(lh, lw),
            }
        )
    return out


def coeffs_to_array(coeffs: Sequence, axes: Tuple[int, int] = (-2, -1)):
    """Pack wavedec2 coefficients into one array (pywt layout).

    LL at top-left; per level 'ad' top-right, 'da' bottom-left, 'dd'
    bottom-right (reference layout doc: spiht/spiht_wrapper.py:111-134).
    Returns (arr, slices) where slices mirror get_slices_and_h_w.
    """
    a = np.asarray(coeffs[0])
    ax0 = axes[0] % a.ndim
    ax1 = axes[1] % a.ndim
    start_h = a.shape[ax0]
    start_w = a.shape[ax1]
    total_h, total_w = start_h, start_w
    for d in coeffs[1:]:
        total_h += np.asarray(d["dd"]).shape[ax0]
        total_w += np.asarray(d["dd"]).shape[ax1]
    full = list(a.shape)
    full[ax0] = total_h
    full[ax1] = total_w
    arr = np.zeros(tuple(full), dtype=np.float64)

    def put(block, hs, ws):
        sl = [slice(None)] * arr.ndim
        sl[ax0] = slice(hs, hs + block.shape[ax0])
        sl[ax1] = slice(ws, ws + block.shape[ax1])
        arr[tuple(sl)] = block

    put(a, 0, 0)
    slices: List = [(slice(None), slice(start_h), slice(start_w))]
    for d in coeffs[1:]:
        s_ad = np.asarray(d["ad"]).shape
        s_da = np.asarray(d["da"]).shape
        s_dd = np.asarray(d["dd"]).shape
        put(np.asarray(d["ad"]), 0, start_w)
        put(np.asarray(d["da"]), start_h, 0)
        put(np.asarray(d["dd"]), start_h, start_w)
        slices.append(
            {
                "ad": (slice(None), slice(0, s_ad[ax0]), slice(start_w, start_w + s_ad[ax1])),
                "da": (slice(None), slice(start_h, start_h + s_da[ax0]), slice(0, s_da[ax1])),
                "dd": (
                    slice(None),
                    slice(start_h, start_h + s_dd[ax0]),
                    slice(start_w, start_w + s_dd[ax1]),
                ),
            }
        )
        start_h += s_dd[ax0]
        start_w += s_dd[ax1]
    return arr, slices


def array_to_coeffs(arr: np.ndarray, slices: Sequence) -> List:
    """Inverse of coeffs_to_array for the wavedec2 format."""
    coeffs: List = [np.asarray(arr[slices[0]])]
    for d in slices[1:]:
        coeffs.append({k: np.asarray(arr[v]) for k, v in d.items()})
    return coeffs
