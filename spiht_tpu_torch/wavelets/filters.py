"""Wavelet filter banks, constructed from first principles.

Copy of ``spiht_tpu/wavelets/filters.py``, kept identical (tests/test_torch_copies.py).

The reference framework delegates filter banks to PyWavelets (reference:
spiht/spiht_wrapper.py:163 uses ``pywt.wavedec2`` with free wavelet choice,
default ``bior2.2``). This module re-derives the same filter banks
mathematically so the TPU framework is self-contained:

* ``haar`` / ``dbN``    — orthogonal Daubechies family, derived via spectral
  factorization of the half-band polynomial (minimum-phase root selection).
* ``symN``              — symlets ("least asymmetric" Daubechies): same
  half-band polynomial, root selection minimizing phase nonlinearity over
  all real factorizations; orientation fixed so ``dec_lo``'s energy center
  sits in the left half (reproduces the published tables; sym2/sym3
  coincide with db2/db3).
* ``coifN`` (1..5)      — coiflets, derived by Gauss-Newton solution of
  the defining moment system (orthonormality, 2N vanishing wavelet
  moments, 2N-1 vanishing scaling moments about tap 4N-1), seeded by the
  exact closed form for coif1 ((sqrt7±..)/16sqrt2) and zero-padded
  continuation for higher orders.
* ``dmey``              — 62-tap FIR approximation of the Meyer wavelet by
  frequency sampling of m0(w) = sqrt2*phi_hat(2w) (whole-sample-symmetric
  phase, 1024-point grid; verified against adaptive quadrature of the
  continuous Meyer integral). Near-orthogonal: PR error ~1e-5. The
  published MATLAB/pywt table agrees on the central taps but applies an
  unpublished edge treatment (its outermost taps are ~1e-8 where the
  true Meyer truncation has ~1e-5); both are approximations of the same
  continuous filter.
* ``biorNr.Nd``         — biorthogonal spline (CDF) family, derived with exact
  rational arithmetic from the Cohen–Daubechies–Feauveau construction.
  ``bior4.4``/``bior6.8`` follow the MATLAB/pywt convention of
  factoring the complementary polynomial between analysis and synthesis
  ("less dissimilar filter lengths" variant; bior4.4 is the CDF 9/7 pair).
  ``bior5.5`` is the 9/11 pair "close to orthonormal" (Daubechies, Ten
  Lectures §8.3.5): computed here by Newton iteration on its defining
  system (PR + 4/6 zeros at pi + symmetry), seeded from the published
  low-precision values to select that branch.
* ``rbioNr.Nd``         — reverse biorthogonal (dec/rec swapped).

Filter-bank conventions match PyWavelets:
  dec_hi[k] = (-1)**(k+1) * rec_lo[k]
  rec_hi[k] = (-1)**k      * dec_lo[k]
and dec_len == rec_len with zero padding:
  dec taps get ceil((len - taps)/2) leading zeros,
  rec taps get floor((len - taps)/2) leading zeros.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["Wavelet", "build_wavelet", "wavelist", "dwt_max_level", "dwt_coeff_len"]

SQRT2 = math.sqrt(2.0)


@dataclass(frozen=True)
class Wavelet:
    """A discrete wavelet filter bank (two-channel, critically sampled)."""

    name: str
    dec_lo: Tuple[float, ...]
    dec_hi: Tuple[float, ...]
    rec_lo: Tuple[float, ...]
    rec_hi: Tuple[float, ...]
    orthogonal: bool = False
    biorthogonal: bool = False

    @property
    def dec_len(self) -> int:
        return len(self.dec_lo)

    @property
    def rec_len(self) -> int:
        return len(self.rec_lo)

    def filter_bank(self):
        return (
            list(self.dec_lo),
            list(self.dec_hi),
            list(self.rec_lo),
            list(self.rec_hi),
        )


def _binom(n: int, k: int) -> Fraction:
    return Fraction(math.comb(n, k))


def _poly_mul(a: Sequence[Fraction], b: Sequence[Fraction]) -> List[Fraction]:
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return out


def _spline_lowpass(order: int) -> List[Fraction]:
    """B-spline synthesis scaling filter (before sqrt(2) scaling).

    m0(w) = (cos(w/2))**order  ->  taps 2**-order * binom(order, k).
    """
    return [_binom(order, k) / Fraction(2) ** order for k in range(order + 1)]


def _complementary_poly(L: int) -> List[Fraction]:
    """P(y) = sum_{m=0}^{L-1} binom(L-1+m, m) y**m  (Daubechies half-band)."""
    return [_binom(L - 1 + m, m) for m in range(L)]


def _cos2_to_taps(nd: int, q_taps: Sequence[float]) -> List[float]:
    """Expand m0(w) = cos(w/2)**nd * q(sin^2(w/2)) into filter taps.

    Uses z-domain identities with x = e^{-iw}:
      cos(w/2)**2  -> (1 + x)(1 + 1/x)/4   (centered 3-tap [1,2,1]/4)
      sin(w/2)**2  -> -(1 - x)(1 - 1/x)/4  (centered 3-tap [-1,2,-1]/4)
    For odd nd there is an extra half-sample delay giving even tap count.
    Returns the tap list (ascending index), NOT yet scaled by sqrt(2).
    """
    # Represent centered Laurent polynomials as coefficient lists.
    cos2 = [0.25, 0.5, 0.25]  # cos^2(w/2) as [x^-1, 1, x]
    sin2 = [-0.25, 0.5, -0.25]

    def pmulf(a, b):
        out = [0.0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] += ai * bj
        return out

    # q(sin^2) expansion
    poly = [1.0]
    acc = [float(q_taps[0])]
    for c in q_taps[1:]:
        poly = pmulf(poly, sin2)
        # align acc (shorter) center with poly center, then add c*poly
        grow = (len(poly) - len(acc)) // 2
        acc = [0.0] * grow + acc + [0.0] * grow
        acc = [a + float(c) * p for a, p in zip(acc, poly)]

    # multiply by cos(w/2)**nd
    npairs = nd // 2
    for _ in range(npairs):
        acc = pmulf(acc, cos2)
    if nd % 2 == 1:
        # cos(w/2) * e^{-iw/2} = (1 + x)/2
        acc = pmulf(acc, [0.5, 0.5])
    return acc


def _pad_filters(dec: List[float], rec: List[float]) -> Tuple[List[float], List[float]]:
    """Zero-pad dec/rec taps to a common even length, pywt style."""
    total = max(len(dec), len(rec))
    if total % 2 == 1:
        total += 1
    dl = total - len(dec)
    rl = total - len(rec)
    dec = [0.0] * ((dl + 1) // 2) + dec + [0.0] * (dl // 2)
    rec = [0.0] * (rl // 2) + rec + [0.0] * ((rl + 1) // 2)
    return dec, rec


def _qmf_pair(dec_lo: List[float], rec_lo: List[float]):
    dec_hi = [((-1.0) ** (k + 1)) * v for k, v in enumerate(rec_lo)]
    rec_hi = [((-1.0) ** k) * v for k, v in enumerate(dec_lo)]
    return dec_hi, rec_hi


def _build_bior(nr: int, nd: int) -> Tuple[List[float], List[float]]:
    """CDF biorthogonal spline filters (dec_lo, rec_lo), incl. sqrt2 scale.

    nr: reconstruction spline order, nd: decomposition order (pywt biorNr.Nd).
    bior4.4 / bior6.8 use the factored ("less dissimilar lengths") convention,
    all other members are pure spline. (bior5.5 uses yet another construction
    in MATLAB/pywt and is not supported.)
    """
    if (nr + nd) % 2 != 0:
        raise ValueError(f"bior{nr}.{nd}: nr+nd must be even")
    L = (nr + nd) // 2
    P = _complementary_poly(L)  # degree L-1 polynomial in y = sin^2(w/2)

    if (nr, nd) in ((4, 4), (6, 8)):
        # "Less dissimilar filter lengths" convention (MATLAB/pywt): factor P
        # between synthesis and analysis. Synthesis gets the real root(s) when
        # P has them (bior4.4 -> the CDF 9/7 pair); otherwise it gets the
        # conjugate pair whose real part is smallest in magnitude (bior6.8,
        # reproducing the published CDF 17/11 values).
        coeffs = [float(c) for c in P][::-1]  # numpy.roots wants descending
        roots = np.roots(coeffs)
        real_roots = sorted(
            (r.real for r in roots if abs(r.imag) < 1e-9), key=lambda v: v
        )
        cplx_roots = [r for r in roots if r.imag > 1e-9]  # one per conj pair

        def mul_real(q, r):
            # multiply by (1 - y/r), keeps q(0) = 1
            return [a - (b / r) for a, b in zip(q + [0.0], [0.0] + q)]

        def mul_cplx(q, r):
            # (1 - y/r)(1 - y/conj(r)) = 1 - 2Re(1/r) y + y^2/|r|^2
            m = abs(r) ** 2
            fac = [1.0, -2.0 * r.real / m, 1.0 / m]
            out = [0.0] * (len(q) + 2)
            for i, a in enumerate(q):
                for j, b in enumerate(fac):
                    out[i + j] += a * b
            return out

        q_rec, q_dec = [1.0], [1.0]
        if real_roots:
            for r in real_roots:
                q_rec = mul_real(q_rec, r)
            rec_pairs = []
        else:
            rec_pairs = [min(cplx_roots, key=lambda r: abs(r.real))]
            q_rec = mul_cplx(q_rec, rec_pairs[0])
        for r in cplx_roots:
            if r not in rec_pairs:
                q_dec = mul_cplx(q_dec, r)
        dec_taps = _cos2_to_taps(nd, q_dec)
        rec_taps = _cos2_to_taps(nr, q_rec)
    else:
        # Pure spline: all of P goes to the decomposition side.
        dec_taps = _cos2_to_taps(nd, [float(c) for c in P])
        rec_taps = _cos2_to_taps(nr, [1.0])

    dec_lo = [SQRT2 * t for t in dec_taps]
    rec_lo = [SQRT2 * t for t in rec_taps]
    return dec_lo, rec_lo


def _db_product_roots(N: int):
    """Root groups of the degree-(N-1) half-band polynomial, z-domain.

    Returns a list of (inside, outside) options per group: real y-roots
    give a {z, 1/z} pair; complex-conjugate y-root pairs give a
    {z, conj z} vs {1/z, conj 1/z} quadruple choice (keeping coefficients
    real either way).
    """
    P = [float(c) for c in _complementary_poly(N)]
    yroots = np.roots(P[::-1])
    groups = []
    used = np.zeros(len(yroots), bool)
    for i, y in enumerate(yroots):
        if used[i]:
            continue
        used[i] = True
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        z1 = (b + disc) / 2.0
        z2 = (b - disc) / 2.0
        zin = z1 if abs(z1) <= 1.0 else z2
        if abs(y.imag) < 1e-10:
            groups.append(([zin], [1.0 / zin]))
        else:
            j = int(np.argmin(np.abs(yroots - np.conj(y)) + used * 1e9))
            used[j] = True
            groups.append(
                ([zin, np.conj(zin)], [1.0 / zin, np.conj(1.0 / zin)])
            )
    return groups


def _factor_to_taps(N: int, roots) -> np.ndarray:
    """sqrt2 * ((1+z)/2)^N * prod (z - zk)/(1 - zk), real part."""
    poly = np.array([1.0 + 0j])
    for _ in range(N):
        poly = np.convolve(poly, [0.5, 0.5])
    for zk in roots:
        poly = np.convolve(poly, np.array([-zk, 1.0]) / (1.0 - zk))
    return np.real(poly) * SQRT2


def _phase_nonlinearity(h: np.ndarray) -> float:
    """L2 deviation of the unwrapped phase from its linear LS fit."""
    w = np.linspace(0.01, math.pi - 0.35, 256)  # avoid the zero at pi
    H = np.polyval(h[::-1], np.exp(-1j * w))
    ph = np.unwrap(np.angle(H))
    A = np.stack([w, np.ones_like(w)], 1)
    res = ph - A @ np.linalg.lstsq(A, ph, rcond=None)[0]
    return float(np.sum(res * res))


def _build_symlet(N: int) -> List[float]:
    """symN rec_lo (published-table orientation): least-asymmetric
    spectral factorization.

    Enumerates every real factorization of the dbN product filter and
    picks the one whose phase deviates least from linear; among the two
    mirror-image orientations, the published table is the one with its
    energy center in the left half (verified against sym4/sym5/sym8 in
    tests/test_filters.py).
    """
    if N in (2, 3):  # unique factorization: symlets coincide with db
        rec = _build_daubechies(N)
        return rec[::-1]
    groups = _db_product_roots(N)
    best, best_m = None, float("inf")
    for sel in range(1 << len(groups)):
        roots = []
        for g, (a, b) in enumerate(groups):
            roots.extend(a if (sel >> g) & 1 == 0 else b)
        h = _factor_to_taps(N, roots)
        m = _phase_nonlinearity(h)
        if m < best_m - 1e-12:
            best, best_m = h, m
    k = np.arange(len(best))
    center = float((k * best * best).sum() / (best * best).sum())
    if center > (len(best) - 1) / 2:
        best = best[::-1]
    return best.tolist()


def _coif_residuals(h: np.ndarray, K: int) -> np.ndarray:
    """Defining system for coifK rec_lo (length 6K, center n0=4K-1)."""
    L = 6 * K
    n = np.arange(L, dtype=float)
    n0 = 4 * K - 1
    r = [h.sum() - SQRT2]
    for m in range(0, 3 * K):
        v = float(np.dot(h[: L - 2 * m], h[2 * m :]))
        r.append(v - (1.0 if m == 0 else 0.0))
    sg = (-1.0) ** np.arange(L)
    scaled = (n - n0) / K  # scaling keeps the Jacobian well-conditioned
    for j in range(0, 2 * K):
        r.append(float((sg * scaled**j * h).sum()))
    for j in range(1, 2 * K):
        r.append(float((scaled**j * h).sum()))
    return np.array(r)


def _gauss_newton(h0, res_fn, iters=300, tol=1e-14):
    h = np.asarray(h0, dtype=np.float64).copy()
    for _ in range(iters):
        r = res_fn(h)
        if np.max(np.abs(r)) < tol:
            break
        J = np.zeros((len(r), len(h)))
        eps = 1e-8
        for i in range(len(h)):
            hp = h.copy()
            hp[i] += eps
            hm = h.copy()
            hm[i] -= eps
            J[:, i] = (res_fn(hp) - res_fn(hm)) / (2 * eps)
        step, *_ = np.linalg.lstsq(J, -r, rcond=None)
        t = 1.0
        base = np.max(np.abs(r))
        for _ in range(30):
            if np.max(np.abs(res_fn(h + t * step))) < base:
                break
            t *= 0.5
        h = h + t * step
    return h


@lru_cache(maxsize=None)
def _build_coiflet(K: int) -> Tuple[float, ...]:
    """coifK rec_lo by Gauss-Newton on the defining moment system.

    coif1 is seeded by its exact closed form
    (16*sqrt2*h = [sqrt7-3, 1-sqrt7, 14-2sqrt7, 14+2sqrt7, 5+sqrt7,
    1-sqrt7]); each higher order continues from the previous solution
    zero-padded (4 front / 2 back, keeping the moment center at 4K-1),
    which lands on the published branch (verified in tests).
    """
    if K == 1:
        s7 = math.sqrt(7.0)
        seed = np.array(
            [s7 - 3, 1 - s7, 14 - 2 * s7, 14 + 2 * s7, 5 + s7, 1 - s7]
        ) / (16 * SQRT2)
    else:
        prev = np.array(_build_coiflet(K - 1))
        seed = np.concatenate([np.zeros(4), prev, np.zeros(2)])
    h = _gauss_newton(seed, lambda x: _coif_residuals(x, K), iters=500)
    if np.max(np.abs(_coif_residuals(h, K))) > 1e-10:
        raise ValueError(f"coif{K} derivation did not converge")
    return tuple(h.tolist())


def _meyer_nu(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return x**4 * (35 - 84 * x + 70 * x**2 - 20 * x**3)


def _build_dmey() -> List[float]:
    """62-tap FIR approximation of the Meyer scaling filter.

    Samples m0(w) = sqrt2 * phi_hat(2w) (the exact Meyer conjugate
    mirror filter with the standard polynomial auxiliary nu) on a
    1024-point grid with whole-sample-symmetric phase (tau=31) and
    truncates the IFFT to 62 taps (grid-converged: identical to
    adaptive quadrature of the continuous integral to ~1e-10).
    Near-orthogonal: PR error ~1e-5 = the truncated tail mass, far
    below codec quantization error at practical settings.
    """
    N = 1024
    k = np.arange(N)
    w = 2 * math.pi * k / N
    w = np.where(w > math.pi, w - 2 * math.pi, w)
    aw = np.abs(2 * w)
    phi = np.zeros_like(aw)
    phi[aw <= 2 * math.pi / 3] = 1.0
    mid = (aw > 2 * math.pi / 3) & (aw <= 4 * math.pi / 3)
    phi[mid] = np.cos(
        math.pi / 2 * _meyer_nu(3 * aw[mid] / (2 * math.pi) - 1)
    )
    H = SQRT2 * phi * np.exp(-1j * w * 31.0)
    taps = np.fft.ifft(H).real[:62]
    # least-squares projection onto the exact DC constraints
    # (sum = sqrt2, alternating sum = 0): moves each tap by ~1e-7,
    # well inside the ~1e-5 truncation error, and makes the lowpass
    # normalization exact for the codec
    A = np.stack([np.ones(62), (-1.0) ** np.arange(62)])
    b = np.array([SQRT2, 0.0])
    taps = taps + A.T @ np.linalg.solve(A @ A.T, b - A @ taps)
    return taps.tolist()


# Published low-precision bior5.5 values (Daubechies' 9/11 "close to
# orthonormal" pair; constants widely reproduced in the literature).
# Used only to select the Newton branch; full precision is re-derived.
_BIOR55_DEC9_SEED = (
    0.039687, 0.007948, -0.054464, 0.345605, 0.736660,
    0.345605, -0.054464, 0.007948, 0.039687,
)
_BIOR55_REC11_SEED = (
    0.013457, -0.002695, -0.136707, -0.093505, 0.476803, 0.899506,
    0.476803, -0.093505, -0.136707, -0.002695, 0.013457,
)


def _build_bior55() -> Tuple[List[float], List[float]]:
    """bior5.5 (dec_lo 9 taps, rec_lo 11 taps) by Newton iteration.

    Defining system (square, 11 unknowns under symmetry): perfect
    reconstruction (product filter half-band), 4 zeros at pi for the
    decomposition filter, 6 for reconstruction, sum dec = sqrt2.
    """

    def mk(p):
        dec = np.concatenate([p[:5], p[:4][::-1]])
        rec = np.concatenate([p[5:], p[5:10][::-1]])
        return dec, rec

    def res(p):
        dec, rec = mk(p)
        full = np.convolve(dec, rec)  # length 19, center 9
        r = [full[9 + 2 * m] for m in range(1, 5)]
        r.append(full[9] - 1.0)
        n9 = np.arange(9.0) - 4.0
        s9 = (-1.0) ** np.arange(9)
        r += [float((s9 * dec).sum()), float((s9 * n9**2 * dec).sum())]
        n11 = np.arange(11.0) - 5.0
        s11 = (-1.0) ** np.arange(11)
        r += [
            float((s11 * rec).sum()),
            float((s11 * n11**2 * rec).sum()),
            float((s11 * n11**4 * rec).sum()),
        ]
        r.append(float(dec.sum()) - SQRT2)
        return np.array(r)

    p0 = np.array(_BIOR55_DEC9_SEED[:5] + _BIOR55_REC11_SEED[:6])
    p = _gauss_newton(p0, res, iters=100)
    if np.max(np.abs(res(p))) > 1e-12:
        raise ValueError("bior5.5 derivation did not converge")
    dec, rec = mk(p)
    return dec.tolist(), rec.tolist()


def _build_daubechies_mp(N: int) -> List[float]:
    """High-order dbN rec_lo via extended-precision spectral factorization.

    Above N~20 the half-band polynomial's roots cluster toward the unit
    circle and float64 companion-matrix rootfinding loses the minimum-
    phase selection; mpmath at 60 significant digits (polyroots with
    extra precision, product expansion in mp complex) keeps every tap
    exact to the float64 ulp through db38 (PR error ~1e-16, verified in
    tests/test_filters.py). Covers pywt's full db range, which the
    reference accepts via spiht_wrapper.py:55-57.
    """
    import mpmath as mp

    mp.mp.dps = 60
    P = [mp.binomial(N - 1 + m, m) for m in range(N)]
    yroots = mp.polyroots(P[::-1], maxsteps=200, extraprec=200)
    zroots = []
    for y in yroots:
        # z^2 - (2 - 4y) z + 1 = 0; pick |z| < 1 (minimum phase)
        b = 2 - 4 * y
        disc = mp.sqrt(b * b - 4)
        z1, z2 = (b + disc) / 2, (b - disc) / 2
        zroots.append(z1 if abs(z1) <= 1 else z2)

    def conv(a, b):
        out = [mp.mpc(0)] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] += ai * bj
        return out

    poly = [mp.mpc(1)]
    for _ in range(N):
        poly = conv(poly, [mp.mpf(1) / 2, mp.mpf(1) / 2])
    for zk in zroots:
        poly = conv(poly, [-zk / (1 - zk), 1 / (1 - zk)])
    s2 = mp.sqrt(2)
    return [float(mp.re(c) * s2) for c in poly]


def _build_daubechies(N: int) -> List[float]:
    """Daubechies dbN rec_lo via spectral factorization (minimum phase)."""
    if N == 1:
        h = [1.0 / SQRT2, 1.0 / SQRT2]
        return h
    if N > 20:
        return _build_daubechies_mp(N)  # same orientation as below
    # P(y) of degree N-1; roots in y, map to z via y = (2 - z - 1/z)/4
    P = [float(c) for c in _complementary_poly(N)]
    yroots = np.roots(P[::-1])
    zroots = []
    for y in yroots:
        # solve z^2 - (2 - 4y) z + 1 = 0; pick |z| < 1 (min phase)
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        z1 = (b + disc) / 2.0
        z2 = (b - disc) / 2.0
        zroots.append(z1 if abs(z1) <= 1.0 else z2)
    # h(z) = sqrt2 * ((1+z)/2)^N * prod (z - zk)/(1 - zk)  (normalized at z=1)
    poly = np.array([1.0 + 0j])
    for _ in range(N):
        poly = np.convolve(poly, [0.5, 0.5])
    for zk in zroots:
        poly = np.convolve(poly, np.array([-zk, 1.0]) / (1.0 - zk))
    h = (np.real(poly) * SQRT2).tolist()
    return h


@lru_cache(maxsize=None)
def build_wavelet(name: str) -> Wavelet:
    """Build a named wavelet filter bank (pywt-compatible naming)."""
    name = name.lower().strip()
    if name == "haar":
        w = build_wavelet("db1")
        return Wavelet(
            "haar", w.dec_lo, w.dec_hi, w.rec_lo, w.rec_hi, orthogonal=True
        )
    def _ortho(nm: str, rec_lo: List[float]) -> Wavelet:
        # pywt convention for orthogonal families: the published table IS
        # rec_lo; dec_lo is its reverse (decomposition = time-reversed
        # correlation). Getting this backwards flips the transform output
        # for every asymmetric filter.
        dec_lo = rec_lo[::-1]
        dec_hi, rec_hi = _qmf_pair(dec_lo, rec_lo)
        return Wavelet(
            nm,
            tuple(dec_lo),
            tuple(dec_hi),
            tuple(rec_lo),
            tuple(rec_hi),
            orthogonal=True,
        )

    if name.startswith("db"):
        N = int(name[2:])
        if not 1 <= N <= 38:  # pywt's full range
            raise ValueError(f"unsupported wavelet {name}")
        return _ortho(name, _build_daubechies(N)[::-1])
    if name.startswith("sym"):
        try:
            N = int(name[3:])
        except ValueError:
            raise ValueError(f"unsupported wavelet {name}") from None
        if not 2 <= N <= 20:
            raise ValueError(f"unsupported wavelet {name}")
        return _ortho(name, _build_symlet(N))
    if name.startswith("coif"):
        try:
            K = int(name[4:])
        except ValueError:
            raise ValueError(f"unsupported wavelet {name}") from None
        if not 1 <= K <= 17:  # pywt's full range
            raise ValueError(f"unsupported wavelet {name}")
        if K <= 5:
            return _ortho(name, list(_build_coiflet(K)))
        # coif6-17: vendored from this repo's own derivation tool
        # (tools/derive_coiflets.py) — orthonormality exact to the f64
        # ulp, moment conditions to the f64 solver floor; see the
        # table header for per-order residuals.
        from ._coif_tables import COIF_REC_LO

        return _ortho(name, list(COIF_REC_LO[K][1]))
    if name == "dmey":
        # near-orthogonal FIR Meyer approximation; treated as orthogonal
        return _ortho(name, _build_dmey())
    if name.startswith("bior") or name.startswith("rbio"):
        try:
            nr_s, nd_s = name[4:].split(".")
            nr, nd = int(nr_s), int(nd_s)
        except ValueError:
            raise ValueError(f"unsupported wavelet {name}") from None
        valid = {
            (1, 1), (1, 3), (1, 5),
            (2, 2), (2, 4), (2, 6), (2, 8),
            (3, 1), (3, 3), (3, 5), (3, 7), (3, 9),
            (4, 4), (5, 5), (6, 8),
        }
        if (nr, nd) not in valid:
            raise ValueError(f"unsupported wavelet {name}")
        if (nr, nd) == (5, 5):
            dec_lo, rec_lo = _build_bior55()
        else:
            dec_lo, rec_lo = _build_bior(nr, nd)
        if name.startswith("rbio"):
            dec_lo, rec_lo = rec_lo, dec_lo
        dec_lo, rec_lo = _pad_filters(dec_lo, rec_lo)
        dec_hi, rec_hi = _qmf_pair(dec_lo, rec_lo)
        return Wavelet(
            name,
            tuple(dec_lo),
            tuple(dec_hi),
            tuple(rec_lo),
            tuple(rec_hi),
            biorthogonal=True,
        )
    raise ValueError(f"unsupported wavelet {name}")


def wavelist() -> List[str]:
    names = ["haar"] + [f"db{n}" for n in range(1, 39)]
    names += [f"sym{n}" for n in range(2, 21)]
    names += [f"coif{n}" for n in range(1, 18)]
    names += ["dmey"]
    pairs = [
        (1, 1), (1, 3), (1, 5),
        (2, 2), (2, 4), (2, 6), (2, 8),
        (3, 1), (3, 3), (3, 5), (3, 7), (3, 9),
        (4, 4), (5, 5), (6, 8),
    ]
    names += [f"bior{a}.{b}" for a, b in pairs]
    names += [f"rbio{a}.{b}" for a, b in pairs]
    return names


def dwt_max_level(data_len: int, filter_len: int) -> int:
    """Max useful decomposition level (pywt.dwt_max_level semantics)."""
    if filter_len <= 1 or data_len < filter_len - 1:
        return 0
    return int(math.floor(math.log2(data_len / (filter_len - 1.0))))


def dwt_coeff_len(data_len: int, filter_len: int, mode: str = "reflect") -> int:
    """Output length of a single-level DWT (pywt.dwt_coeff_len semantics)."""
    if data_len < 1:
        raise ValueError("data_len must be >= 1")
    if mode == "periodization":
        return (data_len + 1) // 2
    return (data_len + filter_len - 1) // 2
