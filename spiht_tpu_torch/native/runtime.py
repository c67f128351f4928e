"""ctypes bindings + on-demand build of the native SPIHT scheduling kernel.

Copy of ``spiht_tpu/native/runtime.py`` (its ``_Kernel`` class is kept
identical, tests/test_torch_copies.py) with ``spiht_kernel.cpp`` and
``dwt_kernel.cpp`` copied beside it. Two changes: the library is compiled
with the same g++ flags into ``spiht_tpu_torch/build/`` (or the directory
``SPIHT_TPU_CACHE`` names, as in the original), under a name that covers
the sources and the flags, written to a temporary name and moved into
place (concurrent processes never load a half-written file); and
``load()`` raises where the original returns None: when the build or the
load fails, and when ``SPIHT_TPU_NO_NATIVE`` turns the scheduler off.
That switch is the original's truthiness test (any non-empty value, "0"
too), read at every call (``disabled()``), where the original reads it
only until a first load succeeds; the callers that have the original's
pure-Python route (``codec/api.py``'s host-scheduled batch codec, the
oracle; ``transform.py``'s native transforms, the numpy ones) ask
``disabled()`` first. All entry points release the GIL for the duration
of the C call, so Python-level thread pools get real parallelism on top
of the kernel's own batch threading.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "spiht_kernel.cpp", _HERE / "dwt_kernel.cpp"]
_BUILD = _HERE.parent / "build"
_LOCK = threading.Lock()
_LIB = None

# extension-mode ids shared with dwt_kernel.cpp (enum ExtMode)
_EXT_MODES = {
    "zero": 0,
    "constant": 1,
    "symmetric": 2,
    "reflect": 3,
    "periodic": 4,
    "smooth": 5,
    "antisymmetric": 6,
    "antireflect": 7,
}

c_i32_p = ctypes.POINTER(ctypes.c_int32)
c_i8_p = ctypes.POINTER(ctypes.c_int8)
c_u8_p = ctypes.POINTER(ctypes.c_uint8)
c_int_p = ctypes.POINTER(ctypes.c_int)

_GXX_FLAGS = (
    "-O3",
    "-march=native",
    # keep f64 arithmetic bit-compatible with the numpy reference: no
    # a*b+c -> fma() contraction (it changes rounding and can flip the
    # truncate-toward-zero quantization of borderline coefficients)
    "-ffp-contract=off",
    "-std=c++17",
    "-shared",
    "-fPIC",
)


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    cache = Path(os.environ.get("SPIHT_TPU_CACHE", _BUILD))
    return cache / f"libspiht_kernel-{h.hexdigest()[:16]}.so"


def _build(so_path: Path) -> None:
    """Compile into a temporary file beside ``so_path``, then move it
    into place; raises with g++'s output on failure."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so_path.parent)
    os.close(fd)
    cmd = ["g++", *_GXX_FLAGS, "-o", tmp, *map(str, _SRCS), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native kernel build failed:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _Kernel:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.spiht_encode.restype = ctypes.c_int
        lib.spiht_encode.argtypes = [
            c_i32_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            c_i8_p, c_i8_p, c_i8_p, ctypes.c_int,
            ctypes.POINTER(c_u8_p), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.spiht_decode.restype = ctypes.c_int
        lib.spiht_decode.argtypes = [
            c_u8_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_i32_p, ctypes.c_int, c_i32_p, c_i32_p, c_i32_p, ctypes.c_int,
        ]
        lib.spiht_free.restype = None
        lib.spiht_free.argtypes = [c_u8_p]
        lib.spiht_compute_maps.restype = None
        lib.spiht_compute_maps.argtypes = [
            c_i32_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, c_i8_p, c_i8_p, c_i8_p,
        ]
        lib.spiht_encode_batch.restype = ctypes.c_int
        lib.spiht_encode_batch.argtypes = [
            ctypes.POINTER(c_i32_p), ctypes.c_int, c_int_p, c_int_p, c_int_p,
            c_int_p, c_int_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(c_i8_p), ctypes.POINTER(c_i8_p),
            ctypes.POINTER(c_i8_p), c_int_p, ctypes.POINTER(c_u8_p),
            ctypes.POINTER(ctypes.c_longlong), c_int_p,
        ]
        lib.spiht_decode_batch.restype = ctypes.c_int
        lib.spiht_decode_batch.argtypes = [
            ctypes.POINTER(c_u8_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), c_int_p, c_int_p, c_int_p,
            c_int_p, c_int_p, c_int_p, ctypes.c_int, ctypes.POINTER(c_i32_p),
        ]
        c_f64_p = ctypes.POINTER(ctypes.c_double)
        c_i64_p = ctypes.POINTER(ctypes.c_longlong)
        lib.spiht_dwt_forward.restype = ctypes.c_int
        lib.spiht_dwt_forward.argtypes = [
            c_f64_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            c_f64_p, c_f64_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_f64_p, ctypes.c_double, c_i32_p, ctypes.c_longlong,
            ctypes.c_longlong, c_i64_p, c_i64_p,
        ]
        c_f32_p = ctypes.POINTER(ctypes.c_float)
        lib.spiht_dwt_forward_f32.restype = ctypes.c_int
        lib.spiht_dwt_forward_f32.argtypes = [
            c_f32_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            c_f64_p, c_f64_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_f64_p, ctypes.c_double, c_i32_p, ctypes.c_longlong,
            ctypes.c_longlong, c_i64_p, c_i64_p,
        ]
        lib.spiht_dwt_inverse.restype = ctypes.c_int
        lib.spiht_dwt_inverse.argtypes = [
            c_i32_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            c_f64_p, c_f64_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong,
            c_i64_p, c_i64_p, c_i64_p, c_i64_p,
            c_f64_p, ctypes.c_double, c_f64_p, ctypes.c_longlong,
            ctypes.c_longlong,
        ]
        lib.spiht_dwt_inverse_f32.restype = ctypes.c_int
        lib.spiht_dwt_inverse_f32.argtypes = [
            c_i32_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            c_f64_p, c_f64_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong,
            c_i64_p, c_i64_p, c_i64_p, c_i64_p,
            c_f64_p, ctypes.c_double, c_f32_p, ctypes.c_longlong,
            ctypes.c_longlong,
        ]

    # -- core ---------------------------------------------------------------
    def encode(
        self,
        arr: np.ndarray,
        ll_h: int,
        ll_w: int,
        max_bits: int,
        use_maps: bool = True,
        maps: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
        forced_max_n: int = -1,
    ) -> Tuple[bytes, int]:
        arr = np.ascontiguousarray(arr, dtype=np.int32)
        c, h, w = arr.shape
        out_data = c_u8_p()
        out_nbits = ctypes.c_longlong()
        out_max_n = ctypes.c_int()
        if maps is not None:
            M, D, G = (np.ascontiguousarray(m, dtype=np.int8) for m in maps)
            mp, dp, gp = (
                M.ctypes.data_as(c_i8_p),
                D.ctypes.data_as(c_i8_p),
                G.ctypes.data_as(c_i8_p),
            )
        else:
            mp = dp = gp = ctypes.cast(None, c_i8_p)
        # clamp the python-level "unbounded" sentinel into int64 range
        max_bits = min(int(max_bits), 2**62)
        rc = self._lib.spiht_encode(
            arr.ctypes.data_as(c_i32_p), c, h, w, ll_h, ll_w,
            max_bits, int(use_maps), mp, dp, gp, int(forced_max_n),
            ctypes.byref(out_data), ctypes.byref(out_nbits),
            ctypes.byref(out_max_n),
        )
        if rc != 0:
            raise ValueError(f"spiht_encode failed (rc={rc}); ll dims must be > 1")
        nbytes = (out_nbits.value + 7) // 8
        data = ctypes.string_at(out_data, nbytes)
        self._lib.spiht_free(out_data)
        return data, out_max_n.value

    def decode(
        self, data: bytes, n: int, c: int, h: int, w: int, ll_h: int, ll_w: int
    ) -> np.ndarray:
        rec = np.zeros((c, h, w), dtype=np.int32)
        buf = np.frombuffer(data, dtype=np.uint8)
        nullp = ctypes.cast(None, c_i32_p)
        rc = self._lib.spiht_decode(
            buf.ctypes.data_as(c_u8_p), len(data) * 8, n, c, h, w, ll_h, ll_w,
            rec.ctypes.data_as(c_i32_p), 0, nullp, nullp, nullp, 0,
        )
        if rc != 0:
            raise ValueError(f"spiht_decode failed (rc={rc})")
        return rec

    def decode_with_metadata(
        self, data: bytes, n: int, c: int, h: int, w: int, ll_h: int,
        ll_w: int, top_slice, other_slices,
    ) -> Tuple[np.ndarray, np.ndarray]:
        rec = np.zeros((c, h, w), dtype=np.int32)
        nbits = len(data) * 8
        meta = np.zeros((nbits + 1, 8), dtype=np.int32)
        top = np.array([top_slice[0][1], top_slice[1][1]], dtype=np.int32)
        level = len(other_slices)
        other = np.zeros((level, 3, 2, 2), dtype=np.int32)
        for li, filters in enumerate(other_slices):
            for fi, rect in enumerate(filters):
                other[li, fi, 0] = rect[0]
                other[li, fi, 1] = rect[1]
        buf = np.frombuffer(data, dtype=np.uint8)
        rc = self._lib.spiht_decode(
            buf.ctypes.data_as(c_u8_p), nbits, n, c, h, w, ll_h, ll_w,
            rec.ctypes.data_as(c_i32_p), 1, meta.ctypes.data_as(c_i32_p),
            top.ctypes.data_as(c_i32_p), other.ctypes.data_as(c_i32_p), level,
        )
        if rc != 0:
            raise ValueError(f"spiht_decode failed (rc={rc})")
        return rec, meta

    def encode_batch(
        self,
        arrs,
        ll_hs,
        ll_ws,
        max_bits,
        use_maps: bool = True,
        maps=None,
        nthreads: int = 0,
        forced_max_ns=None,
    ):
        """Encode a batch of (C,H,W) i32 arrays in parallel native threads.

        arrs: sequence of arrays (shapes may differ). maps: optional
        sequence of (M, D, G) int8 triples, e.g. computed on TPU.
        Returns list of (bytes, max_n).
        """
        batch = len(arrs)
        arrs = [np.ascontiguousarray(a, dtype=np.int32) for a in arrs]
        cs = np.array([a.shape[0] for a in arrs], dtype=np.int32)
        hs = np.array([a.shape[1] for a in arrs], dtype=np.int32)
        ws = np.array([a.shape[2] for a in arrs], dtype=np.int32)
        ll_hs = np.asarray(ll_hs, dtype=np.int32)
        ll_ws = np.asarray(ll_ws, dtype=np.int32)
        mb = np.array(
            [min(int(m), 2**62) for m in max_bits], dtype=np.int64
        )
        arr_ptrs = (c_i32_p * batch)(
            *[a.ctypes.data_as(c_i32_p) for a in arrs]
        )
        if maps is not None:
            maps = [
                tuple(np.ascontiguousarray(m, dtype=np.int8) for m in t)
                for t in maps
            ]
            mptr = (c_i8_p * batch)(*[t[0].ctypes.data_as(c_i8_p) for t in maps])
            dptr = (c_i8_p * batch)(*[t[1].ctypes.data_as(c_i8_p) for t in maps])
            gptr = (c_i8_p * batch)(*[t[2].ctypes.data_as(c_i8_p) for t in maps])
        else:
            mptr = dptr = gptr = ctypes.cast(None, ctypes.POINTER(c_i8_p))
        out_datas = (c_u8_p * batch)()
        out_nbits = (ctypes.c_longlong * batch)()
        out_max_ns = (ctypes.c_int * batch)()
        if forced_max_ns is not None:
            fmn = np.asarray(forced_max_ns, dtype=np.int32)
            fmn_p = fmn.ctypes.data_as(c_int_p)
        else:
            fmn_p = ctypes.cast(None, c_int_p)
        rc = self._lib.spiht_encode_batch(
            arr_ptrs, batch,
            cs.ctypes.data_as(c_int_p), hs.ctypes.data_as(c_int_p),
            ws.ctypes.data_as(c_int_p), ll_hs.ctypes.data_as(c_int_p),
            ll_ws.ctypes.data_as(c_int_p),
            mb.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            int(use_maps), int(nthreads), mptr, dptr, gptr, fmn_p,
            out_datas, out_nbits, out_max_ns,
        )
        if rc != 0:
            raise ValueError(f"spiht_encode_batch failed (rc={rc})")
        out = []
        for t in range(batch):
            nbytes = (out_nbits[t] + 7) // 8
            out.append((ctypes.string_at(out_datas[t], nbytes), out_max_ns[t]))
            self._lib.spiht_free(out_datas[t])
        return out

    def decode_batch(self, datas, ns, cs, hs, ws, ll_hs, ll_ws, nthreads=0):
        """Decode a batch of byte streams in parallel native threads."""
        batch = len(datas)
        bufs = [np.frombuffer(d, dtype=np.uint8) for d in datas]
        recs = [
            np.zeros((cs[t], hs[t], ws[t]), dtype=np.int32)
            for t in range(batch)
        ]
        data_ptrs = (c_u8_p * batch)(
            *[b.ctypes.data_as(c_u8_p) for b in bufs]
        )
        nbits = (ctypes.c_longlong * batch)(*[len(d) * 8 for d in datas])
        rec_ptrs = (c_i32_p * batch)(
            *[r.ctypes.data_as(c_i32_p) for r in recs]
        )
        mk = lambda v: np.asarray(v, dtype=np.int32)
        ns, cs, hs, ws, ll_hs, ll_ws = map(mk, (ns, cs, hs, ws, ll_hs, ll_ws))
        rc = self._lib.spiht_decode_batch(
            data_ptrs, batch, nbits,
            ns.ctypes.data_as(c_int_p), cs.ctypes.data_as(c_int_p),
            hs.ctypes.data_as(c_int_p), ws.ctypes.data_as(c_int_p),
            ll_hs.ctypes.data_as(c_int_p), ll_ws.ctypes.data_as(c_int_p),
            int(nthreads), rec_ptrs,
        )
        if rc != 0:
            raise ValueError(f"spiht_decode_batch failed (rc={rc})")
        return recs

    def dwt_forward(
        self,
        image: np.ndarray,
        dec_lo,
        dec_hi,
        mode: str,
        levels: int,
        ph: int,
        pw: int,
        chan_scales=None,
        q_scale: float = 1.0,
        precision: str = "f64",
    ):
        """Native multilevel 2D DWT + quantization of a (C,H,W) image.

        precision 'f64' (default) is bit-compatible with the numpy
        reference; 'f32' is the ~2x speed mode (borderline quantization
        truncations may differ; PSNR impact nil). Returns (arr_i32 of
        shape (C, ph, pw), ll_h, ll_w).
        """
        if mode not in _EXT_MODES:
            raise ValueError(f"unsupported mode {mode!r}")
        lo = np.ascontiguousarray(dec_lo, dtype=np.float64)
        hi = np.ascontiguousarray(dec_hi, dtype=np.float64)
        out = None
        c_f64_p = ctypes.POINTER(ctypes.c_double)
        if chan_scales is not None:
            cs = np.ascontiguousarray(chan_scales, dtype=np.float64)
            cs_p = cs.ctypes.data_as(c_f64_p)
        else:
            cs_p = ctypes.cast(None, c_f64_p)
        ll_h = ctypes.c_longlong()
        ll_w = ctypes.c_longlong()
        if precision == "f32":
            image = np.ascontiguousarray(image, dtype=np.float32)
            C, h, w = image.shape
            out = np.empty((C, ph, pw), dtype=np.int32)
            rc = self._lib.spiht_dwt_forward_f32(
                image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                C, h, w,
                lo.ctypes.data_as(c_f64_p), hi.ctypes.data_as(c_f64_p),
                len(lo), _EXT_MODES[mode], levels, cs_p, float(q_scale),
                out.ctypes.data_as(c_i32_p), ph, pw,
                ctypes.byref(ll_h), ctypes.byref(ll_w),
            )
        else:
            image = np.ascontiguousarray(image, dtype=np.float64)
            C, h, w = image.shape
            out = np.empty((C, ph, pw), dtype=np.int32)
            rc = self._lib.spiht_dwt_forward(
                image.ctypes.data_as(c_f64_p), C, h, w,
                lo.ctypes.data_as(c_f64_p), hi.ctypes.data_as(c_f64_p),
                len(lo), _EXT_MODES[mode], levels, cs_p, float(q_scale),
                out.ctypes.data_as(c_i32_p), ph, pw,
                ctypes.byref(ll_h), ctypes.byref(ll_w),
            )
        if rc != 0:
            raise ValueError(f"spiht_dwt_forward failed (rc={rc})")
        return out, ll_h.value, ll_w.value

    def dwt_inverse(
        self,
        arr: np.ndarray,
        rec_lo,
        rec_hi,
        levels: int,
        ll_h: int,
        ll_w: int,
        lvl_rects,
        out_h: int,
        out_w: int,
        chan_scales=None,
        q_scale: float = 1.0,
        precision: str = "f64",
    ) -> np.ndarray:
        """Native dequantize + multilevel 2D inverse DWT ('f64' | 'f32').

        lvl_rects: per level coarse->fine, tuples (start_h, start_w, dh, dw)
        of the dd-block geometry in the packed array.
        """
        arr = np.ascontiguousarray(arr, dtype=np.int32)
        C, ph, pw = arr.shape
        lo = np.ascontiguousarray(rec_lo, dtype=np.float64)
        hi = np.ascontiguousarray(rec_hi, dtype=np.float64)
        sh = np.array([r[0] for r in lvl_rects], dtype=np.int64)
        sw = np.array([r[1] for r in lvl_rects], dtype=np.int64)
        dh = np.array([r[2] for r in lvl_rects], dtype=np.int64)
        dw = np.array([r[3] for r in lvl_rects], dtype=np.int64)
        c_f64_p = ctypes.POINTER(ctypes.c_double)
        c_i64_p = ctypes.POINTER(ctypes.c_longlong)
        if chan_scales is not None:
            cs = np.ascontiguousarray(chan_scales, dtype=np.float64)
            cs_p = cs.ctypes.data_as(c_f64_p)
        else:
            cs_p = ctypes.cast(None, c_f64_p)
        if precision == "f32":
            out = np.empty((C, out_h, out_w), dtype=np.float32)
            fn = self._lib.spiht_dwt_inverse_f32
            out_p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        else:
            out = np.empty((C, out_h, out_w), dtype=np.float64)
            fn = self._lib.spiht_dwt_inverse
            out_p = out.ctypes.data_as(c_f64_p)
        rc = fn(
            arr.ctypes.data_as(c_i32_p), C, ph, pw,
            lo.ctypes.data_as(c_f64_p), hi.ctypes.data_as(c_f64_p),
            len(lo), levels, ll_h, ll_w,
            sh.ctypes.data_as(c_i64_p), sw.ctypes.data_as(c_i64_p),
            dh.ctypes.data_as(c_i64_p), dw.ctypes.data_as(c_i64_p),
            cs_p, float(q_scale),
            out_p, out_h, out_w,
        )
        if rc != 0:
            raise ValueError(f"spiht_dwt_inverse failed (rc={rc})")
        return out

    def compute_maps(self, arr: np.ndarray, ll_h: int, ll_w: int):
        arr = np.ascontiguousarray(arr, dtype=np.int32)
        c, h, w = arr.shape
        M = np.empty((c, h, w), dtype=np.int8)
        D = np.empty((c, h, w), dtype=np.int8)
        G = np.empty((c, h, w), dtype=np.int8)
        self._lib.spiht_compute_maps(
            arr.ctypes.data_as(c_i32_p), c, h, w, ll_h, ll_w,
            M.ctypes.data_as(c_i8_p), D.ctypes.data_as(c_i8_p),
            G.ctypes.data_as(c_i8_p),
        )
        return M, D, G


def disabled() -> bool:
    """Whether ``SPIHT_TPU_NO_NATIVE`` turns the native scheduler off."""
    return bool(os.environ.get("SPIHT_TPU_NO_NATIVE"))


def load() -> _Kernel:
    """Load (building if needed) the native kernel; raises if it cannot be
    built or loaded, or if ``SPIHT_TPU_NO_NATIVE`` is set."""
    global _LIB
    if disabled():
        raise RuntimeError(
            "SPIHT_TPU_NO_NATIVE is set: the native scheduler is off, and "
            "this caller has no route without it"
        )
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = _so_path()
            if not so.exists():
                _build(so)
            _LIB = _Kernel(ctypes.CDLL(str(so)))
        return _LIB
