"""Builds the CUDA kernels in ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). All
sources are compiled together, one ``nvcc`` process each, into
``spiht_tpu_torch/build/<hash>/``, where the hash covers every source, the
shared header and the flags: a changed source builds anew, an unchanged one
is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

__all__ = ["load", "build_all"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the log
)

_P = ctypes.c_void_p
_I = ctypes.c_int32
_I64 = ctypes.c_int64
# argtypes of each C entry point: every pointer and the stream are c_void_p
# (tests/test_torch_signatures.py holds them to the sources' declarations)
SIGNATURES = {
    "spiht_encode": {
        "spiht_encode_launch": [
            _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P,
            _P, _I, _P, _I, _P, _I, _P, _I, _P, _P,
        ],
        "spiht_encode_seq_launch": [
            _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I,
            _P, _I, _P, _I, _P, _I, _P, _I, _P, _P,
        ],
        "spiht_encode_batch_launch": [
            _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P,
            _P, _I, _P, _I, _P, _I, _P, _I, _P, _P,
        ],
    },
    "spiht_decode": {
        "spiht_decode_lsp_launch": [
            _P, _P, _P, _P, _P, _I, _P, _I, _I,
            _P, _I, _P, _I, _P, _P, _I, _P, _P,
        ],
        "spiht_decode_lsp_log_launch": [
            _P, _P, _P, _P, _P, _I, _P, _I, _I,
            _P, _I, _P, _I, _P, _P, _I, _P, _P, _P,
        ],
        "spiht_decode_seq_launch": [
            _P, _P, _P, _P, _P, _I, _P, _I, _I,
            _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P,
        ],
        "spiht_decode_seq_log_launch": [
            _P, _P, _P, _P, _P, _I, _P, _I, _I,
            _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P,
        ],
        "spiht_decode_batch_launch": [
            _I, _I, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I,
            _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P,
        ],
    },
    "spiht_quantize": {
        "spiht_quantize_compact_launch": [
            _P, _I64, ctypes.c_float, _P, _P, _P, _P, _P,
        ],
    },
    "spiht_synthesis": {
        "spiht_idwt_level_launch": [
            _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _I, _I, _I64, _P, _I, _I, _I, _P, _I, _I, _P,
        ],
        "spiht_ipt_inverse_launch": [
            _I, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P, _P, _P,
        ],
    },
    "spike_chains": {
        "spike_seq_launch": [_P, _I, _I, _I, _I, _P, _P, _P],
        "spike_table_launch": [_P, _I, _I, _I, _I, _P, _P],
        "spike_fire_launch": [_P, _I, _I, _I, _I, _P, _P],
        "spike_machine_launch": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    },
    "spike_blocks": {
        "spike_block_launch": [_P, _I, _I, _P, _P, _P, _P, _P],
        "spike_token_launch": [_P, _I, _I, _P, _P],
    },
}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from spiht_tpu_torch/csrc "
        "with the CUDA toolkit at first use"
    )


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD / _key() / f"lib{name}.so"


def build_all() -> tuple:
    """Compile every kernel library that is missing, all at once (one nvcc
    per source, started together). Returns (seconds, nvcc output)."""
    t0 = time.perf_counter()
    todo = [n for n in SIGNATURES if not _lib_path(n).exists()]
    if not todo:
        return 0.0, ""
    nvcc = _nvcc()
    out_dir = _lib_path(todo[0]).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed, logs = [], []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"{name}.cu:\n{log}")
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0, "\n".join(logs)


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built first if need be), with argtypes
    and restype set on each of its entry points."""
    if name not in SIGNATURES:
        raise KeyError(name)
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
