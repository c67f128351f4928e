"""The JAX package's native library, loaded for sure, for the port's tests
that hold the port's native paths to it.

``spiht_tpu/native/runtime.py`` compiles ``libspiht_kernel.so`` in place
(``_build``), and ``load()`` gives up for the life of the process on any
failure (``_LOAD_FAILED``). When several test processes start it at once
on a fresh checkout, one of them can load a half-written file; from then
on its ``native`` transform runs numpy and its order prototype raises.
``load()`` here builds the library under a file lock into a temporary
name, renames it into place and loads it again, so a test never compares
the port's native path with the reference's numpy fallback: it raises if
the library still does not load.

Import it by path: ``load_helper()`` in the test files."""

from __future__ import annotations

import fcntl
import os

from spiht_tpu.native import runtime


def load():
    """The reference's loaded native kernel (``runtime._Kernel``)."""
    lib = runtime.load()
    if lib is not None:
        return lib
    if os.environ.get("SPIHT_TPU_NO_NATIVE"):
        raise RuntimeError("SPIHT_TPU_NO_NATIVE is set: no reference kernel")
    so = runtime._so_path()
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # another process may have built it while this one waited
        runtime._LOAD_FAILED = False
        lib = runtime.load()
        if lib is None:
            tmp = f"{so[:-3]}.{os.getpid()}.tmp.so"
            try:
                runtime._build(tmp)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            runtime._LOAD_FAILED = False
            lib = runtime.load()
    if lib is None:
        raise RuntimeError(f"the reference's native kernel does not load: {so}")
    return lib
