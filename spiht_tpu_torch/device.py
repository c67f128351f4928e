"""Which device an entry point runs on, whether a routed entry point
runs its hand-written kernel there, and the cache of small constant
tensors that the pipelines keep on the device.

``constant`` makes a function that builds a constant tensor (an index map,
a vector of scales, a threshold table) into an ``lru_cache`` keyed by its
arguments: the value's key, and the dtype and device where they matter. A
pipeline then copies such a tensor to the card once, not on every call,
and a CUDA graph can read it. A graph keeps raw pointers, not tensors: a
program opens ``holding()`` while it warms up and captures, and keeps the
list it gets, so an entry the cache evicts later stays alive as long as
the graph that reads it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch

__all__ = [
    "cuda_devices", "resolve_device", "use_kernel", "constant", "keep",
    "holding",
]

# entries of each constant's cache; a pipeline reads a few dozen
CONSTANTS = 256

# each thread's open ``holding()`` lists
_HOLDERS = threading.local()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Without one, raise: the port never
    falls back to the CPU on its own; a caller who wants the plain
    versions on the CPU passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: spiht_tpu_torch runs on the card; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def cuda_devices() -> list:
    """Every CUDA device, the default of the device lists in
    ``parallel``; without a card, raise (``resolve_device``'s rule)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def use_kernel(flag: str, dev: torch.device) -> bool:
    """The JAX package's routing flags (``SPIHT_TPU_PALLAS_ENCODER``,
    ``_DECODER``, ``_META``): set, "1" runs the hand-written kernel (its
    plain version on CPU tensors) and any other value the fallback
    machine; unset, the kernel runs on the card and the machine on the
    CPU, as the JAX package keeps the machines on its CPU."""
    v = os.environ.get(flag)
    if v is not None:
        return v == "1"
    return dev.type == "cuda"


def keep(obj):
    """``obj``, appended to every open ``holding()`` list."""
    for held in getattr(_HOLDERS, "lists", ()):
        held.append(obj)
    return obj


@contextlib.contextmanager
def holding():
    """Collects every constant (and every object passed to ``keep``) that
    this thread looks up inside the block, into the list it yields."""
    held: list = []
    if not hasattr(_HOLDERS, "lists"):
        _HOLDERS.lists = []
    _HOLDERS.lists.append(held)
    try:
        yield held
    finally:
        _HOLDERS.lists.pop()


def constant(make):
    """``make`` (hashable arguments -> a tensor) behind an ``lru_cache`` of
    ``CONSTANTS`` entries; each tensor it returns is also ``keep``-ed."""
    cached = functools.lru_cache(maxsize=CONSTANTS)(make)

    @functools.wraps(make)
    def get(*key):
        return keep(cached(*key))

    get.cache_info = cached.cache_info
    get.cache_clear = cached.cache_clear
    return get
