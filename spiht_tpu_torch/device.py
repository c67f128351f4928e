"""Which device an entry point runs on, and whether a routed entry point
runs its hand-written kernel there."""

from __future__ import annotations

import os

import torch

__all__ = ["cuda_devices", "resolve_device", "use_kernel"]


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
