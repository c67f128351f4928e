"""Which device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
