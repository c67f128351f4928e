"""Bridges between the JAX package's settings and results and the port's.

``from_reference`` reads a ``spiht_tpu`` ``SpihtSettings`` or
``EncodingResult`` through ``dataclasses.asdict`` / ``to_dict``, duck-typed,
without importing ``spiht_tpu``, so a stream encoded by either package
decodes in the other and both packages can be fed the same settings.
(The port's own objects carry the same fields, so the JAX package reads
them as they are.) ``as_numpy_image`` turns a torch, JAX or numpy image
into numpy, duck-typed on the object's module, without importing JAX.
(``jax_to_torch`` and ``torch_to_jax`` are not ported: they need JAX.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .settings import EncodingResult, SpihtSettings

__all__ = ["as_numpy_image", "from_reference"]


def from_reference(obj):
    """The port's ``SpihtSettings`` or ``EncodingResult`` equal to ``obj``,
    a settings or result object of either package."""
    if hasattr(obj, "to_dict") and hasattr(obj, "encoded_bytes"):
        return EncodingResult.from_dict(obj.to_dict())
    if dataclasses.is_dataclass(obj) and hasattr(obj, "wavelet"):
        return SpihtSettings(**dataclasses.asdict(obj))
    raise TypeError(
        f"not a SpihtSettings or EncodingResult: {type(obj).__name__}"
    )


def _is_torch(x) -> bool:
    mod = type(x).__module__
    return mod == "torch" or mod.startswith("torch.")


def as_numpy_image(image) -> np.ndarray:
    """Any (C,H,W) image-like (numpy / torch.Tensor / jax.Array) -> numpy.

    Zero-copy when the buffer is already host memory; detaches torch
    tensors from autograd and moves them off-device if needed. A JAX
    array goes through its ``__array__`` (``np.asarray``).
    """
    if _is_torch(image):
        image = image.detach()
        if image.device.type != "cpu":
            image = image.cpu()
        return image.numpy()
    return np.asarray(image)
