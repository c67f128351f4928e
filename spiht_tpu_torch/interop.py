"""Bridges between the JAX package's settings and results and the port's.

``from_reference`` reads a ``spiht_tpu`` ``SpihtSettings`` or
``EncodingResult`` through ``dataclasses.asdict`` / ``to_dict``, duck-typed,
without importing ``spiht_tpu``, so a stream encoded by either package
decodes in the other and both packages can be fed the same settings.
(The port's own objects carry the same fields, so the JAX package reads
them as they are.)
"""

from __future__ import annotations

import dataclasses

from .settings import EncodingResult, SpihtSettings

__all__ = ["from_reference"]


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
