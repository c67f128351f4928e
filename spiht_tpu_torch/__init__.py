"""spiht_tpu_torch: the SPIHT codec in PyTorch, with hand-written CUDA
kernels for its bit machines (NVIDIA Hopper, sm_90a).

The port of ``spiht_tpu`` (JAX on a TPU), which stays beside it as the
reference: same wire format, byte-identical streams at equal settings.
This package imports torch and numpy only. Its entry points run on the
CUDA card unless the caller passes ``device="cpu"``, which runs the
kernels' plain versions; the kernels are built with ``nvcc`` at first use
(``_build.py``).

Ported so far: the single-image on-device round trip,
``encode_image_device`` / ``decode_image_device``, and the batched one,
``encode_images_device`` / ``decode_images_device``.
"""

from . import interop
from .codec.api import (
    decode_image_device,
    decode_images_device,
    encode_image_device,
    encode_images_device,
)
from .settings import ENCODER_DECODER_VERSION, EncodingResult, SpihtSettings

__all__ = [
    "ENCODER_DECODER_VERSION",
    "EncodingResult",
    "SpihtSettings",
    "decode_image_device",
    "decode_images_device",
    "encode_image_device",
    "encode_images_device",
    "interop",
]

__version__ = "0.1.0"
