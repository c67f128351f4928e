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
``encode_images_device`` / ``decode_images_device``; the host-shaped API
(``encode`` / ``decode`` / ``decode_with_metadata``, ``encode_image`` /
``decode_image`` with the metadata trace, ``decode_rec_array`` /
``decode_from_rec_arr``); and the host-scheduled batch codec
``encode_images`` / ``decode_images`` over the native C++ scheduler
(``native/``, built with g++ at first use); every colour model of the JAX
package (``color/torch_models.py``); the numpy, native and torch
transform backends behind the host-shaped API (``transform.py``,
``SPIHT_TPU_TRANSFORM``); ``metrics``, ``utils`` and the command line
(``python -m spiht_tpu_torch.cli``).
"""

from . import interop
from .codec.api import (
    decode,
    decode_from_rec_arr,
    decode_image,
    decode_image_device,
    decode_images,
    decode_images_device,
    decode_rec_array,
    decode_with_metadata,
    encode,
    encode_image,
    encode_image_device,
    encode_images,
    encode_images_device,
)
from .settings import ENCODER_DECODER_VERSION, EncodingResult, SpihtSettings
from .wavelets.geometry import get_slices_and_h_w

__all__ = [
    "ENCODER_DECODER_VERSION",
    "EncodingResult",
    "SpihtSettings",
    "decode",
    "decode_from_rec_arr",
    "decode_image",
    "decode_image_device",
    "decode_images",
    "decode_images_device",
    "decode_rec_array",
    "decode_with_metadata",
    "encode",
    "encode_image",
    "encode_image_device",
    "encode_images",
    "encode_images_device",
    "get_slices_and_h_w",
    "interop",
]

__version__ = "0.1.0"
