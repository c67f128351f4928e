"""Codec settings and encoding-result containers.

Copy of ``spiht_tpu/settings.py``, kept identical (tests/test_torch_copies.py).

Field-for-field compatible with the reference public contract
(reference: spiht/spiht_wrapper.py:20-89): ``SpihtSettings`` is the
out-of-band pre-shared configuration (never serialized into the stream)
and ``EncodingResult`` carries the per-image framing (h, w, c, max_n,
level, version) alongside the raw bytes.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import List, Optional

ENCODER_DECODER_VERSION = "0.0.2"


@dataclass
class SpihtSettings:
    """Parameters of the codec that are not particular to a single image.

    If these settings are pre-agreed upon, they don't need to be stored when
    encoding images (reference: spiht/spiht_wrapper.py:26-29).

    wavelet: wavelet filter bank name; default 'bior2.2' (CDF 5/3).
    quantization_scale: DWT coeffs are multiplied by this before the integer
        cast. Default 50 works with little perceptual loss for RGB pixels.
    mode: signal extension mode for the DWT; default 'reflect'.
    color_model: optional color space used to encode the image (e.g. 'ipt').
    per_channel_quant_scales: optional per-channel multipliers applied before
        quantization. For natural images in IPT, [100, 20, 20] or [50, 15, 15]
        weight the I channel more heavily.
    """

    wavelet: str = "bior2.2"
    quantization_scale: float = 50.0
    mode: str = "reflect"
    color_model: Optional[str] = None
    per_channel_quant_scales: Optional[List[float]] = None


@dataclass
class EncodingResult:
    """Container for one encoded image.

    encoded_bytes: bytes produced by the SPIHT encoder (LSB-first packed).
    h / w / c: original image dimensions.
    max_n: starting bit-plane index used by the encoder.
    level: number of DWT decomposition levels (None = auto).
    """

    encoded_bytes: bytes
    h: int
    w: int
    c: int
    max_n: int
    level: Optional[int]
    _encoding_version: str = ENCODER_DECODER_VERSION

    def to_dict(self):
        return {f"encoding_result_{k}": v for k, v in asdict(self).items()}

    @staticmethod
    def from_dict(d):
        d = {
            k.removeprefix("encoding_result_"): v
            for k, v in d.items()
            if k.startswith("encoding_result_")
        }
        return EncodingResult(**d)
