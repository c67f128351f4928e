"""Subband geometry: packed-array slices for the wavedec2 layout.

Copy of ``spiht_tpu/wavelets/geometry.py``, kept identical (tests/test_torch_copies.py).

Mirrors the reference's slice computation (spiht/spiht_wrapper.py:92-139):
given the original image size and settings, produce the same slices that
``coeffs_to_array`` uses, plus the packed array dims (enc_h, enc_w) — which
can exceed ceil(h/2**level)*2**level-style dims for boundary-padded DWTs.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .filters import build_wavelet
from .ref_dwt import wavedecn_shapes

__all__ = ["get_slices_and_h_w", "slices_to_wire"]


def get_slices_and_h_w(
    h: int, w: int, settings, level: Optional[int]
) -> Tuple[List[Any], int, int]:
    """Slices identical to the wavedec2 coeffs_to_array layout.

    Returns (slices, enc_h, enc_w). ``slices[0]`` is the LL tuple
    (slice(None), slice(ll_h), slice(ll_w)); subsequent entries are dicts
    with 'ad', 'da', 'dd' rect slices, coarse -> fine.
    """
    shapes = wavedecn_shapes(
        (1, h, w),
        wavelet=settings.wavelet,
        mode=settings.mode,
        level=level,
        axes=(-2, -1),
    )
    *_, start_h, start_w = shapes[0]

    slices: List[Any] = [(slice(None), slice(start_h), slice(start_w))]
    for shape in shapes[1:]:
        shape_ad = shape["ad"]
        shape_da = shape["da"]
        shape_dd = shape["dd"]
        slices.append(
            {
                "ad": (
                    slice(None),
                    slice(0, shape_ad[1]),
                    slice(start_w, start_w + shape_ad[2]),
                ),
                "da": (
                    slice(None),
                    slice(start_h, start_h + shape_da[1]),
                    slice(0, shape_da[2]),
                ),
                "dd": (
                    slice(None),
                    slice(start_h, start_h + shape_dd[1]),
                    slice(start_w, start_w + shape_dd[2]),
                ),
            }
        )
        start_h += shape["dd"][1]
        start_w += shape["dd"][2]

    return slices, start_h, start_w


def slices_to_wire(slices) -> Tuple[list, list]:
    """Convert slices to the (top_slice, other_slices) wire format consumed
    by the metadata decoder (reference: spiht/spiht_wrapper.py:232-248).

    Per-level filter order is [da, ad, dd] — the order the reference passes
    across the FFI boundary.
    """
    top_slice = [
        (slices[0][1].start or 0, slices[0][1].stop),
        (slices[0][2].start or 0, slices[0][2].stop),
    ]
    other_slices = []
    for slice_level in slices[1:]:
        slice_filters = []
        for key in ("da", "ad", "dd"):
            s = slice_level[key]
            slice_filters.append(
                [(s[1].start, s[1].stop), (s[2].start, s[2].stop)]
            )
        other_slices.append(slice_filters)
    return top_slice, other_slices
