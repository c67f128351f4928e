"""The transforms' share of their memory roofline, %: the least time the
bytes an image's transform must move take at the card's HBM peak, over
``transform_ms``. Encode reads the float32 image once and writes the
int32 coefficients once; decode reads the int32 coefficients once and
writes the image, in the working dtype, once. The transforms are a few
flops a byte, far under the card's float64 ridge, so memory bounds them."""

from ..peaks import H100_SXM
from . import transform_ms


def read(records, direction):
    ms = transform_ms.read(records, direction)
    if ms is None:
        return None
    g = records.geometry
    moved = g["coeff_bytes"] + (g["image_in_bytes"] if direction.startswith(
        "enc") else g["image_out_bytes"])
    least_s = moved / H100_SXM["hbm_bytes_per_s"]
    return 100.0 * least_s / (ms / 1e3)
