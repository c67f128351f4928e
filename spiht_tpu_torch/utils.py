"""Image IO and small helpers.

Copy of ``spiht_tpu/utils.py``, kept identical (tests/test_torch_copies.py).
PIL and matplotlib are imported inside the functions that need them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bytes_to_bits", "imload", "imsave", "scale_0_1", "imshow"]


def bytes_to_bits(spiht_bytes: bytes) -> np.ndarray:
    """Unpack bytes LSB-first into a {0,1} uint8 array."""
    np_bytes = np.frombuffer(spiht_bytes, np.uint8)
    return np.unpackbits(np_bytes, bitorder="little")


def imload(path) -> np.ndarray:
    """Load an image file to a float (C,H,W) array in [0,1]."""
    from PIL import Image

    im = np.asarray(Image.open(path))
    if im.ndim > 2:
        im = np.moveaxis(im, -1, 0)
    else:
        im = im[None, :, :]
    return im / 255


def imsave(path, im: np.ndarray) -> None:
    """Save a float (C,H,W) array in [0,1] as an 8-bit image file."""
    from PIL import Image

    arr = np.clip(np.asarray(im), 0.0, 1.0)
    arr = (arr * 255).astype(np.uint8)
    if arr.shape[0] == 1:
        Image.fromarray(arr[0]).save(path)
    else:
        Image.fromarray(np.moveaxis(arr, 0, -1)).save(path)


def scale_0_1(x: np.ndarray) -> np.ndarray:
    """Min-max scale per channel over the spatial dims."""
    x = np.asarray(x)
    mn = x.min(axis=(-2, -1), keepdims=True)
    mx = x.max(axis=(-2, -1), keepdims=True)
    return (x - mn) / (mx - mn)


def imshow(x, ax=None, scale=False):
    """Display a (C,H,W) image with matplotlib (interactive use only)."""
    import matplotlib.pyplot as plt

    x = np.asarray(x)
    if x.ndim > 2:
        x = np.moveaxis(x, 0, -1)
    if scale:
        x = scale_0_1(x)
    if ax is None:
        plt.imshow(x)
        plt.axis("off")
        plt.show()
    else:
        ax.axis("off")
        ax.tick_params(axis="both", which="both", bottom=False, top=False, labelbottom=False)
        ax.imshow(x)
