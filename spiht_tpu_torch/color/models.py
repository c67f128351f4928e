"""Colour-model constants, copied from ``spiht_tpu/color/models.py``.

Only the constants that the ported conversions use (RGB <-> IPT, the
README's configuration), with the same derivations, so the matrices are
bit-identical (tests/test_torch_copies.py). 'RGB' is the working RGB space
with sRGB/D65 primaries, fed as-is (no CCTF step), as in the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "RGB_TO_XYZ",
    "XYZ_TO_RGB",
    "XYZ_TO_LMS_IPT",
    "LMS_TO_IPT",
    "LMS_FROM_IPT",
    "XYZ_FROM_LMS_IPT",
    "IPT_EXP",
]

# sRGB (D65) primaries -> XYZ, full-precision derivation
RGB_TO_XYZ = np.array(
    [
        [0.4123907992659595, 0.35758433938387796, 0.18048078840183429],
        [0.21263900587151036, 0.7151686787677559, 0.07219231536073371],
        [0.01933081871559185, 0.11919477979462599, 0.9505321522496607],
    ]
)
XYZ_TO_RGB = np.linalg.inv(RGB_TO_XYZ)

# IPT (Ebner & Fairchild 1998): XYZ(D65) -> LMS -> LMS' (power 0.43) -> IPT
XYZ_TO_LMS_IPT = np.array(
    [
        [0.4002, 0.7075, -0.0807],
        [-0.2280, 1.1500, 0.0612],
        [0.0000, 0.0000, 0.9184],
    ]
)
LMS_TO_IPT = np.array(
    [
        [0.4000, 0.4000, 0.2000],
        [4.4550, -4.8510, 0.3960],
        [0.8056, 0.3572, -1.1628],
    ]
)
LMS_FROM_IPT = np.linalg.inv(LMS_TO_IPT)
XYZ_FROM_LMS_IPT = np.linalg.inv(XYZ_TO_LMS_IPT)
IPT_EXP = 0.43
