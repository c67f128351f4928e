"""Demo: IPT color space + per-channel quantization, bpp sweep, the port
of ``examples/demonstrate.py``.

The reference's demonstrate.py flow (IPT, [100,20,20] channel scales,
q=1, bpp in {0.1, 0.5, 1.0}) on this framework. Writes the
reconstructions as PNGs and prints rate-distortion stats.

    python -m spiht_tpu_torch.examples.demonstrate IMAGE [OUTDIR] [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from .. import SpihtSettings, decode_image, encode_image
from ..metrics import encode_stats
from ..utils import imload, imsave


SETTINGS = SpihtSettings(
    color_model="ipt",
    per_channel_quant_scales=[100, 20, 20],
    quantization_scale=1.0,
)


def main(argv=None) -> list:
    """Returns, for each of the three bpp points, (EncodeStats,
    EncodingResult, reconstruction cropped to the even image)."""
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0].replace("\n", " "))
    p.add_argument("image")
    p.add_argument("outdir", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "spiht_demo"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    image = imload(args.image)
    c, h, w = image.shape
    # even dims, like the reference demo ("pywt only supports even
    # resolutions" for this flow — demonstrate.py:41-46)
    image = image[:, : h - h % 2, : w - w % 2]
    c, h, w = image.shape

    points = []
    for bpp in (0.1, 0.5, 1.0):
        t0 = time.perf_counter()
        er = encode_image(image, SETTINGS, max_bits=round(bpp * h * w),
                          device=args.device)
        t_enc = time.perf_counter() - t0
        rec = decode_image(er, SETTINGS, device=args.device)[..., :h, :w]
        st = encode_stats(image, er, t_enc, reconstruction=rec)
        print(st.to_json())
        out = os.path.join(args.outdir, f"rec_{bpp}.png")
        imsave(out, np.clip(rec, 0, 1))
        print(f"wrote {out}")
        points.append((st, er, rec))
    return points


if __name__ == "__main__":
    main()
