"""End-to-end ON-DEVICE codec demo, the port of
``examples/on_device_codec.py``: image -> stream -> image, nothing but the
stream's bit count and the final preview crossing the host boundary.

This is the serving shape the fused pipelines exist for
(``torch_transform.encode_pipeline_fn`` / ``decode_pipeline_fn``, each
one cached program a key: a CUDA graph on the card): a
model producing images on the card hands them to the encoder (kernel B1)
without a host round-trip, and a consumer model reads decoded images
(kernel B2, or B3 at odd LL) straight from device memory. Reference flow
being mirrored: CS1+CS2 (spiht/spiht_wrapper.py:142-281), re-architected
as device-resident pipelines.

    python -m spiht_tpu_torch.examples.on_device_codec IMAGE [BPP] [--device DEV]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import SpihtSettings, torch_transform
from ..codec.encoder import check_stat
from ..device import resolve_device
from ..utils import imload


SETTINGS = SpihtSettings()
LEVEL = 6


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Returns the PSNR of the preview against the source in dB
    (``psnr_db``), the stream as it lies on the device (``words``,
    ``bits``, ``max_n``) and the uint8 preview there (``rec``)."""
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0].replace("\n", " "))
    p.add_argument("image")
    p.add_argument("bpp", nargs="?", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    image = imload(args.image)
    c, h, w = image.shape
    level, settings = LEVEL, SETTINGS
    max_bits = round(args.bpp * h * w)

    # ---- encode: image in device memory -> stream words there ----
    efn = torch_transform.encode_pipeline_fn(settings, level,
                                             dtype=torch.float32)
    im = torch.as_tensor(image, dtype=torch.float32).to(dev)
    t0 = time.perf_counter()
    words, stat, max_n = efn(im, max_bits)
    _sync(dev)
    t_enc = time.perf_counter() - t0
    total = check_stat(stat, "spiht_encode")[0]
    print(f"encoded {c}x{h}x{w} -> {total} bits "
          f"({total/(h*w):.3f} bpp) in {t_enc*1e3:.0f} ms "
          f"[device={dev}; the first call includes the program's warm-up "
          f"and capture]")

    # ---- decode: stream words on the device -> image there ----
    dfn = torch_transform.decode_pipeline_fn(
        settings, h, w, level, c, dtype=torch.float32, as_uint8=True,
    )
    t0 = time.perf_counter()
    rec = dfn(words, total, int(max_n))  # words never left the device
    _sync(dev)
    t_dec = time.perf_counter() - t0
    print(f"decoded on device in {t_dec*1e3:.0f} ms; "
          f"uint8 image shape {tuple(rec.shape)} stays on {rec.device}")

    # only now pull the preview to host
    rec_h = rec.cpu().numpy()[..., :h, :w].astype(np.float64) / 255.0
    mse = float(np.mean((rec_h - image) ** 2))
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    print(f"PSNR vs source: {psnr:.2f} dB at {args.bpp} bpp")
    return {"psnr_db": psnr, "words": words, "bits": total,
            "max_n": int(max_n), "rec": rec}


if __name__ == "__main__":
    main()
