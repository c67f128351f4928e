"""Seeded images with the statistics of natural photographs.

A natural image's amplitude spectrum falls as 1/f (Field 1987; van der
Schaaf & van Hateren 1996), its colour channels are strongly correlated
(most of the energy in luminance), and a camera adds a little white
noise. Each image here is that: Gaussian noise shaped to 1/f in the
frequency domain, a luminance field shared by the three channels plus two
weaker chroma fields, a sensor noise of 1% of the range, scaled to a mean
of 0.45 and a standard deviation of 0.18, clipped to [0, 1] and handed
over as host float32 (C, H, W) arrays, as an image decoder hands them to
a pipeline. The fields are made on the device in a few whole-batch calls
from a generator seeded with ``seed``: the same seed gives the same
images on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

# a channel's share of the luminance field and of each chroma field
_MIX = ((1.0, 0.30, 0.10), (1.0, -0.15, 0.05), (1.0, -0.10, -0.35))
# images made in one call: enough to keep the calls few, few enough to
# keep a 3x2160x3840 field and its spectrum within a few hundred MB
_CHUNK = 8


def _fields(n: int, h: int, w: int, gen: torch.Generator, dev) -> torch.Tensor:
    """(n, 3, h, w) fields with a 1/f amplitude spectrum, unit variance."""
    noise = torch.randn((n, 3, h, w), generator=gen, device=dev)
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.rfftfreq(w, device=dev)[None, :]
    f = torch.sqrt(fy * fy + fx * fx).clamp(min=1.0 / max(h, w))
    x = torch.fft.irfft2(torch.fft.rfft2(noise) / f, s=(h, w))
    return x / x.std(dim=(-2, -1), keepdim=True)


def make(n: int, h: int, w: int, seed: int, device) -> list:
    """``n`` images (C = 3, H = h, W = w) as host float32 numpy arrays."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    mix = torch.tensor(_MIX, device=dev)
    out = []
    for s in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s)
        lum, c1, c2 = _fields(m, h, w, gen, dev).unbind(1)
        rgb = (mix[:, 0, None, None, None] * lum[None]
               + mix[:, 1, None, None, None] * c1[None]
               + mix[:, 2, None, None, None] * c2[None]).transpose(0, 1)
        rgb = rgb + 0.01 / 0.18 * torch.randn(rgb.shape, generator=gen,
                                              device=dev)
        rgb = (rgb - rgb.mean(dim=(-3, -2, -1), keepdim=True)) / rgb.std(
            dim=(-3, -2, -1), keepdim=True)
        rgb = (0.45 + 0.18 * rgb).clamp(0.0, 1.0).to(torch.float32)
        host = rgb.cpu().numpy()
        out.extend(np.ascontiguousarray(im) for im in host)
    return out
