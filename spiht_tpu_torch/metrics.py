"""Observability: per-stage timers and per-image codec metrics, the port of
``spiht_tpu/metrics.py``.

Stage timers on the host clock, per-image encode statistics (bpp, PSNR,
MP/s, bits-per-plane histogram) and an optional ``torch.profiler`` trace
scope, the counterpart of the JAX package's ``jax.profiler`` hook.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = ["StageTimer", "EncodeStats", "encode_stats", "psnr",
           "bits_per_plane", "trace"]


class StageTimer:
    """Accumulating named-stage wall-clock timer (host clock: a stage that
    launches device work should end in a sync to be counted whole).

    with timer.stage("dwt"): ...
    timer.report() -> {"dwt": seconds, ...}
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def pretty(self) -> str:
        total = sum(self.totals.values()) or 1.0
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"  {k:<12} {v*1e3:9.2f} ms  {100*v/total:5.1f}%  (x{self.counts[k]})"
            for k, v in rows
        )


def psnr(reference: np.ndarray, reconstruction: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB over the overlapping region, clipped to [0, peak]."""
    h = min(reference.shape[-2], reconstruction.shape[-2])
    w = min(reference.shape[-1], reconstruction.shape[-1])
    a = np.clip(reference[..., :h, :w], 0, peak)
    b = np.clip(reconstruction[..., :h, :w], 0, peak)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def bits_per_plane(encoding_result, settings, device=None) -> Dict[int, int]:
    """Histogram {plane n: emitted bits} for an encoded stream.

    Re-decodes the stream with the metadata trace (on the device: B2-log or
    B3-log) and counts rows per bit-plane (column 6 of each trace row is
    ``n``). The trailing pad bits of the final byte land in the plane
    where decoding stopped, inherent to the byte-aligned wire format.
    """
    from .codec import api

    d = api.decode_rec_array(encoding_result, settings, return_metadata=True,
                             device=device)
    meta = d["spiht_metadata"]
    planes, counts = np.unique(meta[:-1, 6], return_counts=True)
    return {int(p): int(c) for p, c in zip(planes, counts)}


@dataclass
class EncodeStats:
    h: int
    w: int
    c: int
    level: Optional[int]
    max_n: int
    stream_bytes: int
    bpp: float
    encode_s: float
    mpps: float
    psnr_db: Optional[float] = None
    stages: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        d = {k: v for k, v in self.__dict__.items()}
        return json.dumps(d)


def encode_stats(
    image: np.ndarray,
    encoding_result,
    encode_s: float,
    reconstruction: Optional[np.ndarray] = None,
    stages: Optional[Dict[str, float]] = None,
) -> EncodeStats:
    c, h, w = image.shape
    nbytes = len(encoding_result.encoded_bytes)
    return EncodeStats(
        h=h,
        w=w,
        c=c,
        level=encoding_result.level,
        max_n=encoding_result.max_n,
        stream_bytes=nbytes,
        bpp=8.0 * nbytes / (h * w),
        encode_s=encode_s,
        mpps=h * w * 1e-6 / encode_s if encode_s > 0 else float("inf"),
        psnr_db=(psnr(image, reconstruction) if reconstruction is not None else None),
        stages=dict(stages or {}),
    )


@contextlib.contextmanager
def trace(dirname: Optional[str]):
    """``torch.profiler`` scope writing a Chrome trace (``trace.json``)
    into ``dirname``, the CPU and, where there is one, the CUDA card;
    no-op when dirname is None or empty."""
    if not dirname:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
