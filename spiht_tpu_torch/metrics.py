"""Observability: spans at the port's layer boundaries and per-image
codec metrics, the port of ``spiht_tpu/metrics.py``.

Spans (``span``, ``open_span`` / ``close_span``, ``spans``,
``clear_spans``) mark where a call of the on-device API spends its host
time: the API call itself and, inside it, each program's phases (stage,
capture, replay, wait, read). They record only while a ``torch.profiler``
session records (``metrics.trace``, or any other), and then each also
opens a ``torch.profiler.record_function`` of its name, so the exported
Chrome trace holds them on the device trace's clock, nested as in the
log. With no profiler on, a span is a check of the profiler's flag and
a shared null context: no clock read, no ``record_function``, no record.

Per-image encode statistics (bpp, PSNR, MP/s, bits-per-plane histogram)
and ``trace(dirname)``, a ``torch.profiler`` trace scope, the counterpart
of the JAX package's ``jax.profiler`` hook.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span", "open_span", "close_span", "spans", "clear_spans",
           "Span", "SPAN_LIMIT", "EncodeStats", "encode_stats", "psnr",
           "bits_per_plane", "trace"]

# the spans the log keeps, the oldest dropped first: a traced round of
# the benchmark's cells records under 20 spans a call
SPAN_LIMIT = 1 << 16


@dataclass(frozen=True)
class Span:
    """One closed span: its name (``spiht/api/<function>`` or
    ``spiht/<program kind>/<phase>``), start and end on
    ``time.perf_counter_ns``, its id, its parent's id (None at the top),
    the id of the top-level span it ran under (``request``: its own id at
    the top), and its counts."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: int
    counts: dict


class _Open:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "scope")


_SPANS: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_IDS = itertools.count(1)
_LOCAL = threading.local()  # each thread's stack of open spans


def open_span(name: str) -> Optional[_Open]:
    """Open the span ``name`` under this thread's innermost open span;
    None (and nothing done) unless a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    s = _Open()
    s.name, s.id = name, next(_IDS)
    if stack:
        s.parent, s.request = stack[-1].id, stack[-1].request
    else:
        s.parent, s.request = None, s.id
    # the trace stamps a span early in its enter and late in its exit:
    # the log reads the clock just before the one and just after the other
    s.scope = torch.profiler.record_function(name)
    s.start_ns = time.perf_counter_ns()
    s.scope.__enter__()
    stack.append(s)
    return s


def close_span(s: Optional[_Open], **counts) -> Optional[int]:
    """Close ``s`` (None: nothing to do) with its counts, and return its
    end (``perf_counter_ns``); spans opened under it and still open (a
    call that raised) close with it."""
    if s is None:
        return None
    stack = getattr(_LOCAL, "stack", ())
    if s not in stack:  # closed already, with a span it ran under
        return None
    while True:
        top = stack.pop()
        top.scope.__exit__(None, None, None)
        end = time.perf_counter_ns()
        _SPANS.append(Span(top.name, top.start_ns, end, top.id, top.parent,
                           top.request, counts if top is s else {}))
        if top is s:
            return end


class _Scope:
    __slots__ = ("name", "counts", "open")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        self.open = open_span(self.name)
        return self

    def __exit__(self, *exc):
        close_span(self.open, **self.counts)
        return False


_NULL = contextlib.nullcontext()


def span(name: str, **counts):
    """A context manager that records the span ``name`` with ``counts``
    while a profiler records; otherwise a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Scope(name, counts)


def spans() -> list:
    """The recorded spans (``Span``), in the order they closed."""
    return list(_SPANS)


def clear_spans() -> None:
    """Empty the log."""
    _SPANS.clear()


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
    into ``dirname``, the CPU and, where there is one, the CUDA card, with
    the port's spans in it (they record while it is on); no-op when
    dirname is None or empty."""
    if not dirname:
        yield
        return
    import os

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
