"""Shared arithmetic of the end-to-end readers."""

from __future__ import annotations

import numpy as np


def _calls(window: dict, kind: str) -> list:
    return [c for c in window["calls"] if c["direction"].startswith(kind)]


def mpx_per_s(window: dict, kind: str):
    """Pixels over the summed host seconds of every ``kind`` call
    ("enc" or "dec"), in megapixels a second."""
    calls = _calls(window, kind)
    if not calls:
        return None
    return sum(c["pixels"] for c in calls) / sum(c["seconds"] for c in calls) / 1e6


def p95_ms(window: dict, kind: str):
    """The 95th percentile (linear between ranks) of every ``kind``
    call's host milliseconds."""
    calls = _calls(window, kind)
    if not calls:
        return None
    return float(np.percentile([1e3 * c["seconds"] for c in calls], 95))
