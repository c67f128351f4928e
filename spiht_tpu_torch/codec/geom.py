"""Per-node tree geometry of the bit machines, copied into numpy from
``spiht_tpu/codec/device_decoder.py:63 _dec_geom``, ``:944 _words_of`` and
``:179 _rect_table``, with its action and filter ids (:57-59).

Child-based (reference ``_offspring`` semantics, SURVEY.md 3.4), so odd LL
dims work. The initial LIP and LIS orders are channel-innermost
(i -> j -> k), which is part of the wire format.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import keep
from .tree_bounds import queue_bounds

__all__ = ["dec_geom", "words_of", "machine_tables", "rect_table"]

# action ids of the metadata trace (reference taxonomy)
A_LIP, A_LIPSIGN, A_DESC, A_OFF, A_OFFSIGN, A_LSIG, A_REF = range(7)

_F_LL, _F_DA, _F_AD, _F_DD = 0, 1, 2, 3


@lru_cache(maxsize=16)
def dec_geom(c: int, h: int, w: int, ll_h: int, ll_w: int) -> dict:
    """Flat (c*h*w) per-node tables: ``has_child``, ``hg`` (has
    grandchildren), ``child0`` (flat index of the first child, channel
    base included), ``llcf`` (child filter of LL parents), ``in_ll``;
    the initial queues ``lip_init``/``lis_init`` (flat node indices); and
    the queue bounds ``ent_bound``/``lis_bound``."""
    ii = np.arange(h)[:, None] * np.ones((1, w), np.int64)
    jj = np.ones((h, 1), np.int64) * np.arange(w)[None, :]
    in_ll = (ii < ll_h) & (jj < ll_w)
    even = (ii % 2 == 0) & (jj % 2 == 0)
    oi = np.where(in_ll, (ii % 2) * ll_h + (ii // 2) * 2, 2 * ii)
    oj = np.where(in_ll, (jj % 2) * ll_w + (jj // 2) * 2, 2 * jj)
    has_child = np.where(in_ll, ~even, (2 * ii + 1 < h) & (2 * jj + 1 < w))
    has_child &= (oi + 1 < h) & (oj + 1 < w)
    hg = ((ii * 2 + 1) * 2 + 1 < h) & ((jj * 2 + 1) * 2 + 1 < w)
    child0 = np.where(has_child, oi * w + oj, 0).astype(np.int64)
    llcf = np.where(
        (ii % 2 == 1) & (jj % 2 == 1),
        _F_DD,
        np.where((ii % 2 == 0) & (jj % 2 != 0), _F_AD, _F_DA),
    )
    qb = queue_bounds(c, h, w, ll_h, ll_w)

    def flat(x):
        return np.broadcast_to(x[None], (c, h, w)).reshape(-1)

    base = (np.arange(c)[:, None, None] * (h * w)).astype(np.int64)
    child0_f = np.broadcast_to(child0[None] + base, (c, h, w)).reshape(-1)
    lipq = [
        k * h * w + i * w + j
        for i in range(ll_h) for j in range(ll_w) for k in range(c)
    ]
    lisq = [
        k * h * w + i * w + j
        for i in range(ll_h) for j in range(ll_w)
        if not (i % 2 == 0 and j % 2 == 0)
        for k in range(c)
    ]
    return dict(
        has_child=flat(has_child),
        hg=flat(hg),
        child0=child0_f.astype(np.int32),
        llcf=flat(llcf).astype(np.int32),
        in_ll=flat(in_ll),
        lip_init=np.asarray(lipq, np.int32),
        lis_init=np.asarray(lisq, np.int32),
        ent_bound=qb.ent_bound,
        lis_bound=qb.lis_bound,
    )


def rect_table(level: int, ll_h: int, ll_w: int, slices) -> np.ndarray:
    """(level+1, 4, 4) table of subband rects (r0, rlen, c0, clen) by
    (depth, filter) for the metadata local-position math."""
    tab = np.zeros((level + 1, 4, 4), np.int32)
    tab[level, :, :] = [0, ll_h, 0, ll_w]
    if slices is not None:
        top, other = slices
        tab[level, :, :] = [
            top[0][0],
            top[0][1] - top[0][0],
            top[1][0],
            top[1][1] - top[1][0],
        ]
        for depth in range(level):
            da, ad, dd = other[level - 1 - depth]
            for f, r in ((_F_DA, da), (_F_AD, ad), (_F_DD, dd)):
                tab[depth, f] = [
                    r[0][0],
                    r[0][1] - r[0][0],
                    r[1][0],
                    r[1][1] - r[1][0],
                ]
    # avoid div-by-zero on unused rows
    tab[:, :, 1] = np.maximum(tab[:, :, 1], 1)
    tab[:, :, 3] = np.maximum(tab[:, :, 3], 1)
    return tab


def words_of(data: bytes, cap_words: int) -> np.ndarray:
    """Stream bytes -> uint32[cap_words], little-endian, zero-padded."""
    raw = np.frombuffer(data, dtype=np.uint8)
    raw = np.pad(raw, (0, cap_words * 4 - raw.size))
    return raw.view(np.uint32)


def machine_tables(c, h, w, ll_h, ll_w, device: torch.device) -> dict:
    """The bit machines' geometry-only tables on ``device``, int32:
    ``child0``; ``hc_flags`` = hc<<19 | hg<<20 (the encoder's t1 bits);
    ``geo`` = child0<<2 | hc<<1 | hg (the decoders' word); and the initial
    LIP (nodes) and LIS (node << 1 | type A) entries. Cached for 16
    geometries; every open ``device.holding()`` keeps what it returns, as
    a program's CUDA graph reads the tables after the cache lets go."""
    return keep(_machine_tables(c, h, w, ll_h, ll_w, device))


@lru_cache(maxsize=16)
def _machine_tables(c, h, w, ll_h, ll_w, device: torch.device) -> dict:
    g = dec_geom(c, h, w, ll_h, ll_w)
    hc = g["has_child"].astype(np.int64)
    hg = g["hg"].astype(np.int64)
    child0 = g["child0"].astype(np.int64)
    tabs = dict(
        child0=child0,
        hc_flags=(hc << 19) | (hg << 20),
        geo=(child0 << 2) | (hc << 1) | hg,
        lip0=g["lip_init"],
        lis0=(g["lis_init"].astype(np.int64) << 1) | 1,
    )
    return {
        k: torch.as_tensor(v.astype(np.int32), device=device)
        for k, v in tabs.items()
    }
