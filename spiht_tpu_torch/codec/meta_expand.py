"""The metadata trace from kernel B2-log's compact event log, the port of
``spiht_tpu/codec/meta_expand.py`` (``_static_node_tables`` :50-102,
``_expand_fn`` :111-196, ``decode_event_log`` :199, ``expand_event_log``
:246, ``pallas_decode_with_metadata`` :277).

B2-log (``decoder.decode_lsp_log``) writes one int32 per attempted stream
bit at its offset: ``node | action << 24 | (n+1) << 27``. Everything else
in the reference trace row ``[action, local_h, local_w, channel, filter,
depth, n, current_value]`` is rebuilt outside the kernel:

* ``filter``/``depth``/``local_h``/``local_w`` are static per node once
  every node has one parent (the duplicate-free geometries B2 decodes):
  a numpy BFS from the LL roots and the reference's float32 normalisation.
* ``current_value`` (the decoder's rec value before the event) is replayed
  in torch on the log's device: sort the events by (node, time), take
  segmented exclusive sums of each node's commit (plane, sign) and of its
  refinement bits, and evaluate the SPIHT value in closed form. No Pallas
  kernel computes this step, so it stays plain torch.

Duplicate-parent (odd-LL) geometries raise: the JAX package sends them to
its XLA sequential machine, which the port has not yet (ROADMAP Queue A
item 10).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .decoder import (
    LOG_MAX_CELLS, decode_lsp_log, has_duplicate_parents, machine_args,
    scatter_rec, words_tensor,
)
from .encoder import check_stat
from .geom import dec_geom, rect_table

__all__ = ["decode_event_log", "expand_event_log", "decode_with_metadata"]


@lru_cache(maxsize=None)
def _static_node_tables(c, h, w, ll_h, ll_w, level, rect_key):
    """(filt, depth, local_h, local_w) int32 tables indexed by flat
    node id, derived by BFS over the (duplicate-free) orientation
    tree. Mirrors device_decoder's in-loop propagation
    (cfilt = llcf for LL parents else inherited; cdep = depth-1
    floored) and the reference local-position f32 math."""
    g = dec_geom(c, h, w, ll_h, ll_w)
    N = c * h * w
    has_child = np.asarray(g["has_child"], bool)
    child0 = np.asarray(g["child0"], np.int64)
    llcf = np.asarray(g["llcf"], np.int32)
    in_ll = np.asarray(g["in_ll"], bool)

    filt = np.zeros(N, np.int32)
    depth = np.zeros(N, np.int32)
    seen = np.zeros(N, bool)
    roots = np.nonzero(in_ll)[0]
    filt[roots] = 0  # _F_LL
    depth[roots] = level
    seen[roots] = True
    frontier = roots[has_child[roots]]
    while frontier.size:
        pf = filt[frontier]
        cf = np.where(in_ll[frontier], llcf[frontier], pf)
        cd = np.maximum(depth[frontier] - 1, 0)
        nxt = []
        for off in (0, 1, w, w + 1):
            ch = child0[frontier] + off
            fresh = ~seen[ch]
            ch_f = ch[fresh]
            filt[ch_f] = cf[fresh]
            depth[ch_f] = cd[fresh]
            seen[ch_f] = True
            nxt.append(ch_f[has_child[ch_f]])
        frontier = np.concatenate(nxt) if nxt else np.empty(0, np.int64)

    rtab = np.asarray(rect_key, np.int32).reshape(level + 1, 4, 4)
    hw = h * w
    idx = np.arange(N, dtype=np.int64)
    ii = (idx % hw) // w
    jj = idx % w
    r = rtab[np.clip(depth, 0, level), filt]
    f32 = np.float32
    big = f32(3e38)
    lh = (ii.astype(f32) - r[:, 0].astype(f32)) / r[:, 1].astype(f32)
    lw = (jj.astype(f32) - r[:, 2].astype(f32)) / r[:, 3].astype(f32)
    th = np.minimum(lh * f32(200000.0), big) - f32(100000.0)
    tw = np.minimum(lw * f32(200000.0), big) - f32(100000.0)
    return (
        filt, depth,
        th.astype(np.int32), tw.astype(np.int32),
    )


@lru_cache(maxsize=16)
def _node_tables(c, h, w, ll_h, ll_w, level, rect_key, device):
    """``_static_node_tables`` as one int64 (4, N) tensor on ``device``."""
    tabs = _static_node_tables(c, h, w, ll_h, ll_w, level, rect_key)
    return torch.as_tensor(np.stack(tabs).astype(np.int64), device=device)


def _rect_key(level, ll_h, ll_w, top_slice, other_slices):
    tab = rect_table(level, ll_h, ll_w, (top_slice, other_slices))
    return tuple(map(tuple, tab.reshape(-1, 4).tolist()))


def expand_event_log(
    log: torch.Tensor,
    words: torch.Tensor,
    nbits: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    top_slice,
    other_slices,
) -> torch.Tensor:
    """Compact event log -> the reference (nbits+1, 8) int32 trace, on the
    log's device. Row layout: ``[action, local_h, local_w, channel,
    filter, depth, n, value]``; ``words`` are the stream's int32 words."""
    level = len(other_slices)
    rect_key = _rect_key(level, ll_h, ll_w, top_slice, other_slices)
    dev = log.device
    filt_t, dep_t, lh_t, lw_t = _node_tables(
        c, h, w, ll_h, ll_w, level, rect_key, dev
    )
    M = nbits + 1
    lg = log[:M].to(torch.int64)
    t = torch.arange(M, dtype=torch.int64, device=dev)
    written = lg != 0
    node = lg & 0xFFFFFF
    act = (lg >> 24) & 7
    nv = ((lg >> 27) & 31) - 1
    wi = words.to(torch.int64) & 0xFFFFFFFF
    bit_t = (wi[(t >> 5).clamp(0, words.numel() - 1)] >> (t & 31)) & 1
    in_stream = t < nbits
    is_commit = written & ((act == 1) | (act == 4)) & in_stream
    is_ref = written & (act == 6) & in_stream

    # ---- replay: the value of each event's node before the event ----
    key = torch.where(written, node, 1 << 24)
    # packed commit (plane+1, sign); at most one per node
    pc = torch.where(is_commit, ((nv + 1) << 1) | bit_t, 0)
    rv = torch.where(is_ref, bit_t << nv.clamp(0, 30), 0)
    rc = is_ref.to(torch.int64)
    # stable sort by (node, time): one key, node << 32 | t, all distinct
    order = torch.sort((key << 32) | t).indices
    key_s = key[order]
    start = torch.ones(M, dtype=torch.bool, device=dev)
    start[1:] = key_s[1:] != key_s[:-1]
    pos = torch.arange(M, dtype=torch.int64, device=dev)
    sidx = torch.cummax(torch.where(start, pos, 0), 0).values

    def within_excl(x):
        excl = torch.cumsum(x, 0) - x
        return excl - excl[sidx]

    commit_p = within_excl(pc[order])
    refsum = within_excl(rv[order])
    refcnt = within_excl(rc[order])
    committed = commit_p > 0
    nc = (commit_p >> 1) - 1
    sgn_c = commit_p & 1
    ncc = nc.clamp(0, 30)
    one = torch.ones_like(ncc)
    base = torch.where(
        ncc == 0, one, (one << (ncc - 1).clamp(min=0)) + (one << ncc)
    )
    mag = torch.where(refcnt == 0, base, (one << ncc) | refsum)
    pre = torch.where(committed, torch.where(sgn_c == 1, mag, -mag), 0)
    prevals = torch.zeros(M, dtype=torch.int64, device=dev)
    prevals[order] = pre

    cols = torch.stack(
        [
            act,
            lh_t[node], lw_t[node],
            node // (h * w),
            filt_t[node], dep_t[node],
            nv,
            prevals,
        ],
        dim=1,
    )
    return torch.where(written[:, None], cols, 0).to(torch.int32)


def decode_event_log(
    data: bytes,
    max_n: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    device,
):
    """Decode bytes on ``device`` through kernel B2-log.

    Returns ``(rec, log, words, nbits)``: rec (c, h, w) int32 and log
    (nbits+1,) int32 on the device; ``log[t]`` is the event of the bit at
    stream offset ``t``, ``node | action << 24 | (n+1) << 27`` (0 = no
    event), and the bit itself is ``words[t >> 5] >> (t & 31) & 1``.
    Raises ValueError for duplicate-parent (odd-LL) geometries, which the
    port cannot trace yet (ROADMAP Queue A item 10: the JAX package traces
    them on its XLA sequential machine), and for c*h*w >= 2^24.
    """
    if has_duplicate_parents(h, w, ll_h, ll_w):
        raise ValueError(
            f"{c}x{h}x{w} with LL {ll_h}x{ll_w} has duplicate parents: its "
            "metadata trace needs the sequential machine, not yet ported "
            "(ROADMAP Queue A item 10)"
        )
    if c * h * w >= LOG_MAX_CELLS:
        raise ValueError(f"{c}x{h}x{w}: the event log takes c*h*w < 2^24")
    words, nbits = words_tensor(data, device)
    lsp, lsp_val, stat, log = decode_lsp_log(
        *machine_args(words, nbits, max_n, c, h, w, ll_h, ll_w)
    )
    check_stat(stat, "spiht_decode_lsp_log")
    rec = scatter_rec(lsp, lsp_val, stat, c * h * w).reshape(c, h, w)
    return rec, log, words, nbits


def decode_with_metadata(
    data: bytes,
    max_n: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    top_slice,
    other_slices,
    device,
):
    """(rec, trace) on ``device``: kernel B2-log, then the log's expansion
    into the reference (nbits+1, 8) trace. Equal to the reference
    decoder's trace row for row, byte-prefix truncation included."""
    rec, log, words, nbits = decode_event_log(
        data, max_n, c, h, w, ll_h, ll_w, device
    )
    meta = expand_event_log(
        log, words, nbits, c, h, w, ll_h, ll_w, top_slice, other_slices
    )
    return rec, meta
