"""The metadata trace from the decode kernels' event logs, the port of
``spiht_tpu/codec/meta_expand.py`` (``_static_node_tables`` :50-102,
``_expand_fn`` :111-196, ``decode_event_log`` :199, ``expand_event_log``
:246, ``pallas_decode_with_metadata`` :277).

B2-log (``decoder.decode_lsp_log``, duplicate-free geometries) and B3-log
(``decoder.decode_seq_log``, odd-LL geometries, where a node may have up
to three LL parents) write one int64 per attempted stream bit at its
offset: ``node | action << 32 | (n+1) << 35 | filter << 40``, the filter
that of the node's instance (B3-log; B2-log leaves it 0). Everything else
in the reference trace row ``[action, local_h, local_w, channel, filter,
depth, n, current_value]`` is rebuilt outside the kernel:

* ``filter`` comes from the event word where a node may have several
  instances; where every node has one parent, it is static per node, from
  a numpy BFS from the LL roots, as is ``depth`` in every geometry (all
  instances of a node lie at one depth).
* ``local_h``/``local_w`` follow per row from (position, filter, depth)
  with the reference's float32 normalisation.
* ``current_value`` (the decoder's rec value before the event) is replayed
  in torch on the log's device, over the events sorted by (node, time).
  With one parent per node, a node is committed at most once: segmented
  exclusive sums of its commit (plane, sign) and of its refinement bits
  give the value in closed form. With duplicate parents a node may be
  committed again and refined by several LSP instances, so its writes
  (a commit sets +-1.5 * 2^n, a refinement sets or clears bit n and keeps
  the sign, which is lost at 0) are replayed in order, one pass per
  position within a node's writes, over all nodes at once.

No Pallas kernel computes the expansion, so it stays plain torch. The
trace takes what the machines take: c*h*w < 2^29, max_n <= 30.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from .decoder import (
    decode_lsp_log, decode_seq_log, has_duplicate_parents, machine_args,
    scatter_rec, words_tensor,
)
from .encoder import MAX_CELLS, check_geometry, check_stat
from .geom import dec_geom, rect_table

__all__ = [
    "decode_event_log", "expand_event_log", "decode_with_metadata",
    "pallas_decode_with_metadata",
]


@lru_cache(maxsize=4)
def _static_node_tables(c, h, w, ll_h, ll_w, level):
    """(filt, depth) uint8 tables indexed by flat node id, by BFS from the
    LL roots, each node taking the first parent that reaches it. Mirrors
    device_decoder's in-loop propagation (cfilt = llcf for LL parents else
    inherited; cdep = depth-1 floored). The filter is every instance's
    where the geometry has no duplicate parents; the depth is always."""
    g = dec_geom(c, h, w, ll_h, ll_w)
    N = c * h * w
    has_child = np.asarray(g["has_child"], bool)
    child0 = np.asarray(g["child0"], np.int64)
    llcf = np.asarray(g["llcf"], np.uint8)
    in_ll = np.asarray(g["in_ll"], bool)

    filt = np.zeros(N, np.uint8)
    depth = np.zeros(N, np.uint8)
    seen = np.zeros(N, bool)
    roots = np.nonzero(in_ll)[0]
    filt[roots] = 0  # _F_LL
    depth[roots] = level
    seen[roots] = True
    frontier = roots[has_child[roots]]
    while frontier.size:
        pf = filt[frontier]
        cf = np.where(in_ll[frontier], llcf[frontier], pf)
        cd = np.maximum(depth[frontier].astype(np.int32) - 1, 0)
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
    return filt, depth


@lru_cache(maxsize=4)
def _node_tables(c, h, w, ll_h, ll_w, level, device):
    """``_static_node_tables`` as one uint8 (2, N) tensor on ``device``."""
    tabs = _static_node_tables(c, h, w, ll_h, ll_w, level)
    return torch.as_tensor(np.stack(tabs), device=device)


def _local(pos, rect):
    """The reference's float32 local coordinate of ``pos`` in a subband
    (r0, rlen) (``oracle._local_position``): (pos - r0) / rlen, scaled to
    [-100000, 100000] and truncated, as int64."""
    f32 = torch.float32
    x = (pos.to(f32) - rect[:, 0].to(f32)) / rect[:, 1].to(f32)
    x = torch.clamp(x * 200000.0, max=3e38) - 100000.0
    return x.to(torch.int32).to(torch.int64)


def _replay_closed_form(sidx, pc, rv, rc):
    """Values before each sorted event where a node is committed at most
    once: segmented exclusive sums of the packed commit (plane+1, sign),
    the refinement bits and their count, then the SPIHT value."""

    def within_excl(x):
        excl = torch.cumsum(x, 0) - x
        return excl - excl[sidx]

    commit_p = within_excl(pc)
    refsum = within_excl(rv)
    refcnt = within_excl(rc)
    committed = commit_p > 0
    nc = ((commit_p >> 1) - 1).clamp(0, 30)
    one = torch.ones_like(nc)
    base = torch.where(
        nc == 0, one, (one << (nc - 1).clamp(min=0)) + (one << nc)
    )
    mag = torch.where(refcnt == 0, base, (one << nc) | refsum)
    return torch.where(committed, torch.where((commit_p & 1) == 1, mag, -mag),
                       0)


def _replay_in_order(key_s, sidx, is_c, is_r, bit, nv):
    """Values before each sorted event where a node may be committed by
    several parents and refined by several instances: the node's writes
    replayed in time order (``oracle._set_bit``'s sign rule included), one
    pass for each position within a node's writes, all nodes at once."""
    dev = key_s.device
    M = key_s.numel()
    pos = torch.arange(M, dtype=torch.int64, device=dev)
    is_w = is_c | is_r
    W = torch.nonzero(is_w).squeeze(1)  # the writes, node then time order
    val = torch.zeros(M, dtype=torch.int64, device=dev)
    if W.numel():
        wkey = key_s[W]
        wstart = torch.ones_like(wkey, dtype=torch.bool)
        wstart[1:] = wkey[1:] != wkey[:-1]
        widx = torch.arange(W.numel(), dtype=torch.int64, device=dev)
        wp = widx - torch.cummax(torch.where(wstart, widx, 0), 0).values
        groups = torch.sort(wp, stable=True).indices
        vals = torch.zeros(W.numel(), dtype=torch.int64, device=dev)
        off = 0
        for p, cnt in enumerate(torch.bincount(wp).tolist()):  # one sync
            i = groups[off: off + cnt]
            off += cnt
            at = W[i]
            n = nv[at].clamp(0, 30)
            one = torch.ones_like(n)
            set_ = bit[at] == 1
            base = torch.where(
                n == 0, one, (one << (n - 1).clamp(min=0)) + (one << n))
            prev = vals[i - 1] if p else torch.zeros_like(n)
            mag = prev.abs()
            mag = torch.where(set_, mag | (one << n), mag & ~(one << n))
            vals[i] = torch.where(
                is_c[at], torch.where(set_, base, -base),
                torch.where(prev >= 0, mag, -mag))
        val[W] = vals
    # each event's value is the one after its node's last write before it
    last = torch.cummax(torch.where(is_w, pos, -1), 0).values
    before = torch.cat([last.new_full((1,), -1), last[:-1]])
    return torch.where(before >= sidx, val[before.clamp(min=0)], 0)


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
    """Event log (B2-log's or B3-log's) -> the reference (nbits+1, 8) int32
    trace, on the log's device. Row layout: ``[action, local_h, local_w,
    channel, filter, depth, n, value]``; ``words`` are the stream's int32
    words."""
    check_geometry(c, h, w, ll_h, ll_w)
    level = len(other_slices)
    dev = log.device
    dup = has_duplicate_parents(h, w, ll_h, ll_w)
    tabs = _node_tables(c, h, w, ll_h, ll_w, level, dev)
    rtab = torch.as_tensor(
        rect_table(level, ll_h, ll_w, (top_slice, other_slices)), device=dev)
    M = nbits + 1
    lg = log[:M].to(torch.int64)
    t = torch.arange(M, dtype=torch.int64, device=dev)
    written = lg != 0
    node = torch.where(written, lg & 0xFFFFFFFF, 0)
    act = (lg >> 32) & 7
    nv = ((lg >> 35) & 31) - 1
    depth = tabs[1][node].long()
    filt = (lg >> 40) & 3 if dup else tabs[0][node].long()
    rect = rtab[depth.clamp(0, level), filt]  # (M, 4): r0, rlen, c0, clen
    hw = h * w
    wi = words.to(torch.int64) & 0xFFFFFFFF
    bit_t = (wi[(t >> 5).clamp(0, words.numel() - 1)] >> (t & 31)) & 1
    in_stream = t < nbits
    is_commit = written & ((act == 1) | (act == 4)) & in_stream
    is_ref = written & (act == 6) & in_stream

    # ---- replay: the value of each event's node before the event ----
    key = torch.where(written, node, MAX_CELLS)  # past every node
    # stable sort by (node, time): one key, node << 32 | t, all distinct
    order = torch.sort((key << 32) | t).indices
    key_s = key[order]
    start = torch.ones(M, dtype=torch.bool, device=dev)
    start[1:] = key_s[1:] != key_s[:-1]
    sidx = torch.cummax(torch.where(start, t, 0), 0).values
    if dup:
        pre = _replay_in_order(key_s, sidx, is_commit[order], is_ref[order],
                               bit_t[order], nv[order])
    else:
        pc = torch.where(is_commit, ((nv + 1) << 1) | bit_t, 0)
        rv = torch.where(is_ref, bit_t << nv.clamp(0, 30), 0)
        pre = _replay_closed_form(sidx, pc[order], rv[order],
                                  is_ref[order].to(torch.int64))
    prevals = torch.zeros(M, dtype=torch.int64, device=dev)
    prevals[order] = pre

    cols = torch.stack(
        [
            act,
            _local((node % hw) // w, rect[:, 0:2]),
            _local(node % w, rect[:, 2:4]),
            node // hw,
            filt, depth,
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
    """Decode bytes on ``device`` through kernel B2-log, or B3-log for
    duplicate-parent (odd-LL) geometries.

    Returns ``(rec, log, words, nbits)``: rec (c, h, w) int32 and log
    (nbits+1,) int64 on the device; ``log[t]`` is the event of the bit at
    stream offset ``t``, ``node | action << 32 | (n+1) << 35 | filter <<
    40`` (0 = no event; the filter 0 from B2-log), and the bit itself is
    ``words[t >> 5] >> (t & 31) & 1``.
    """
    check_geometry(c, h, w, ll_h, ll_w)
    words, nbits = words_tensor(data, device)
    args = machine_args(words, nbits, max_n, c, h, w, ll_h, ll_w)
    if has_duplicate_parents(h, w, ll_h, ll_w):
        rec, stat, log = decode_seq_log(*args)
        check_stat(stat, "spiht_decode_seq_log")
        return rec.reshape(c, h, w), log, words, nbits
    lsp, lsp_val, stat, log = decode_lsp_log(*args)
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
    """(rec, trace) on ``device``: kernel B2-log (B3-log at odd LL), then
    the log's expansion into the reference (nbits+1, 8) trace. Equal to
    the reference decoder's trace row for row, byte-prefix truncation
    included, in every geometry the machines take."""
    rec, log, words, nbits = decode_event_log(
        data, max_n, c, h, w, ll_h, ll_w, device
    )
    meta = expand_event_log(
        log, words, nbits, c, h, w, ll_h, ll_w, top_slice, other_slices
    )
    return rec, meta


def pallas_decode_with_metadata(
    data: bytes,
    max_n: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    top_slice,
    other_slices,
    device=None,
):
    """(rec (c, h, w), trace (nbits+1, 8)) as int32 numpy arrays, decoded
    on ``device`` (None: the card): kernel B2-log, or B3-log at odd LL
    (where the reference raises ``MachineResourceLimit``), then the log's
    expansion (``decode_with_metadata``)."""
    check_geometry(c, h, w, ll_h, ll_w)
    rec, meta = decode_with_metadata(
        data, max_n, c, h, w, ll_h, ll_w, top_slice, other_slices,
        resolve_device(device),
    )
    return rec.cpu().numpy(), meta.cpu().numpy()
