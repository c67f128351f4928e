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
  position within a node's writes, over all nodes at once, in a static
  number of passes (``replay_passes``).

No Pallas kernel computes the expansion, so it stays plain torch, with
static shapes and no read back to the host (``expander``): the entry
points run it, after the log kernel, as the cached trace program of
their key (``torch_transform.trace_program``), whose log holds its word
bucket's 32 x words + 1 rows; ``decode_with_metadata_eager`` is the
op-by-op body. The trace takes what the machines take: c*h*w < 2^29,
max_n <= 30.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import constant, keep, resolve_device
from .decoder import (
    _machine_tail, decode_lsp_log, decode_seq_log, has_duplicate_parents,
    scatter_rec, words_tensor,
)
from .encoder import MAX_CELLS, check_geometry, check_stat
from .geom import dec_geom, rect_table

__all__ = [
    "decode_event_log", "expand_event_log", "decode_with_metadata",
    "pallas_decode_with_metadata", "decode_with_metadata_eager",
    "replay_passes",
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
def _node_tables_on(c, h, w, ll_h, ll_w, level, device):
    tabs = _static_node_tables(c, h, w, ll_h, ll_w, level)
    return torch.as_tensor(np.stack(tabs), device=device)


def _node_tables(c, h, w, ll_h, ll_w, level, device):
    """``_static_node_tables`` as one uint8 (2, N) tensor on ``device``.
    Cached for 4 geometries; an expander takes its tables when it is
    made and keeps them (``expander``), and every open
    ``device.holding()`` keeps them too, so a captured graph reads tables
    that the cache may have let go."""
    return keep(_node_tables_on(c, h, w, ll_h, ll_w, level, device))


@constant
def _rect_tab(level, rkey, device) -> torch.Tensor:
    """``rect_key``'s table as an int32 (level+1, 4, 4) tensor on
    ``device``, copied there once."""
    return torch.tensor(rkey, dtype=torch.int32,
                        device=device).reshape(level + 1, 4, 4)


def rect_key(level, ll_h, ll_w, top_slice, other_slices) -> tuple:
    """The subband rects of the wire slices as a hashable key (the JAX
    package's ``rect_key``): ``rect_table``'s rows."""
    tab = rect_table(level, ll_h, ll_w, (top_slice, other_slices))
    return tuple(map(tuple, tab.reshape(-1, 4).tolist()))


@lru_cache(maxsize=16)
def replay_passes(h: int, w: int, ll_h: int, ll_w: int) -> int:
    """The static number of passes of the in-order replay: the most
    writes any node can take, 31 for each of its instances (a commit and
    at most 30 refinements, one a plane below it, as max_n <= 30). A node
    has one instance for each LL parent (at most four, from the parity
    offspring map of ``dec_geom``) and its descendants as many as it, as
    every node past the LL band has one parent; an LL node has one."""
    g = dec_geom(1, h, w, ll_h, ll_w)
    parents = g["in_ll"] & g["has_child"]
    heads = g["child0"][parents].astype(np.int64)
    inst = np.zeros(h * w, np.int64)
    for off in (0, 1, w, w + 1):
        np.add.at(inst, heads + off, 1)
    return 31 * max(int(inst.max()) if inst.size else 0, 1)


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


def _replay_in_order(sidx, is_c, is_r, bit, nv, passes):
    """Values before each sorted event where a node may be committed by
    several parents and refined by several instances: the node's writes
    replayed in time order (``oracle._set_bit``'s sign rule included),
    in ``passes`` passes over every event, pass p writing each node's
    p-th write from the value its previous write left. Static shapes and
    a static pass count (``replay_passes``, at least the most writes any
    node takes), so a CUDA graph captures it."""
    dev = sidx.device
    M = sidx.numel()
    pos = torch.arange(M, dtype=torch.int64, device=dev)
    is_w = is_c | is_r
    # each event's node's last write before it, -1 where there is none
    last = torch.cummax(torch.where(is_w, pos, -1), 0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    prev = torch.where(prev >= sidx, prev, -1)
    src, has_prev = prev.clamp(min=0), prev >= 0
    # each write's rank among its node's writes
    nw = torch.cumsum(is_w.to(torch.int64), 0)
    rank = torch.where(is_w, nw - 1 - (nw - is_w.to(torch.int64))[sidx], -1)
    n = nv.clamp(0, 30)
    one = torch.ones_like(n)
    bm = one << n
    set_ = bit == 1
    base = torch.where(n == 0, one, (one << (n - 1).clamp(min=0)) + bm)
    commit = torch.where(set_, base, -base)
    val = torch.zeros(M, dtype=torch.int64, device=dev)
    for p in range(passes):
        before = torch.where(has_prev, val[src], 0)
        mag = before.abs()
        mag = torch.where(set_, mag | bm, mag & ~bm)
        new = torch.where(is_c, commit, torch.where(before >= 0, mag, -mag))
        val = torch.where(rank == p, new, val)
    return torch.where(has_prev, val[src], 0)


def expander(c, h, w, ll_h, ll_w, top_slice, other_slices, rows, device):
    """expand(log, words, nbits) -> the (rows, 8) int32 trace of an event
    log (B2-log's or B3-log's) on ``device``, rows past nbits 0: row t
    ``[action, local_h, local_w, channel, filter, depth, n, value]`` of
    the event at stream offset t. ``log`` holds at least ``rows`` int64
    words, ``words`` the stream's int32 words; ``nbits`` is an int or a
    0-d tensor on the device (read there: nothing comes back to the
    host). The node and rect tables are taken once, here, and kept by
    the function."""
    check_geometry(c, h, w, ll_h, ll_w)
    level = len(other_slices)
    dup = has_duplicate_parents(h, w, ll_h, ll_w)
    tabs = _node_tables(c, h, w, ll_h, ll_w, level, device)
    rtab = _rect_tab(level, rect_key(level, ll_h, ll_w, top_slice,
                                     other_slices), device)
    passes = replay_passes(h, w, ll_h, ll_w) if dup else 0
    hw = h * w
    M = int(rows)

    def expand(log, words, nbits):
        lg = log[:M].to(torch.int64)
        t = torch.arange(M, dtype=torch.int64, device=device)
        written = (lg != 0) & (t <= nbits)
        node = torch.where(written, lg & 0xFFFFFFFF, 0)
        act = (lg >> 32) & 7
        nv = ((lg >> 35) & 31) - 1
        depth = tabs[1][node].long()
        filt = (lg >> 40) & 3 if dup else tabs[0][node].long()
        rect = rtab[depth.clamp(0, level), filt]  # (M, 4): r0, rlen, c0, clen
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
        start = torch.ones(M, dtype=torch.bool, device=device)
        start[1:] = key_s[1:] != key_s[:-1]
        sidx = torch.cummax(torch.where(start, t, 0), 0).values
        if dup:
            pre = _replay_in_order(sidx, is_commit[order], is_ref[order],
                                   bit_t[order], nv[order], passes)
        else:
            pc = torch.where(is_commit, ((nv + 1) << 1) | bit_t, 0)
            rv = torch.where(is_ref, bit_t << nv.clamp(0, 30), 0)
            pre = _replay_closed_form(sidx, pc[order], rv[order],
                                      is_ref[order].to(torch.int64))
        prevals = torch.zeros(M, dtype=torch.int64, device=device)
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

    expand.tables = (tabs, rtab)
    return expand


def trace_body(c, h, w, ll_h, ll_w, top_slice, other_slices, cap_words,
               rows, device, form="trace"):
    """The trace's eager body on ``device`` for streams of up to
    ``cap_words`` words, with no host read. ``form`` "log": body(words,
    scalars) -> (rec (c, h, w), stat, log int64[rows]) through kernel
    B2-log and the rec scatter, or B3-log at odd LL; "trace": (rec, stat,
    trace (rows, 8)), the log expanded; "expand": body(words, scalars,
    log) -> (trace,). ``scalars`` is an int32 (2,) tensor, nbits and
    max_n; rows >= nbits + 1. The caller checks the stat. ``body.tables``
    are the device tables the body reads, taken when it is made."""
    check_geometry(c, h, w, ll_h, ll_w)
    expand = (None if form == "log" else expander(
        c, h, w, ll_h, ll_w, top_slice, other_slices, rows, device))
    if form == "expand":
        def body(words, scalars, log):
            return (expand(log, words, scalars[0]),)

        body.tables = expand.tables
        return body
    tail = _machine_tail(c, h, w, ll_h, ll_w, cap_words, device)
    seq = has_duplicate_parents(h, w, ll_h, ll_w)

    def body(words, scalars):
        nbits, max_n = scalars[0], scalars[1]
        if seq:
            rec, stat, log = decode_seq_log(words, nbits, max_n, *tail,
                                            log_len=rows)
        else:
            lsp, lsp_val, stat, log = decode_lsp_log(words, nbits, max_n,
                                                     *tail, log_len=rows)
            rec = scatter_rec(lsp, lsp_val, stat, c * h * w)
        rec = rec.reshape(c, h, w)
        if expand is None:
            return rec, stat, log
        return rec, stat, expand(log, words, nbits)

    # the tables the body reads, held as long as it is
    body.tables = tail[:3] + (() if expand is None else expand.tables)
    return body


def decode_with_metadata_eager(
    data: bytes, max_n: int, c: int, h: int, w: int, ll_h: int, ll_w: int,
    top_slice, other_slices, device,
):
    """(rec, trace (nbits+1, 8)) on ``device``, op by op: the trace
    program's body (``trace_body``) on the stream's own words and a log
    of nbits + 1 rows, then the stat check (a sync)."""
    check_geometry(c, h, w, ll_h, ll_w)
    if not 0 <= int(max_n) <= 30:
        raise ValueError("the event log's plane field takes max_n <= 30")
    dev = resolve_device(device)
    words, nbits = words_tensor(data, dev)
    body = trace_body(c, h, w, ll_h, ll_w, top_slice, other_slices,
                      words.numel(), nbits + 1, dev)
    scalars = torch.tensor([nbits, int(max_n)], dtype=torch.int32,
                           device=dev)
    rec, stat, meta = body(words, scalars)
    check_stat(stat, "spiht_decode_" + (
        "seq_log" if has_duplicate_parents(h, w, ll_h, ll_w) else "lsp_log"))
    return rec, meta


def _trace(form, c, h, w, ll_h, ll_w, top_slice, other_slices, nbits,
           device):
    """The cached trace program of ``form`` for a stream of ``nbits``
    (``torch_transform.trace_program``)."""
    from .. import torch_transform

    check_geometry(c, h, w, ll_h, ll_w)
    return torch_transform.trace_program(
        c, h, w, ll_h, ll_w, top_slice, other_slices, nbits,
        resolve_device(device), form)


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
    trace, a fresh tensor on the log's device. Row layout: ``[action,
    local_h, local_w, channel, filter, depth, n, value]``; ``words`` are
    the stream's int32 words (at least ceil(nbits / 32)), ``log`` at
    least nbits + 1 words. Runs the expansion-only trace program of the
    geometry, the slices and the stream's bucket
    (``torch_transform.trace_program``, form "expand"), the log and
    words copied into its buffers where they lie."""
    nbits = int(nbits)
    prog = _trace("expand", c, h, w, ll_h, ll_w, top_slice, other_slices,
                  nbits, log.device)
    return prog(words, nbits, log=log)[0]


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
    duplicate-parent (odd-LL) geometries, as the trace program of the
    stream's bucket that stops at the log (``torch_transform.
    trace_program``, form "log").

    Returns ``(rec, log, words, nbits)``, fresh tensors on the device:
    rec (c, h, w) int32, log (nbits+1,) int64 and the stream's int32
    words; ``log[t]`` is the event of the bit at stream offset ``t``,
    ``node | action << 32 | (n+1) << 35 | filter << 40`` (0 = no event;
    the filter 0 from B2-log), and the bit itself is ``words[t >> 5] >>
    (t & 31) & 1``.
    """
    nbits = len(data) * 8
    prog = _trace("log", c, h, w, ll_h, ll_w, None, None, nbits, device)
    return prog([data], nbits, max_n) + (nbits,)


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
    """(rec, trace) on ``device``, fresh tensors: kernel B2-log (B3-log at
    odd LL), then the log's expansion into the reference (nbits+1, 8)
    trace, as one cached program a key (``torch_transform.
    trace_program``: a CUDA graph on the card, as the JAX package jits
    the expansion). Equal to the reference decoder's trace row for row,
    byte-prefix truncation included, in every geometry the machines
    take."""
    nbits = len(data) * 8
    prog = _trace("trace", c, h, w, ll_h, ll_w, top_slice, other_slices,
                  nbits, device)
    return prog([data], nbits, max_n)


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
    expansion, as one cached program a key (``decode_with_metadata``),
    read straight from the program's outputs (no copy on the device)."""
    nbits = len(data) * 8
    prog = _trace("trace", c, h, w, ll_h, ll_w, top_slice, other_slices,
                  nbits, device)
    return prog([data], nbits, max_n, host=True)
