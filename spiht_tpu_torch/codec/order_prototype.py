"""Sort-based reconstruction of the exact SPIHT emission ORDER (no queues).

A copy of ``spiht_tpu/codec/order_prototype.py`` (numpy only); its two
imports name the port's ``planning._static_geometry`` and
``maps.tree_height``, and its maps come from the port's native scheduler.
It is the closed form of the emission order that
``device_encoder._build`` relies on.

Implements and validates §2 of DESIGN_DEVICE_SCHEDULER.md on host numpy:
the full per-bit emission sequence of the encoder is rebuilt from the
significance maps using only per-plane, per-depth stable sorts — the
shape that ports to TPU as segmented sorts — with zero data-dependent
queue simulation. Ground truth is the instrumented oracle encoder
(oracle.encode_bits(events=...)); tests assert the sequences are
IDENTICAL element-for-element.

Entities and their append keys (appendP = plane appended, appendS =
sequence within that plane; lists are FIFO, so global list order is
always (appendP desc, appendS asc)):

  A-entry of set s   appended by parent's B fire (or initial, appendP =
                     max_n+1, appendS = raster rank); processed at every
                     plane in [max(D,0), ES]; fires at D.
  B-entry of s       appended by s's own A fire at plane D (iff the raw
                     grandchild gate holds); processed on [max(G,0), D].
  LIP cell x         initial (appendP = max_n+1) or appended by the
                     parent's A fire at EC = D(parent) when M < EC;
                     visited on [max(M,0), hi], hi = max_n | EC-1.
  LSP cell x         appended at plane M via the LIP pass (phase 0, at
                     its LIP position) or straight from the LIS offspring
                     test (phase 1, at parent position * 4 + slot);
                     refined at every plane n < M.

Within a plane the LIS worklist order is breadth-first over the cascade
forest: roots = entries with appendP > n ordered by append key; depth
d+1 = entries appended by depth-d fires, stably sorted by (parent
position, slot). Each entry's bits are contiguous at its position.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .planning import _static_geometry
from .maps import tree_height

__all__ = ["predict_events", "predict_bits", "predict_events_pathkey"]


def _maps_np(arr: np.ndarray, ll_h: int, ll_w: int):
    """Host M/D/G via the native kernel (fast) or brute force."""
    from ..native import runtime

    nat = runtime.load()
    arr32 = np.ascontiguousarray(arr, dtype=np.int32)
    if nat is not None:
        return nat.compute_maps(arr32, ll_h, ll_w)
    raise RuntimeError("native kernel required for the order prototype")


def predict_events(
    arr: np.ndarray, ll_h: int, ll_w: int, max_n: int
) -> List[Tuple[int, int, int, int, int]]:
    """Predicted (action, k, i, j, n) sequence for the FULL stream."""
    c, h, w = arr.shape
    M8, D8, G8 = _maps_np(arr, ll_h, ll_w)
    M = M8.astype(np.int32)
    D = D8.astype(np.int32)
    G = G8.astype(np.int32)
    (in_ll, initial_set, par_i, par_j, has_parent, hg_raw, _) = (
        _static_geometry(h, w, ll_h, ll_w)
    )

    ii = np.broadcast_to(np.arange(h)[:, None], (h, w))
    jj = np.broadcast_to(np.arange(w)[None, :], (h, w))

    def parent(x):  # per-channel gather at parent coords
        return x[:, par_i, par_j]

    # ES / EC propagation (as in planning.py)
    es = np.where(initial_set[None], max_n, -1) * np.ones((c, 1, 1), np.int32)
    es = es.astype(np.int32)
    for _ in range(tree_height(h, w, ll_h, ll_w)):
        pes = parent(es)
        pg = parent(G)
        child_es = np.where(
            has_parent[None] & (pes >= 0) & parent(hg_raw[None].repeat(c, 0))
            & (pg >= 0),
            pg,
            -1,
        )
        es = np.where(initial_set[None], max_n, child_es)
    pes = parent(es)
    pd = parent(D)
    ec = np.where(has_parent[None] & (pes >= 0) & (pd >= 0), pd, -1)

    # offspring block origins (slot order fixed by the reference):
    # parity rule in LL, dyadic elsewhere
    o_i = np.where(
        in_ll, (ii % 2) * ll_h + (ii // 2) * 2, 2 * ii
    )
    o_j = np.where(
        in_ll, (jj % 2) * ll_w + (jj // 2) * 2, 2 * jj
    )

    # ---- entity tables (flat per (k, i, j)) ----------------------------
    K, I, J = np.meshgrid(
        np.arange(c), np.arange(h), np.arange(w), indexing="ij"
    )
    flat = lambda x: np.broadcast_to(x, (c, h, w)).reshape(-1)
    Kf, If, Jf = K.reshape(-1), I.reshape(-1), J.reshape(-1)
    Mf, Df, Gf = M.reshape(-1), D.reshape(-1), G.reshape(-1)
    ESf, ECf = es.reshape(-1), ec.reshape(-1)
    in_ll_f = flat(in_ll[None])
    init_set_f = flat(initial_set[None])
    hg_f = flat(hg_raw[None])
    oif, ojf = flat(o_i[None]), flat(o_j[None])

    # initial ranks (i-major, j, channel-innermost: hazard #3)
    def raster_rank(mask):
        order = np.lexsort((Kf, Jf, If))
        sel = order[mask[order]]
        r = np.full(mask.shape, -1, np.int64)
        r[sel] = np.arange(sel.size)
        return r

    lip_init_rank = raster_rank(in_ll_f)
    a_init_rank = raster_rank(init_set_f)

    INF = max_n + 1
    a_exists = init_set_f | (ESf >= 0)
    a_appendP = np.where(init_set_f, INF, ESf)
    a_appendS = np.where(init_set_f, a_init_rank, -1).astype(np.int64)
    a_fire = np.where(a_exists, Df, -2)  # -2: entity absent

    b_exists = a_exists & (Df >= 0) & hg_f
    b_appendP = np.where(b_exists, Df, -2)
    b_appendS = np.full(b_appendP.shape, -1, np.int64)
    b_fire = np.where(b_exists, Gf, -2)

    lip_added = (ECf >= 0) & (Mf < ECf)
    lip_exists = in_ll_f | lip_added
    lip_appendP = np.where(in_ll_f, INF, np.where(lip_added, ECf, -2))
    lip_appendS = np.where(in_ll_f, lip_init_rank, -1).astype(np.int64)
    lip_hi = np.where(in_ll_f, max_n, ECf - 1)

    sig = (in_ll_f | (ECf >= 0)) & (Mf >= 0)
    lsp_key = np.full((Kf.size, 3), 2**60, np.int64)  # (plane-desc, phase, S)

    events: List[Tuple[int, int, int, int, int]] = []

    def cell_id(k, i, j):
        return (k * h + i) * w + j

    for n in range(max_n, -1, -1):
        # ---------------- LIP pass ----------------
        present = lip_exists & (np.maximum(Mf, 0) <= n) & (n <= lip_hi)
        idx = np.flatnonzero(present)
        order = np.lexsort((lip_appendS[idx], -lip_appendP[idx]))
        idx = idx[order]
        for pos, t in enumerate(idx):
            k, i, j = Kf[t], If[t], Jf[t]
            events.append((0, k, i, j, n))
            if Mf[t] == n:
                events.append((1, k, i, j, n))
                lsp_key[t] = (max_n - n, 0, pos)

        # ---------------- LIS worklist ----------------
        a_present = a_exists & (np.maximum(a_fire, 0) <= n) & (n <= np.where(init_set_f, max_n, ESf))
        b_present = b_exists & (np.maximum(b_fire, 0) <= n) & (n <= b_appendP)
        # frontier: roots (appended in an earlier plane)
        a_pos = np.full(Kf.size, -1, np.int64)
        b_pos = np.full(Kf.size, -1, np.int64)
        roots_a = np.flatnonzero(a_present & (a_appendP > n))
        roots_b = np.flatnonzero(b_present & (b_appendP > n))
        # merge both types by global append key
        typ = np.concatenate([np.zeros(roots_a.size, np.int64),
                              np.ones(roots_b.size, np.int64)])
        ridx = np.concatenate([roots_a, roots_b])
        rp = np.concatenate([a_appendP[roots_a], b_appendP[roots_b]])
        rs = np.concatenate([a_appendS[roots_a], b_appendS[roots_b]])
        order = np.lexsort((typ, rs, -rp))
        ridx, typ = ridx[order], typ[order]
        pos_counter = 0
        frontier = list(zip(ridx.tolist(), typ.tolist()))
        for t, ty in frontier:
            if ty == 0:
                a_pos[t] = pos_counter
            else:
                b_pos[t] = pos_counter
            pos_counter += 1
        # cascade depths
        while frontier:
            children = []  # (sortkey, entity idx, type)
            for t, ty in frontier:
                if ty == 0 and a_fire[t] == n and b_exists[t]:
                    children.append(((a_pos[t], 0), t, 1))
                if ty == 1 and b_fire[t] == n:
                    # 4 offspring become A entries (appended this plane)
                    k = Kf[t]
                    oi, oj = oif[t], ojf[t]
                    for slot, (ci, cj) in enumerate(
                        ((oi, oj), (oi, oj + 1), (oi + 1, oj), (oi + 1, oj + 1))
                    ):
                        cidx = cell_id(k, ci, cj)
                        if a_exists[cidx] and a_appendP[cidx] == n:
                            children.append(((b_pos[t], slot), cidx, 0))
            children.sort(key=lambda z: z[0])
            frontier = []
            for _, t, ty in children:
                if ty == 0:
                    a_pos[t] = pos_counter
                    a_appendS[t] = pos_counter
                else:
                    b_pos[t] = pos_counter
                    b_appendS[t] = pos_counter
                pos_counter += 1
                frontier.append((t, ty))
        # emission in processing-position order
        seq = []
        for t in np.flatnonzero(a_pos >= 0):
            seq.append((a_pos[t], t, 0))
        for t in np.flatnonzero(b_pos >= 0):
            seq.append((b_pos[t], t, 1))
        seq.sort(key=lambda z: z[0])
        for _, t, ty in seq:
            k, i, j = Kf[t], If[t], Jf[t]
            if ty == 0:
                events.append((2, k, i, j, n))
                if a_fire[t] == n:
                    oi, oj = oif[t], ojf[t]
                    for slot, (ci, cj) in enumerate(
                        ((oi, oj), (oi, oj + 1), (oi + 1, oj), (oi + 1, oj + 1))
                    ):
                        cidx = cell_id(k, ci, cj)
                        events.append((3, k, ci, cj, n))
                        if Mf[cidx] == n:
                            events.append((4, k, ci, cj, n))
                            lsp_key[cidx] = (
                                max_n - n, 1, a_pos[t] * 4 + slot
                            )
                        elif lip_added[cidx]:
                            lip_appendS[cidx] = a_pos[t] * 4 + slot
            else:
                events.append((5, k, i, j, n))

        # ---------------- refinement ----------------
        ridx = np.flatnonzero(sig & (Mf > n))
        order = np.lexsort(
            (lsp_key[ridx, 2], lsp_key[ridx, 1], lsp_key[ridx, 0])
        )
        for t in ridx[order]:
            events.append((6, Kf[t], If[t], Jf[t], n))

    return events


def predict_events_pathkey(
    arr: np.ndarray, ll_h: int, ll_w: int, max_n: int
) -> List[Tuple[int, int, int, int, int]]:
    """predict_events with the cascade ordered by ONE sort per plane.

    Replaces the per-depth stable sorts with a single lexicographic sort
    over PATH KEYS: within a plane, BFS order over the cascade forest
    equals ordering by (depth, path), where a node's path is its root's
    rank followed by the branch choices taken to reach it (A->B = 0,
    B->child slot k = 1+k). Proof: positions at depth d-1 are in path
    order by induction, and depth-d children sorted by (parent position,
    slot) are exactly in (parent path, slot) = own-path order.

    This is the formulation that ports to TPU with one segmented sort per
    plane instead of a depth-loop of sorts. Must produce sequences
    identical to predict_events (tests/test_order_prototype.py).
    """
    c, h, w = arr.shape
    M8, D8, G8 = _maps_np(arr, ll_h, ll_w)
    M = M8.astype(np.int32)
    D = D8.astype(np.int32)
    G = G8.astype(np.int32)
    (in_ll, initial_set, par_i, par_j, has_parent, hg_raw, _) = (
        _static_geometry(h, w, ll_h, ll_w)
    )

    def parent(x):
        return x[:, par_i, par_j]

    es = np.where(initial_set[None], max_n, -1) * np.ones((c, 1, 1), np.int32)
    es = es.astype(np.int32)
    for _ in range(tree_height(h, w, ll_h, ll_w)):
        pes = parent(es)
        pg = parent(G)
        child_es = np.where(
            has_parent[None] & (pes >= 0)
            & parent(np.broadcast_to(hg_raw[None], (c, h, w)))
            & (pg >= 0),
            pg,
            -1,
        )
        es = np.where(initial_set[None], max_n, child_es)
    pes = parent(es)
    pd = parent(D)
    ec = np.where(has_parent[None] & (pes >= 0) & (pd >= 0), pd, -1)

    o_i = np.where(in_ll, (np.arange(h)[:, None] % 2) * ll_h
                   + (np.arange(h)[:, None] // 2) * 2,
                   2 * np.arange(h)[:, None])
    o_j = np.where(in_ll, (np.arange(w)[None, :] % 2) * ll_w
                   + (np.arange(w)[None, :] // 2) * 2,
                   2 * np.arange(w)[None, :])
    o_i = np.broadcast_to(o_i, (h, w))
    o_j = np.broadcast_to(o_j, (h, w))

    K, I, J = np.meshgrid(
        np.arange(c), np.arange(h), np.arange(w), indexing="ij"
    )
    flat = lambda x: np.broadcast_to(x, (c, h, w)).reshape(-1)
    Kf, If, Jf = K.reshape(-1), I.reshape(-1), J.reshape(-1)
    Mf, Df, Gf = M.reshape(-1), D.reshape(-1), G.reshape(-1)
    ESf, ECf = es.reshape(-1), ec.reshape(-1)
    in_ll_f = flat(in_ll[None])
    init_set_f = flat(initial_set[None])
    hg_f = flat(hg_raw[None])
    oif, ojf = flat(o_i[None]), flat(o_j[None])
    # parent cell index of each cell (for cascade path construction)
    pidx = (Kf * h + flat(par_i[None])) * w + flat(par_j[None])

    def raster_rank(mask):
        order = np.lexsort((Kf, Jf, If))
        sel = order[mask[order]]
        r = np.full(mask.shape, -1, np.int64)
        r[sel] = np.arange(sel.size)
        return r

    lip_init_rank = raster_rank(in_ll_f)
    a_init_rank = raster_rank(init_set_f)

    INF = max_n + 1
    a_exists = init_set_f | (ESf >= 0)
    a_appendP = np.where(init_set_f, INF, ESf)
    a_appendS = np.where(init_set_f, a_init_rank, -1).astype(np.int64)
    a_fire = np.where(a_exists, Df, -2)
    b_exists = a_exists & (Df >= 0) & hg_f
    b_appendP = np.where(b_exists, Df, -2)
    b_appendS = np.full(b_appendP.shape, -1, np.int64)
    b_fire = np.where(b_exists, Gf, -2)

    lip_added = (ECf >= 0) & (Mf < ECf)
    lip_exists = in_ll_f | lip_added
    lip_appendP = np.where(in_ll_f, INF, np.where(lip_added, ECf, -2))
    lip_appendS = np.where(in_ll_f, lip_init_rank, -1).astype(np.int64)
    lip_hi = np.where(in_ll_f, max_n, ECf - 1)

    sig = (in_ll_f | (ECf >= 0)) & (Mf >= 0)
    lsp_key = np.full((Kf.size, 3), 2**60, np.int64)

    events: List[Tuple[int, int, int, int, int]] = []

    for n in range(max_n, -1, -1):
        # LIP pass (unchanged)
        present = lip_exists & (np.maximum(Mf, 0) <= n) & (n <= lip_hi)
        idx = np.flatnonzero(present)
        order = np.lexsort((lip_appendS[idx], -lip_appendP[idx]))
        idx = idx[order]
        for pos, t in enumerate(idx):
            events.append((0, Kf[t], If[t], Jf[t], n))
            if Mf[t] == n:
                events.append((1, Kf[t], If[t], Jf[t], n))
                lsp_key[t] = (max_n - n, 0, pos)

        # ---- LIS: single-sort path-key construction ----
        a_present = a_exists & (np.maximum(a_fire, 0) <= n) & (
            n <= np.where(init_set_f, max_n, ESf)
        )
        b_present = b_exists & (np.maximum(b_fire, 0) <= n) & (n <= b_appendP)
        roots_a = np.flatnonzero(a_present & (a_appendP > n))
        roots_b = np.flatnonzero(b_present & (b_appendP > n))
        typ = np.concatenate([np.zeros(roots_a.size, np.int64),
                              np.ones(roots_b.size, np.int64)])
        ridx = np.concatenate([roots_a, roots_b])
        rp = np.concatenate([a_appendP[roots_a], b_appendP[roots_b]])
        rs = np.concatenate([a_appendS[roots_a], b_appendS[roots_b]])
        order = np.lexsort((typ, rs, -rp))
        ridx, typ = ridx[order], typ[order]

        # paths: dict entity->(path tuple); roots get (rank,)
        a_path = {}
        b_path = {}
        for rank, (t, ty) in enumerate(zip(ridx.tolist(), typ.tolist())):
            (a_path if ty == 0 else b_path)[t] = (rank,)
        # cascade closure: iterate until no new nodes (depth-bounded)
        changed = True
        while changed:
            changed = False
            # B appended by own A fire this plane
            for t in np.flatnonzero(b_exists & (b_appendP == n)):
                if t in b_path or t not in a_path:
                    continue
                if a_fire[t] == n:
                    b_path[t] = a_path[t] + (0,)
                    changed = True
            # A children appended by parent B fire this plane
            for t in np.flatnonzero(a_exists & (a_appendP == n)):
                if t in a_path:
                    continue
                pt_ = pidx[t]
                if pt_ in b_path and b_fire[pt_] == n:
                    # slot = position within the parent's offspring block
                    di = If[t] - oif[pt_]
                    dj = Jf[t] - ojf[pt_]
                    slot = int(di * 2 + dj)
                    a_path[t] = b_path[pt_] + (1 + slot,)
                    changed = True
        # single sort by (depth, path) over ALL nodes
        seq = []
        for t, p in a_path.items():
            seq.append(((len(p), p), t, 0))
        for t, p in b_path.items():
            seq.append(((len(p), p), t, 1))
        seq.sort(key=lambda z: z[0])
        a_pos = {}
        b_pos = {}
        for pos, (_, t, ty) in enumerate(seq):
            if ty == 0:
                a_pos[t] = pos
                if a_appendP[t] == n:
                    a_appendS[t] = pos
            else:
                b_pos[t] = pos
                if b_appendP[t] == n:
                    b_appendS[t] = pos
        for _, t, ty in seq:
            k, i, j = Kf[t], If[t], Jf[t]
            if ty == 0:
                events.append((2, k, i, j, n))
                if a_fire[t] == n:
                    oi, oj = oif[t], ojf[t]
                    for slot, (ci, cj) in enumerate(
                        ((oi, oj), (oi, oj + 1), (oi + 1, oj), (oi + 1, oj + 1))
                    ):
                        cidx = (k * h + ci) * w + cj
                        events.append((3, k, ci, cj, n))
                        if Mf[cidx] == n:
                            events.append((4, k, ci, cj, n))
                            lsp_key[cidx] = (max_n - n, 1, a_pos[t] * 4 + slot)
                        elif lip_added[cidx]:
                            lip_appendS[cidx] = a_pos[t] * 4 + slot
            else:
                events.append((5, k, i, j, n))

        ridx2 = np.flatnonzero(sig & (Mf > n))
        order = np.lexsort(
            (lsp_key[ridx2, 2], lsp_key[ridx2, 1], lsp_key[ridx2, 0])
        )
        for t in ridx2[order]:
            events.append((6, Kf[t], If[t], Jf[t], n))

    return events


def predict_bits(arr: np.ndarray, ll_h: int, ll_w: int, max_n: int):
    """The exact full bitstream, reconstructed without running an encoder.

    Each predicted event's bit value is a one-comparison function of the
    maps / coefficients:
      test actions (0/2/3/5): level >= n for M / D / M / G respectively;
      signs (1/4): x >= 0; refinement (6): bit n of |x|.
    A max_bits stream is simply the prefix. Together with predict_events
    this demonstrates the whole encoder as sorts + elementwise ops.
    """
    M8, D8, G8 = _maps_np(arr, ll_h, ll_w)
    arr64 = arr.astype(np.int64)
    bits = []
    for a, k, i, j, n in predict_events(arr, ll_h, ll_w, max_n):
        if a == 0 or a == 3:
            bits.append(M8[k, i, j] >= n)
        elif a == 2:
            bits.append(D8[k, i, j] >= n)
        elif a == 5:
            bits.append(G8[k, i, j] >= n)
        elif a == 1 or a == 4:
            bits.append(arr64[k, i, j] >= 0)
        else:
            bits.append((abs(int(arr64[k, i, j])) >> n) & 1 == 1)
    return bits
