"""The sorted-space encode machine in torch, the port of
``spiht_tpu/codec/device_encoder.py`` (``CapacityOverflow`` :88, ``_geom``
:105, ``_pack_lanes`` :205, ``_sort_payload`` :245, ``_build`` :292,
``_cap_words`` :633, ``encode_device_fn`` :686, ``encode_device`` :705,
``_use_pallas_emitter`` :747, ``encode_device_batch`` :772).

The machine has no queues. It computes the whole stream, values and
order, from the coefficients' significance maps with closed forms: entry
planes propagated down the tree, cascade roots found once per image, and
per plane three packed-key sorts (LIP, LIS, refinement) whose payload
lanes carry each entity's bit group below its rank key. Bit offsets are
exclusive cumsums of the group lengths in sorted order; one scatter-add
a channel writes the groups into the words. No Pallas kernel computes
it: the JAX package runs it as XLA ops, and the port as torch ops on the
tensors' device, the card or the CPU.

* ``_sort_payload`` sorts lexicographically over several 31-bit lanes.
  torch has no sort with several keys, so two lanes pack into one int64
  key, and more lanes sort a pair at a time, least significant first,
  with ``torch.sort(stable=True)``. The key tuple totally orders the
  present entities, so the order is unique. The machine's lane counts
  are ``_build(...).lanes``.
* The words are uint32 in the JAX package. Here they are int64 while
  the machine runs: the groups' bits do not overlap, so the scatter-add
  is an OR and no carry crosses a word; the result is masked to 32 bits
  and returned as int32 (the port's word type). All other state is int32,
  as in the reference, so saturation and wrapping give the same numbers.
* ``encode_device_batch`` runs B streams in lockstep, with a leading
  batch dimension: one pass of the plane body steps all B, and a stream
  whose loop has ended is left as it was (the select ``jax.vmap`` adds).

Routing (``encode_device``, ``encode_device_batch``): with
``SPIHT_TPU_PALLAS_ENCODER=1`` the hand-written kernel runs (B1, or for a
batch ``encoder.pallas_encode_batch``, as the reference routes it: B4,
under the batch switches B4 in chunks or B1 stream by stream; on CPU
tensors the plain versions), with ``=0`` this machine runs on the device
asked for, and unset the kernel runs on the card and the machine on the
CPU (the reference's CPU route). The reference's
c*h*w < 2^24 gate for the Pallas emitter is not copied: B1 takes
c*h*w < 2^29. ``SPIHT_TPU_DISABLE_HBM_MACHINES`` means nothing here: the
card has no VMEM/HBM split. Nothing falls back: a machine that
overflows raises ``CapacityOverflow``, and the kernel raises on its own
errors. The pipelines of ``torch_transform.py`` stay on the kernels;
``codec/api.py``'s raw ``encode`` comes here under
``SPIHT_TPU_DEVICE_ENCODER=1``, as the reference's does.

Even LL dims only (``_geom`` raises ``ValueError`` otherwise): with odd
LL the parity child map is not injective, so the parent gathers do not
apply. Every entry first refuses what the native scheduler refuses
(``encoder.check_geometry``: LL dims of 1, or a level-0 "pyramid"), with
``ValueError``; the reference's XLA route returns a stream there.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device, use_kernel
from . import encoder
from .maps import significance_maps, tree_height
from .maxn import device_max_n
from .planning import _static_geometry

__all__ = [
    "encode_device",
    "encode_device_fn",
    "encode_device_batch",
    "CapacityOverflow",
]

_I32 = torch.int32

# Default output capacity in bits per coefficient: the machine's own (B1
# sizes its buffer from the budget instead). Not a proven worst case, so
# every emit is guarded by `pos < cap_bits` and the machine returns the
# true length; the wrappers raise CapacityOverflow instead of truncating.
_CAP_BITS_PER_CELL = 48


class CapacityOverflow(RuntimeError):
    """The stream needs more bits than the machine's buffer holds."""

    def __init__(self, needed: int, cap: int):
        super().__init__(
            f"device encoder capacity exceeded: stream needs {needed} bits,"
            f" buffer holds {cap}"
        )
        self.needed = needed
        self.cap = cap


@lru_cache(maxsize=None)
def _geom(c: int, h: int, w: int, ll_h: int, ll_w: int):
    """Static flattened entity geometry (numpy): parent, offspring and
    slot maps, initial ranks, tree depth and packed quadtree paths.

    Requires even LL dims: with odd LL dims the parity child map is
    non-injective (one cell can have two tree parents), so the
    parent-gather formulation does not apply.
    """
    if ll_h % 2 != 0 or ll_w % 2 != 0:
        raise ValueError("device encoder requires even ll dims")
    (in_ll, initial_set, par_i, par_j, has_parent, hg_raw, _) = (
        _static_geometry(h, w, ll_h, ll_w)
    )
    K, I, J = np.meshgrid(
        np.arange(c), np.arange(h), np.arange(w), indexing="ij"
    )
    Kf = K.reshape(-1).astype(np.int32)
    If = I.reshape(-1).astype(np.int32)
    Jf = J.reshape(-1).astype(np.int32)

    def flat(x):
        return np.broadcast_to(x, (c, h, w)).reshape(-1)

    in_ll_f = flat(in_ll[None])
    init_set_f = flat(initial_set[None])
    hg_f = flat(hg_raw[None])
    hp_f = flat(has_parent[None])

    ii = np.arange(h)[:, None]
    jj = np.arange(w)[None, :]
    o_i = np.where(in_ll, (ii % 2) * ll_h + (ii // 2) * 2, 2 * ii)
    o_j = np.where(in_ll, (jj % 2) * ll_w + (jj // 2) * 2, 2 * jj)
    o_i = np.broadcast_to(o_i, (h, w))
    o_j = np.broadcast_to(o_j, (h, w))
    oif = flat(o_i[None]).astype(np.int64)
    ojf = flat(o_j[None]).astype(np.int64)
    # flat indices of the 4 offspring (clipped where out of range; callers
    # mask by fire conditions which imply validity)
    oi_c = np.clip(oif, 0, h - 2)
    oj_c = np.clip(ojf, 0, w - 2)
    base = Kf.astype(np.int64) * h * w
    child = np.stack(
        [
            base + oi_c * w + oj_c,
            base + oi_c * w + oj_c + 1,
            base + (oi_c + 1) * w + oj_c,
            base + (oi_c + 1) * w + oj_c + 1,
        ],
        axis=1,
    ).astype(np.int32)

    pidx = (
        Kf.astype(np.int64) * h * w
        + flat(par_i[None]).astype(np.int64) * w
        + flat(par_j[None]).astype(np.int64)
    ).astype(np.int32)
    # slot of each cell within its parent's offspring block
    slot = ((If - oif[pidx]) * 2 + (Jf - ojf[pidx])).astype(np.int32)
    slot = np.clip(slot, 0, 3)

    def raster_rank(mask):
        order = np.lexsort((Kf, Jf, If))
        sel = order[mask[order]]
        r = np.full(mask.shape, -1, np.int64)
        r[sel] = np.arange(sel.size)
        return r.astype(np.int32)

    th = tree_height(h, w, ll_h, ll_w)
    # static tree depth + packed root-relative path (2 bits per level):
    # within one plane's cascade the worklist (BFS) order of two entities
    # under one root is decided by their first differing child slot
    tdepth = np.zeros(c * h * w, np.int32)
    path_abs = np.zeros(c * h * w, np.int64)
    for _ in range(th + 1):
        tdepth = np.where(hp_f, tdepth[pidx] + 1, 0).astype(np.int32)
        path_abs = np.where(hp_f, path_abs[pidx] * 4 + slot, 0)
    if int(tdepth.max(initial=0)) * 2 > 31:
        raise ValueError("tree too deep for packed int32 path keys")
    return dict(
        in_ll=in_ll_f.copy(),
        init_set=init_set_f.copy(),
        hg=hg_f.copy(),
        hp=hp_f.copy(),
        child=child,
        pidx=pidx,
        slot=slot,
        lip_init_rank=raster_rank(in_ll_f),
        a_init_rank=raster_rank(init_set_f),
        tdepth=tdepth,
        path=path_abs.astype(np.int32),
        bits_path=max(1, 2 * int(tdepth.max(initial=0))),
        tree_height=th,
    )


@lru_cache(maxsize=8)
def _geom_tensors(c, h, w, ll_h, ll_w, device: torch.device) -> dict:
    """``_geom``'s arrays on ``device``: masks bool, maps int32, and the
    gather indices ``pidx``/``child`` also as int64."""
    g = _geom(c, h, w, ll_h, ll_w)
    t = {
        k: torch.as_tensor(v, device=device)
        for k, v in g.items() if isinstance(v, np.ndarray)
    }
    t["pidx_l"] = t["pidx"].long()
    t["child_l"] = t["child"].long()
    return t


def _pack_lanes(fields, n):
    """Bit-concatenate (arr, nbits, tag) fields into minimal 31-bit int32
    sort lanes, SPLITTING fields across lane boundaries (the high
    fragment lands in the earlier lane, so lexicographic lane comparison
    equals comparison of the full concatenated bit string). Returns
    (lanes, placements, widths): placements[tag] is a list of
    (lane_idx, bits_above_in_lane, take, src_lo) fragments from which
    the field can be re-extracted after sorting. The arrays are int32
    tensors of one shape, ``n`` their last dim.
    """
    lane_parts, widths = [], []
    cur_parts, curbits = [], 0
    placements = {}
    for arr, nb, tag in fields:
        rem = nb
        while rem > 0:
            take = min(31 - curbits, rem)
            src_lo = rem - take
            cur_parts.append((arr, take, src_lo))
            placements.setdefault(tag, []).append(
                (len(lane_parts), curbits, take, src_lo)
            )
            curbits += take
            rem -= take
            if curbits == 31:
                lane_parts.append(cur_parts)
                widths.append(curbits)
                cur_parts, curbits = [], 0
    if curbits:
        lane_parts.append(cur_parts)
        widths.append(curbits)
    lanes = []
    for parts in lane_parts:
        cur = torch.zeros(
            fields[0][0].shape[:-1] + (n,), dtype=_I32,
            device=fields[0][0].device,
        )
        for arr, take, src_lo in parts:
            part = (arr >> src_lo) & ((1 << take) - 1)
            cur = (cur << take) | part
        lanes.append(cur)
    return lanes, placements, widths


def _lex_sort(lanes):
    """The lanes (int32 in [0, 2^31), sorted along the last dim) in the
    lexicographic order of the lane tuple, lane 0 most significant: a
    stable sort per pair of lanes packed into one int64 key, least
    significant pair first."""
    keys = []
    j = len(lanes)
    while j > 0:
        i = max(j - 2, 0)
        key = lanes[i].long()
        if j - i == 2:
            key = (key << 31) | lanes[i + 1].long()
        keys.append(key)
        j = i
    perm = None
    for key in keys:
        if perm is not None:
            key = key.gather(-1, perm)
        p = torch.sort(key, dim=-1, stable=True).indices
        perm = p if perm is None else perm.gather(-1, p)
    return [lane.gather(-1, perm) for lane in lanes]


def _sort_payload(keys_bits, payload_bits, present):
    """Sorted-space rank: sort present entities by packed keys and return
    the payload fields IN SORTED ORDER (plus the present count), along
    the last dim.

    keys_bits / payload_bits: lists of (int32 tensor, bit width) pairs,
    most significant first; values are clipped to the stated width.
    REQUIREMENT: the key tuple must totally order the present entities
    (no ties): payload bits are packed BELOW the key bits in the same
    sort lanes. Every caller's key ends in a distinct per-entity sequence
    field. Absent entities sort after all present ones; their payload
    values are whatever the caller packed (callers mask by slot < cnt).
    """
    n = keys_bits[0][0].shape[-1]
    fields = [((~present).to(_I32), 1, "_p")]
    for k, (a, nb) in enumerate(keys_bits):
        fields.append((torch.clamp(a.to(_I32), 0, (1 << nb) - 1), nb,
                       f"_k{k}"))
    tags = []
    for k, (a, nb) in enumerate(payload_bits):
        t = f"v{k}"
        tags.append(t)
        fields.append((torch.clamp(a.to(_I32), 0, (1 << nb) - 1), nb, t))
    lanes, plc, widths = _pack_lanes(fields, n)
    s = _lex_sort(lanes)
    outs = []
    for t in tags:
        v = torch.zeros_like(s[0])
        for lane, above, take, src_lo in plc[t]:
            shift = widths[lane] - above - take
            frag = (s[lane] >> shift) & ((1 << take) - 1)
            v = v | (frag << src_lo)
        outs.append(v)
    return outs, present.sum(-1, dtype=_I32)


def _n_lanes(*widths) -> int:
    """Lanes ``_pack_lanes`` makes of fields of these widths."""
    return (sum(widths) + 30) // 31


def _build(c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int):
    """The machine for one geometry: ``encode(arrs, max_n, max_bits)`` on
    an int32 (B, c, h, w) batch and int32 (B,) tensors on its device ->
    (words int32 (B, cap_words) LSB-first, total (B,) int32, overflow
    (B,) bool). ``encode.lanes`` counts each sort's lanes, ``encode.
    planes`` the plane-loop passes of its last call."""
    g = _geom(c, h, w, ll_h, ll_w)
    N = c * h * w
    cap_bits = cap_words * 32
    # bit-offset saturation point: beyond capacity the exact count no
    # longer matters (the stream is already invalid), so saturate the
    # accumulator to keep int32 arithmetic overflow-free. Per-plane bit
    # counts are bounded by 14*N, so sat + 14*N must stay below 2^31.
    sat = cap_bits + (1 << 20)
    if sat + 14 * N >= 2**31:
        raise ValueError(
            "device encoder geometry too large for int32 bit offsets"
        )
    th = g["tree_height"]
    # packed sort-key widths
    bits_S = max((2 * N - 1).bit_length(), 1)  # worklist positions < 2N
    bits_listS = max((8 * N + 3).bit_length(), 1)  # list keys < 8N+4
    bits_path = g["bits_path"]

    def encode(arrs, max_n, max_bits):
        dev = arrs.device
        t = _geom_tensors(c, h, w, ll_h, ll_w, dev)
        pidx = t["pidx_l"]
        B = arrs.shape[0]
        arrs = arrs.to(_I32)
        af = arrs.reshape(B, N)
        m, d, gg = significance_maps(arrs, ll_h, ll_w)
        M = m.reshape(B, N).to(_I32)
        D = d.reshape(B, N).to(_I32)
        G = gg.reshape(B, N).to(_I32)
        mx = max_n.to(_I32)[:, None]  # (B, 1)
        max_bits = max_bits.to(_I32)
        INF = mx + 1
        init_set, in_ll, hp = t["init_set"], t["in_ll"], t["hp"]
        hg, tdepth = t["hg"], t["tdepth"]

        def full(v):
            return torch.full((B, N), v, dtype=_I32, device=dev)

        # ---- ES / EC propagation ------------------------------------------
        es = torch.where(init_set, mx, -1)
        for _ in range(th):
            pes = es[:, pidx]
            pg = G[:, pidx]
            child_es = torch.where(
                hp & (pes >= 0) & hg[pidx] & (pg >= 0), pg, -1
            )
            es = torch.where(init_set, mx, child_es)
        pes = es[:, pidx]
        pd = D[:, pidx]
        ec = torch.where(hp & (pes >= 0) & (pd >= 0), pd, -1)

        a_exists = init_set | (es >= 0)
        a_appendP = torch.where(init_set, INF, es)
        a_fire = torch.where(a_exists, D, -2)
        b_exists = a_exists & (D >= 0) & hg
        b_appendP = torch.where(b_exists, D, -2)
        b_fire = torch.where(b_exists, G, -2)

        lip_added = (ec >= 0) & (M < ec)
        lip_exists = in_ll | lip_added
        lip_appendP = torch.where(
            in_ll, INF, torch.where(lip_added, ec, -2)
        )
        lip_hi = torch.where(in_ll, mx, ec - 1)
        sig = (in_ll | (ec >= 0)) & (M >= 0)

        child = t["child_l"]
        child_M = M[:, child]  # (B, N, 4)
        child_neg = af[:, child] >= 0

        # ---- cascade roots, once per image (see the reference's notes:
        # join planes are non-decreasing up the worklist-ancestor chain,
        # so a plane's cascade root is a plane-independent instance) -------
        aPb_p = b_appendP[:, pidx]
        td_p = tdepth[pidx].expand(B, N)
        idxN = torch.arange(N, dtype=_I32, device=dev).expand(B, N)
        pidxN = (t["pidx"] + N).expand(B, N)
        tdB = tdepth.expand(B, N)
        zero, one = full(0), full(1)
        R_a = PR_a = tdR_a = TR_a = zero
        for _ in range(th + 1):
            cond_b = a_appendP > b_appendP  # A-inst of same node is root
            R_b = torch.where(cond_b, idxN, R_a)
            PR_b = torch.where(cond_b, a_appendP, PR_a)
            tdR_b = torch.where(cond_b, tdB, tdR_a)
            TR_b = torch.where(cond_b, zero, TR_a)
            cond_a = aPb_p > a_appendP  # parent B-inst is root
            R_a = torch.where(cond_a, pidxN, R_b[:, pidx])
            PR_a = torch.where(cond_a, aPb_p, PR_b[:, pidx])
            tdR_a = torch.where(cond_a, td_p, tdR_b[:, pidx])
            TR_a = torch.where(cond_a, one, TR_b[:, pidx])
        R2 = torch.cat([R_a, R_b], 1).long()
        PR2 = torch.cat([PR_a, PR_b], 1)
        tdR2 = torch.cat([tdR_a, tdR_b], 1)
        TR2 = torch.cat([TR_a, TR_b], 1)
        aP2 = torch.cat([a_appendP, b_appendP], 1)
        td2 = torch.cat([tdB, tdB], 1)
        typ2 = torch.cat([zero, one], 1)
        inst2 = torch.arange(2 * N, dtype=_I32, device=dev).expand(B, 2 * N)
        path2 = torch.cat([t["path"], t["path"]]).expand(B, 2 * N)
        # hoisted parent data for the LIP/LSP append-key updates
        aFIRE_p = a_fire[:, pidx]
        aEX_p = a_exists[:, pidx]
        aES_p = torch.where(init_set[pidx], mx, es[:, pidx])
        slot = t["slot"]
        arangeN = torch.arange(N, dtype=_I32, device=dev)
        arange2N = torch.arange(2 * N, dtype=_I32, device=dev).expand(B, -1)

        # ---- plane loop ----------------------------------------------------
        words = torch.zeros((B, cap_words), dtype=torch.int64, device=dev)
        i = torch.zeros(B, dtype=_I32, device=dev)
        a_S = torch.where(init_set, t["a_init_rank"], -1).expand(B, N)
        b_S = full(-1)
        lip_S = torch.where(in_ll, t["lip_init_rank"], -1).expand(B, N)
        lsp_phase = full(0)
        lsp_S = full(0)
        off = torch.zeros(B, dtype=_I32, device=dev)
        limit = torch.clamp(max_bits, max=cap_bits)[:, None]

        def group_parts(off_s, group_s, lo_only=False):
            """(word index, contribution) scatter operands of one bit
            group per sorted slot at monotone offsets: the low word and
            (unless lo_only) the high word the group may straddle. Only
            bits below `limit` are kept (the budget and capacity guard);
            word indices are clipped, out-of-range bits already zeroed."""
            keep = torch.clamp(limit - off_s, 0, 16)
            grp = (group_s & ((1 << keep) - 1)).long()
            wd = torch.clamp(off_s >> 5, 0, cap_words - 1).long()
            sh = (off_s & 31).long()
            parts = [(wd, (grp << sh) & 0xFFFFFFFF)]
            if not lo_only:
                # groups are < 16 bits, so grp >> 31 == 0 covers sh == 0
                hi = grp >> (32 - torch.clamp(sh, min=1))
                parts.append((torch.clamp(wd + 1, max=cap_words - 1), hi))
            return parts

        planes = 0
        while True:
            active = (i <= max_n) & (off < max_bits)
            if not bool(active.any()):
                break
            planes += 1
            act = active[:, None]
            n = (max_n - i)[:, None]
            offc = off[:, None]
            parts = []

            # ---------------- LIP pass ----------------
            lp = (
                lip_exists & (torch.clamp(M, min=0) <= n) & (n <= lip_hi)
                & (lip_S >= 0)
            )
            fires_lip = lp & (M == n)
            # bit group per cell: [test, sign-if-firing]; LSB = first bit
            lip_group = (lp & (M >= n)).to(_I32) | torch.where(
                fires_lip & (af >= 0), 2, 0
            )
            (g_s, f_s), lip_cnt = _sort_payload(
                [(40 - lip_appendP, 6), (lip_S, bits_listS)],
                [(lip_group, 2), (fires_lip.to(_I32), 1)],
                lp,
            )
            v_s = arangeN < lip_cnt[:, None]
            glen_s = torch.where(v_s, 1 + f_s, 0)
            off_s = offc + torch.cumsum(glen_s, 1, dtype=_I32) - glen_s
            parts += group_parts(off_s, torch.where(v_s, g_s, 0))
            lip_bits = lip_cnt + fires_lip.sum(1, dtype=_I32)
            off1 = torch.clamp(off + lip_bits, max=sat)

            # ---------------- LIS pass ----------------
            a_pres = (
                a_exists & (torch.clamp(a_fire, min=0) <= n)
                & (n <= torch.where(init_set, mx, es))
            )
            b_pres = (
                b_exists & (torch.clamp(b_fire, min=0) <= n)
                & (n <= b_appendP)
            )
            a_fireN = a_pres & (a_fire == n)
            in2 = torch.cat([a_pres, b_pres], 1)
            selfroot = aP2 > n
            S2all = torch.cat([a_S, b_S], 1)
            SR = S2all.gather(1, R2)
            rootP = torch.where(selfroot, aP2, PR2)
            rootS = torch.where(selfroot, S2all, SR)
            rootT = torch.where(selfroot, typ2, TR2)
            tdR_eff = torch.where(selfroot, td2, tdR2)
            # worklist (BFS) depth: A instance k levels below its root at
            # 2k - [root is a B entry]; its B instance one deeper
            depth2 = 2 * (td2 - tdR_eff) + typ2 - rootT

            # per-entity bit counts and LSB-first bit groups:
            # A: [desc test, per child: test, sign-if-firing]; B: [l-sig]
            child_at_n = child_M == n[:, :, None]
            signs = torch.where(a_fireN, child_at_n.sum(2, dtype=_I32), 0)
            a_bits = torch.where(
                a_pres, 1 + torch.where(a_fireN, 4 + signs, 0), 0
            )
            b_bits = b_pres.to(_I32)
            bits2 = torch.cat([a_bits, b_bits], 1)
            child_sign = child_at_n & a_fireN[:, :, None]
            child_sz = 1 + child_sign.to(_I32)
            intra = torch.cumsum(child_sz, 2, dtype=_I32) - child_sz
            a_group = (a_pres & (D >= n)).to(_I32)
            for s in range(4):
                tst = (child_M[:, :, s] >= n) & a_fireN
                a_group = a_group | (tst.to(_I32) << (1 + intra[:, :, s]))
                sgn = child_sign[:, :, s] & child_neg[:, :, s]
                a_group = a_group | (sgn.to(_I32) << (2 + intra[:, :, s]))
            b_group = (b_pres & (G >= n)).to(_I32)
            group2 = torch.cat([a_group, b_group], 1)

            (g2_s, gl2_s, idx_s), _ = _sort_payload(
                [
                    (depth2, 6),
                    (40 - rootP, 6),
                    (rootS * 2 + rootT, bits_S + 1),
                    (path2, bits_path),
                ],
                [(group2, 9), (bits2, 4), (inst2, bits_S)],
                in2,
            )
            # entity-space positions: the one rank-inversion scatter (idx_s
            # is a permutation of the 2N instances, so it is in range)
            pos2 = torch.empty_like(idx_s).scatter_(1, idx_s.long(), arange2N)
            a_pos = pos2[:, :N]
            b_pos = pos2[:, N:]
            # absent slots carry bits2 == 0, so the cumsum is unpolluted
            off1c = off1[:, None]
            off2_s = off1c + torch.cumsum(gl2_s, 1, dtype=_I32) - gl2_s
            parts += group_parts(off2_s, g2_s)
            lis_bits = bits2.sum(1, dtype=_I32)

            # carries for appended entities: appendS = processing position
            a_appN = a_exists & (a_appendP == n)
            b_appN = b_exists & (b_appendP == n)
            a_S_new = torch.where(a_appN & a_pres, a_pos, a_S)
            b_S_new = torch.where(b_appN & b_pres, b_pos, b_S)
            # LIP additions: non-significant offspring of A fires
            parent_fire = aEX_p & (aFIRE_p == n) & (n <= aES_p)
            added_now = lip_added & (ec == n) & parent_fire
            par_key = a_pos[:, pidx] * 4 + slot
            lip_S_new = torch.where(added_now, par_key, lip_S)
            # straight-to-LSP offspring (phase 1)
            to_lsp = (ec == n) & (M == n) & parent_fire
            lsp_phase_new = torch.where(to_lsp, 1, lsp_phase)
            lsp_S_new = torch.where(to_lsp, par_key, lsp_S)
            off2 = torch.clamp(off1 + lis_bits, max=sat)

            # ---------------- refinement ----------------
            # LSP order: by fire plane, LIP-fired (phase 0, by the carried
            # LIP key, order-isomorphic to the LIP rank) before LIS-fired
            # (phase 1, by parent position * 4 + slot)
            rp = sig & (M > n)
            ref_bit = rp & (((torch.abs(af) >> n) & 1) == 1)
            ph0 = lsp_phase_new == 0
            k1 = torch.where(ph0, 40 - lip_appendP, 0)
            k2 = torch.where(ph0, lip_S_new, lsp_S_new)
            (rb_s,), r_cnt = _sort_payload(
                [(mx - M, 5), (lsp_phase_new, 1), (k1, 6),
                 (k2, bits_listS)],
                [(ref_bit.to(_I32), 1)],
                rp,
            )
            # 1-bit groups at dense offsets; absent slots carry bit 0
            off_r = off2[:, None] + arangeN
            parts += group_parts(off_r, rb_s, lo_only=True)
            off3 = torch.clamp(off2 + r_cnt, max=sat)

            # 5 scatter-adds; a finished stream adds nothing
            for wd, contrib in parts:
                words.scatter_add_(1, wd, torch.where(act, contrib, 0))
            a_S = torch.where(act, a_S_new, a_S)
            b_S = torch.where(act, b_S_new, b_S)
            lip_S = torch.where(act, lip_S_new, lip_S)
            lsp_phase = torch.where(act, lsp_phase_new, lsp_phase)
            lsp_S = torch.where(act, lsp_S_new, lsp_S)
            off = torch.where(active, off3, off)
            i = torch.where(active, i + 1, i)

        encode.planes = planes
        total = torch.minimum(off, max_bits)
        # in-budget bits beyond the buffer were dropped by the
        # `pos < cap_bits` guard -> the stream is invalid; flag it
        overflow = total > cap_bits
        return (words & 0xFFFFFFFF).to(_I32), total, overflow

    encode.lanes = dict(
        lip=_n_lanes(1, 6, bits_listS, 2, 1),
        lis=_n_lanes(1, 6, 6, bits_S + 1, bits_path, 9, 4, bits_S),
        ref=_n_lanes(1, 5, 1, 6, bits_listS, 1),
    )
    encode.planes = 0
    return encode


def _cap_words(c: int, h: int, w: int, bits_per_cell: int) -> int:
    cap_bits = c * h * w * bits_per_cell + 1024
    return (cap_bits + 31) // 32


@lru_cache(maxsize=8)
def _machine(c, h, w, ll_h, ll_w, bits_per_cell):
    return _build(c, h, w, ll_h, ll_w, _cap_words(c, h, w, bits_per_cell))


def encode_device_fn(
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    bits_per_cell: int = _CAP_BITS_PER_CELL,
):
    """The machine for one geometry, for one stream.

    Returns fn(arr_i32 (c, h, w), max_n, max_bits) -> (int32 words
    LSB-first, total_bits, overflow), tensors on the array's device.
    `overflow` true means in-budget bits did not fit the buffer and were
    dropped: the stream is invalid (see CapacityOverflow). ``fn.machine``
    is the batched machine it runs. A geometry the native scheduler
    refuses raises ``ValueError`` (``encoder.check_geometry``).
    """
    encoder.check_geometry(c, h, w, ll_h, ll_w)
    machine = _machine(c, h, w, ll_h, ll_w, bits_per_cell)

    def fn(arr, max_n, max_bits):
        dev = arr.device
        words, total, overflow = machine(
            arr[None],
            torch.as_tensor(max_n, dtype=_I32, device=dev).reshape(1),
            torch.as_tensor(max_bits, dtype=_I32, device=dev).reshape(1),
        )
        return words[0], total[0], overflow[0]

    fn.machine = machine
    return fn


def encode_device(
    arr, ll_h: int, ll_w: int, max_bits: int, device=None,
) -> Tuple[bytes, int]:
    """(bytes, max_n) of a (c, h, w) int32 coefficient array (numpy or
    tensor) on ``device`` (None: the card), routed by
    ``SPIHT_TPU_PALLAS_ENCODER`` (module docstring): kernel B1, or this
    machine. max_n follows the reference's float32 rule
    (``maxn.device_max_n``)."""
    encoder.check_geometry(*np.shape(arr), ll_h, ll_w)
    dev = resolve_device(device)
    arr = encoder._as_coeffs(arr, dev)
    if use_kernel("SPIHT_TPU_PALLAS_ENCODER", dev):
        return encoder.encode(arr, ll_h, ll_w, max_bits, dev)
    c, h, w = arr.shape
    max_n = device_max_n(arr)
    fn = encode_device_fn(c, h, w, ll_h, ll_w)
    words, total, overflow = fn(arr, max_n, min(int(max_bits), 2**31 - 2))
    total = int(total)
    if bool(overflow):
        raise CapacityOverflow(
            total, _cap_words(c, h, w, _CAP_BITS_PER_CELL) * 32
        )
    return encoder.stream_bytes(words, total), int(max_n)


def encode_device_batch(
    arrs, ll_h: int, ll_w: int, max_bits, device=None,
) -> list:
    """[(bytes, max_n)] of a (B, c, h, w) int32 batch (numpy or tensor) on
    ``device`` (None: the card), routed by ``SPIHT_TPU_PALLAS_ENCODER``:
    ``encoder.pallas_encode_batch`` (kernel B4, or what the batch and
    machine switches route to), or this machine over B streams in
    lockstep. max_bits: one budget or one per stream."""
    encoder.check_geometry(*np.shape(arrs)[1:], ll_h, ll_w)
    dev = resolve_device(device)
    arrs = encoder._as_coeffs(arrs, dev)
    B, c, h, w = arrs.shape
    if use_kernel("SPIHT_TPU_PALLAS_ENCODER", dev):
        return encoder.pallas_encode_batch(arrs, ll_h, ll_w, max_bits,
                                           device=dev)
    if np.isscalar(max_bits):
        mbs = [min(int(max_bits), 2**31 - 2)] * B
    else:
        mbs = [min(int(m), 2**31 - 2) for m in max_bits]
    mns = device_max_n(arrs)
    machine = _machine(c, h, w, ll_h, ll_w, _CAP_BITS_PER_CELL)
    words, totals, overflows = machine(
        arrs, mns, torch.tensor(mbs, dtype=_I32).to(dev)
    )
    totals = totals.tolist()
    over = overflows.tolist()
    if any(over):
        b = over.index(True)
        raise CapacityOverflow(
            totals[b], _cap_words(c, h, w, _CAP_BITS_PER_CELL) * 32
        )
    return list(zip(encoder.batch_stream_bytes(words, totals), mns.tolist()))
