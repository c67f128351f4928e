"""The hybrid and sequential decode machines in torch, the port of
``spiht_tpu/codec/device_decoder.py`` (``_build_decoder`` :212,
``_build_hybrid`` :576, ``decode_device_fn`` :924, ``decode_device`` :951,
``_use_pallas_machine`` :994, ``decode_device_with_metadata`` :1014,
``decode_device_batch`` :1071).

* The hybrid machine (plain decode) runs each plane in three sections:
  the LIP section in parallel (a position is a sign bit iff the run of
  1s before it has odd length: one cummax and cumsums classify the
  window, rank scatters route the entries), the LIS worklist as a
  sequential machine that bulk-retains up to ``KB`` unfired entries a
  step and runs the fired one's cascade, and the refinement section in
  parallel over the LSP prefix.
* The sequential machine (``meta_rows > 0``) processes one list entry a
  step and writes the reference's 8-column per-bit trace; its float32
  local positions come from ``meta_expand._local``.

No Pallas kernel computes them: the JAX package runs them as XLA ops, the
port as torch ops on the tensors' device. Both machines run B streams in
lockstep with a leading batch dimension (what ``jax.vmap`` makes of the
reference's loops): one pass of a body steps all B, and a stream whose
loop has ended is left as it was. The ``lax.while_loop`` over list
entries becomes a Python loop over chunks of ``K_STEPS`` steps with one
host check between chunks; every step is masked by its stream's
``active`` flag, so steps past the end change nothing. On the card a
chunk is a CUDA graph, captured at the machine's second chunk (the first
runs eagerly) and replayed after. State lives in persistent tensors that
the steps update in place: a flat queue buffer per stream (the LIP and LIS
double buffers and the LSP, one scratch slot at the end), rec with a
scratch slot at N, and the scalars as int32 columns.

JAX indexing semantics, made explicit: every gather index is clamped
where the reference's gather would clamp; every masked scatter writes to
a scratch slot (never read) when inactive, and its active indices are in
range by the queue bounds of ``tree_bounds.queue_bounds``. The windows
the reference takes with ``lax.dynamic_slice`` are padded so that they
never clamp (checked when the machine is built); they are gathers here,
which raise instead of clamping if that ever failed. The 4-offspring
ladder of a fired type-A entry (up to 8 bits) is one lookup in a table
of its 256 bit windows by bits left (``_ladder_table``), equal to the
reference's bit-by-bit ladder.

Routing (``decode_device``, ``decode_device_batch``,
``decode_device_with_metadata``): with ``SPIHT_TPU_PALLAS_DECODER=1``
(``SPIHT_TPU_PALLAS_META=1`` for the trace, which otherwise follows the
decoder's flag) the hand-written kernel runs: B2, or B3 at odd LL; for a
batch ``decoder.pallas_decode_batch``, as the reference routes it (B5 or
batched B3, under the batch switches in chunks or stream by stream);
B2-log or B3-log through ``meta_expand``. On CPU tensors its
plain version runs. With the flag ``0`` this module's machine runs on the
device asked for; unset, the kernel runs on the card and the machine on
the CPU (the reference's CPU route). ``SPIHT_TPU_DISABLE_HBM_MACHINES``
means nothing here: the card has no VMEM/HBM split. The reference's
c*h*w < 2^26 gate is not copied (the port's kernels take c*h*w < 2^29);
the machines keep their own c*h*w < 2^24 bound. Nothing falls back: an
error raises, and every entry first refuses, with ``ValueError``, what
the native scheduler refuses (``encoder.check_geometry``).
The pipelines of ``torch_transform.py`` stay on the kernels;
``codec/api.py``'s raw ``decode``/``decode_with_metadata`` come here under
``SPIHT_TPU_DEVICE_DECODER=1``, as the reference's do; the
reference's ``machine = "xla"`` branch only catches a VMEM overflow,
which the port cannot have, so it is not ported.
"""

from __future__ import annotations

import gc
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, use_kernel
from . import decoder, meta_expand
from .encoder import check_geometry
from .geom import (
    A_DESC, A_LIP, A_LIPSIGN, A_LSIG, A_OFF, A_OFFSIGN, A_REF, _F_LL,
    dec_geom, rect_table,
)

__all__ = [
    "decode_device",
    "decode_device_with_metadata",
    "decode_device_fn",
    "decode_device_batch",
]

_I32 = torch.int32

# steps of a list-entry loop between two host checks (one CUDA graph)
K_STEPS = 32
# bulk-retention block width of the hybrid's LIS machine
KB = 128


@lru_cache(maxsize=None)
def _ladder_table() -> np.ndarray:
    """The offspring tests and signs of a fired type-A entry with
    children, as the reference's ladder reads them, for every 8-bit window
    ``x`` (bit r: the stream bit r places after the entry's own bit) and
    every count of bits left (0-8; more acts as 8). Entry ``x * 9 +
    left``: okt (bits 0-3, test bit read), bt (4-7, test bit set), oks
    (8-11, sign bit read), bs (12-15, sign bit set), uset (16-19, test
    attempted), bits consumed (20-23), dead (24, a pop found no bit)."""
    tab = np.zeros(256 * 9, np.int32)
    for x in range(256):
        for left in range(9):
            r, dead, v = 0, False, 0
            for k in range(4):
                uset = not dead
                okt = uset and r < left
                bt = okt and (x >> r) & 1 == 1
                dt = uset and not okt
                r += okt
                oks = bt and r < left and not dt
                bs = oks and (x >> r) & 1 == 1
                ds = bt and not oks and not dt
                r += oks
                dead = dead or dt or ds
                v |= (okt << k) | (bt << (4 + k)) | (oks << (8 + k))
                v |= (bs << (12 + k)) | (uset << (16 + k))
            tab[x * 9 + left] = v | (r << 20) | (dead << 24)
    return tab


@lru_cache(maxsize=8)
def _statics(c, h, w, ll_h, ll_w, device: torch.device) -> dict:
    """Device constants: the per-node geometry word (child0 | hc << 24 |
    hg << 25 | llcf << 26), the ladder table and small index vectors."""
    g = dec_geom(c, h, w, ll_h, ll_w)
    geo = (
        g["child0"].astype(np.int64)
        | (g["has_child"].astype(np.int64) << 24)
        | (g["hg"].astype(np.int64) << 25)
        | (g["llcf"].astype(np.int64) << 26)
    )

    def dev(x, dtype=_I32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return dict(
        geo=dev(geo),
        table=dev(_ladder_table()),
        shifts20=dev(np.arange(20)),
        coff4=dev([0, 1, w, w + 1]),
        kio=dev(np.arange(KB)),
        ar32=dev(np.arange(32), torch.int64),
        ar8=dev(np.arange(8), torch.int64),
        acts8=dev([A_OFF, A_OFFSIGN] * 4),
        # a trace row's node: the entry's (its test and LIP sign rows),
        # then each child's (its test and sign rows)
        pick10=dev([0, 0, 1, 1, 2, 2, 3, 3, 4, 4], torch.int64),
    )


def _pack(node, typ, filt, depth):
    """Queue entry of the sequential machine: node << 7 | type << 6 |
    filter << 4 | depth."""
    return (node << 7) | (typ << 6) | (filt << 4) | depth


def _excl(x):
    """Exclusive int32 cumsum of a (B, k) bool tensor along dim 1."""
    x = x.to(_I32)
    return torch.cumsum(x, 1, dtype=_I32) - x


class _Loop:
    """Runs ``step`` (in place on persistent tensors) in chunks of
    ``K_STEPS`` until ``alive()`` is false for every stream, with one host
    check a chunk. On the card the chunk is a CUDA graph: the first chunk
    runs eagerly, then the graph is captured and replayed."""

    def __init__(self, step, alive):
        self.step, self.alive = step, alive
        self.graph = None
        self.chunks = 0

    def _chunk(self, dev: torch.device):
        if dev.type == "cuda" and self.chunks > 0:
            if self.graph is None:
                graph = torch.cuda.CUDAGraph()
                # no cyclic collection while capturing: it can free an
                # evicted machine's graph (a loop and its step closure form
                # a cycle), and freeing a graph invalidates the capture
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph):
                        for _ in range(K_STEPS):
                            self.step()
                finally:
                    if gc_on:
                        gc.enable()
                self.graph = graph
            self.graph.replay()
        else:
            for _ in range(K_STEPS):
                self.step()
        self.chunks += 1

    def run(self, dev: torch.device) -> None:
        while bool(self.alive().any()):
            self._chunk(dev)


class _Machine:
    """Persistent per-(device, batch) state and loops of one machine; the
    counts ``steps`` (list-entry steps run, K_STEPS a chunk, past-the-end
    steps included) and ``planes`` of its last call."""

    def __init__(self, c, h, w, ll_h, ll_w, cap_words):
        self.geom = (c, h, w, ll_h, ll_w)
        self.N = c * h * w
        self.cap_words = cap_words
        self._key = None
        self.st = None
        self.steps = 0
        self.planes = 0

    def _state(self, dev, B):
        if self._key != (dev, B):
            self.st = None  # free the old state (and its graphs) first
            self.st = self._alloc(dev, B)
            self._key = (dev, B)
        return self.st

    def _words(self, st, words, nbits, max_n):
        """Copy the call's streams into the persistent buffers."""
        st["words"].copy_(words)
        st["w64"].copy_(words.long() & 0xFFFFFFFF)
        st["nbits"].copy_(nbits)
        return max_n.to(_I32)

    def _funnel(self, st, off):
        """(B,) int64: the 32 stream bits from bit ``off`` on (bit 0 =
        bit ``off``), from the two words it spans (clamped reads: bits
        at or past the stream's end are never used)."""
        wi = torch.clamp(off >> 5, 0, self.cap_words - 1).long()
        ww = st["w64"].gather(1, torch.stack(
            [wi, torch.clamp(wi + 1, max=self.cap_words - 1)], 1))
        sh = (off & 31).long()
        return ((ww[:, 0] >> sh) | (ww[:, 1] << (32 - sh))) & 0xFFFFFFFF

    def _ladder(self, T, x, left, run):
        """The offspring ladder from ``_ladder_table``: (okt, bt, oks,
        bs, uset) as (B, 4) bools, bits consumed and dead, (B,) each;
        all false and 0 where ``run`` is false."""
        tv = torch.where(run, T["table"][(x * 9 + left).long()], 0)
        fl = ((tv[:, None] >> T["shifts20"]) & 1) == 1
        return (fl[:, 0:4], fl[:, 4:8], fl[:, 8:12], fl[:, 12:16],
                fl[:, 16:20], (tv >> 20) & 15, ((tv >> 24) & 1) == 1)


class _Hybrid(_Machine):
    """``_build_hybrid``: decode(words (B, cap_words) int32, nbits (B,),
    max_n (B,)) -> rec (B, c, h, w) int32, on the words' device."""

    def __init__(self, c, h, w, ll_h, ll_w, cap_words):
        super().__init__(c, h, w, ll_h, ll_w, cap_words)
        if self.N >= 1 << 24:
            raise ValueError("geometry too large for packed queue entries")
        g = dec_geom(c, h, w, ll_h, ll_w)
        self.LIP_CAP = g["ent_bound"] + 1
        self.ENT_CAP = g["ent_bound"] + 1
        self.LIS_CAP = 2 * g["lis_bound"] + 1
        # buffers padded by KB so the block reads never clamp
        self.LIS_BUF = self.LIS_CAP + KB
        # LIP-section window: <= 2 bits per LIP slot, and never more than
        # the whole (padded) stream; the refinement window likewise
        self.W = int(min(2 * g["ent_bound"] + 2, cap_words * 32))
        self.WW = (self.W + 31) // 32 + 2
        self.RW = int(min(self.ENT_CAP, cap_words * 32))
        self.RWW = (self.RW + 31) // 32 + 2
        self.PADW = cap_words + max(self.WW, self.RWW) + 2
        # the windows start at word cur >> 5 <= cap_words (cur <= nbits <=
        # 32 cap_words) and bit cur & 31 <= 31: they never clamp
        if not (cap_words + max(self.WW, self.RWW) <= self.PADW
                and 31 + self.W <= 32 * self.WW
                and 31 + self.RW <= 32 * self.RWW):
            raise RuntimeError("hybrid decoder windows would clamp")
        self.LIP0 = 0
        self.LIS0 = 2 * self.LIP_CAP
        self.LSP0 = self.LIS0 + 2 * self.LIS_BUF
        self.SCR = self.LSP0 + self.ENT_CAP
        self.lip_init = torch.as_tensor(g["lip_init"])
        self.lis_init = (torch.as_tensor(g["lis_init"]) << 1) | 1

    def _alloc(self, dev, B):
        def z(*shape, dtype=_I32):
            return torch.zeros((B,) + shape, dtype=dtype, device=dev)

        st = dict(
            words=z(self.cap_words), w64=z(self.cap_words, dtype=torch.int64),
            wpad=z(self.PADW), nbits=z(),
            Q=z(self.SCR + 1), rec=z(self.N + 1),
            # plane scalars: lip_cnt, lis_cnt, lsp_cnt, lipcur, liscur,
            # cur, n, dead, done
            P=z(9),
            # LIS-loop scalars: lsp_cnt, lip_w, lip_add, lis_i, lis_w,
            # lis_cnt, cur, dead; and the plane's constants for it:
            # base_val, other_lip, other_lis, liscur, active
            I=z(8), C=z(5),
        )
        T = _statics(*self.geom, dev)
        st["loop"] = _Loop(lambda: self._lis_step(st, T),
                           lambda: self._lis_alive(st))
        return st

    def _lis_alive(self, st):
        I, C = st["I"], st["C"]
        return (C[:, 4] == 1) & (I[:, 7] == 0) & (I[:, 3] < I[:, 5])

    def _window(self, st, T, cur, nwords, nbits_w):
        """(B, nbits_w) bool: the stream bits from bit ``cur`` on (a
        gather, which raises where ``lax.dynamic_slice`` would clamp)."""
        B = cur.shape[0]
        ar = torch.arange(nwords, device=cur.device)
        ws = st["wpad"].gather(1, (cur >> 5).long()[:, None] + ar)
        bits = ((ws.long()[:, :, None] >> T["ar32"]) & 1).bool().reshape(
            B, -1)
        start = (cur & 31).long()[:, None] + torch.arange(
            nbits_w, device=cur.device)
        return bits.gather(1, start)

    def _lis_step(self, st, T):
        """One step of the LIS worklist machine for every stream."""
        Q, rec, words, nbits = st["Q"], st["rec"], st["words"], st["nbits"]
        I, C = st["I"], st["C"]
        lsp_cnt, lip_w, lip_add, lis_i, lis_w, lis_cnt, cur0, dead = (
            I.unbind(1))
        base_val, other_lip, other_lis, liscur, _ = C.unbind(1)
        N, kio = self.N, T["kio"]
        act = self._lis_alive(st)
        # a block of KB entries: the unfired prefix (each one 0 bit) is
        # retained in bulk, the blocker (a 1 bit) runs its cascade
        pos = cur0[:, None] + kio
        wk = words.gather(
            1, torch.clamp(pos >> 5, 0, self.cap_words - 1).long())
        bitsk = ((wk >> (pos & 31)) & 1) == 1
        validk = kio < (lis_cnt - lis_i)[:, None]
        okk = pos < nbits[:, None]
        stop = bitsk | ~okk | ~validk
        f = torch.where(stop, kio, KB).amin(1)
        f = torch.where(act, f, 0)
        live = self.LIS0 + liscur * self.LIS_BUF
        src = Q.gather(1, (live + lis_i)[:, None].long() + kio)
        dsti = (self.LIS0 + other_lis * self.LIS_BUF + lis_w)[:, None] + kio
        dst = Q.gather(1, dsti.long())
        kept = torch.where(kio < f[:, None], src, dst)
        lis_i1 = lis_i + f
        cur1 = cur0 + f
        has_e = lis_i1 < lis_cnt
        ok0 = cur1 < nbits
        blocked = f < KB
        proc = act & blocked & has_e & ok0
        dead0 = act & blocked & has_e & ~ok0

        e = src.gather(1, torch.clamp(f, max=KB - 1)[:, None].long())[:, 0]
        node = torch.clamp(e >> 1, 0, N - 1)
        is_a = (e & 1) == 1
        gp = T["geo"][node.long()]
        hc = ((gp >> 24) & 1) == 1
        hg_n = ((gp >> 25) & 1) == 1
        kids = torch.clamp((gp & 0xFFFFFF)[:, None] + T["coff4"], 0, N - 1)
        # the fired cascade (<= 9 bits) from one 32-bit funnel window
        win = self._funnel(st, cur1)
        a_fired = is_a & proc
        start = cur1 + proc.to(_I32)
        okt, bt, oks, bs, _, cnt, tdead = self._ladder(
            T, (win >> 1) & 0xFF, torch.clamp(nbits - start, 0, 8),
            a_fired & hc)
        consumed = start + cnt
        dead_c = dead0 | tdead

        commit = bt & oks
        insig = okt & ~bt
        # A fire -> B re-entry at the live tail (after all children were
        # consumed, as the reference orders it under truncation); B fire
        # -> 4 A children at the live tail
        reapp = a_fired & hg_n & ~dead_c
        b_fired = ~is_a & proc & hc
        scr = self.SCR
        qi = torch.cat([
            dsti,
            torch.where(commit, self.LSP0 + lsp_cnt[:, None] + _excl(commit),
                        scr),
            torch.where(insig, self.LIP0 + (other_lip * self.LIP_CAP + lip_w
                                            + lip_add)[:, None]
                        + _excl(insig), scr),
            torch.where(reapp, live + lis_cnt, scr)[:, None],
            torch.where(b_fired[:, None],
                        (live + lis_cnt + reapp.to(_I32))[:, None]
                        + T["kio"][:4], scr),
        ], 1)
        qv = torch.cat([kept, kids, kids, (node << 1)[:, None],
                        (kids << 1) | 1], 1)
        Q.scatter_(1, qi.long(), qv)
        # re-significance of a duplicated cell overwrites its refined
        # value with +-base (the reference's semantics)
        rec.scatter_(1, torch.where(commit, kids, N).long(), torch.where(
            bs, base_val[:, None], -base_val[:, None]))
        new = torch.stack([
            lsp_cnt + commit.sum(1, dtype=_I32),
            lip_w,
            lip_add + insig.sum(1, dtype=_I32),
            lis_i1 + proc.to(_I32),
            lis_w + f,
            lis_cnt + reapp.to(_I32) + 4 * b_fired.to(_I32),
            consumed,
            (dead.bool() | dead_c).to(_I32),
        ], 1)
        I.copy_(torch.where(act[:, None], new, I))

    def __call__(self, words, nbits, max_n):
        dev = words.device
        B = words.shape[0]
        st = self._state(dev, B)
        T = _statics(*self.geom, dev)
        max_n = self._words(st, words, nbits, max_n)
        st["wpad"].zero_()
        st["wpad"][:, : self.cap_words] = words
        Q, rec, P, I, C = st["Q"], st["rec"], st["P"], st["I"], st["C"]
        Q.zero_()
        Q[:, self.LIP0: self.LIP0 + self.lip_init.numel()] = (
            self.lip_init.to(dev))
        Q[:, self.LIS0: self.LIS0 + self.lis_init.numel()] = (
            self.lis_init.to(dev))
        rec.zero_()
        P.zero_()
        P[:, 0] = self.lip_init.numel()
        P[:, 1] = self.lis_init.numel()
        P[:, 6] = max_n
        nbits = st["nbits"]
        iotaW = torch.arange(self.W, dtype=_I32, device=dev)
        tiota = torch.arange(self.ENT_CAP, dtype=_I32, device=dev)
        N, scr = self.N, self.SCR
        loop = st["loop"]
        chunks0 = loop.chunks
        self.planes = 0
        while True:
            lip_cnt, lis_cnt, lsp_cnt, lipcur, liscur, cur, n, dead, done = (
                P.unbind(1))
            act = (dead | done) == 0
            if not bool(act.any()):
                break
            self.planes += 1
            actc = act[:, None]
            base_val = torch.where(
                n == 0, 1, 3 << torch.clamp(n - 1, min=0)).to(_I32)
            other_lip = 1 - lipcur
            other_lis = 1 - liscur

            # ================= LIP section (parallel) =================
            nbits_rel = (nbits - cur)[:, None]
            sect = self._window(st, T, cur, self.WW, self.W)
            zpos = torch.where(sect, -1, iotaW)
            lz = torch.cummax(zpos, 1).values
            lzs = torch.cat([torch.full_like(lz[:, :1], -1), lz[:, :-1]], 1)
            is_test = ((iotaW - 1 - lzs) & 1) == 0
            eidx = torch.cumsum(is_test, 1, dtype=_I32) - 1
            valid = (is_test & (eidx < lip_cnt[:, None])
                     & (iotaW < nbits_rel))
            fired = valid & sect
            sgn = torch.cat([sect[:, 1:], torch.zeros_like(sect[:, :1])], 1)
            sign_ok = (iotaW + 1) < nbits_rel
            commit = fired & sign_ok
            retain = valid & ~sect
            ent = Q.gather(1, (self.LIP0 + lipcur[:, None] * self.LIP_CAP
                               + torch.clamp(eidx, 0, self.LIP_CAP - 1)
                               ).long())
            r_rank = torch.cumsum(retain, 1, dtype=_I32) - 1
            f_rank = torch.cumsum(commit, 1, dtype=_I32) - 1
            qi = torch.cat([
                torch.where(retain & actc, self.LIP0 + (
                    other_lip * self.LIP_CAP)[:, None] + r_rank, scr),
                torch.where(commit & actc,
                            self.LSP0 + lsp_cnt[:, None] + f_rank, scr),
            ], 1)
            Q.scatter_(1, qi.long(), torch.cat([ent, ent], 1))
            rec.scatter_(
                1, torch.where(commit & actc, torch.clamp(ent, 0, N - 1),
                               N).long(),
                torch.where(sgn, base_val[:, None], -base_val[:, None]))
            n_valid = valid.sum(1, dtype=_I32)
            n_commit = commit.sum(1, dtype=_I32)
            n_retain = retain.sum(1, dtype=_I32)
            dead_lip = (n_valid < lip_cnt) | (fired & ~sign_ok).any(1)

            # ============ LIS worklist (run-skipping machine) =========
            zero = torch.zeros_like(n)
            I.copy_(torch.stack([
                lsp_cnt + n_commit, n_retain, zero, zero, zero, lis_cnt,
                cur + n_valid + n_commit, dead_lip.to(_I32)], 1))
            C.copy_(torch.stack([base_val, other_lip, other_lis, liscur,
                                 act.to(_I32)], 1))
            loop.run(dev)

            # ================= refinement (parallel) ==================
            # only cells significant BEFORE this plane refine; duplicate
            # LSP instances of one cell gather one old value and carry one
            # stream bit, so the scatter is value-unique
            i_lsp, i_lip_w, i_lip_add, _, i_lis_w, _, i_cur, i_dead = (
                I.unbind(1))
            ref_len = lsp_cnt[:, None]
            alive = i_dead == 0
            nbits_rel2 = nbits - i_cur
            rbits = self._window(st, T, i_cur, self.RWW, self.RW)
            if self.RW < self.ENT_CAP:
                rbits = torch.cat([rbits, torch.zeros_like(
                    rbits[:, :1]).expand(B, self.ENT_CAP - self.RW)], 1)
            valid_t = (alive[:, None] & (tiota < ref_len)
                       & (tiota < nbits_rel2[:, None]))
            nodes = torch.clamp(
                Q[:, self.LSP0: self.LSP0 + self.ENT_CAP], 0, N - 1).long()
            old = rec.gather(1, nodes)
            nc = n[:, None]
            nmag = ((torch.abs(old) & ~(1 << nc))
                    | (rbits.to(_I32) << nc))
            rec.scatter_(1, torch.where(valid_t & actc, nodes, N),
                         torch.where(old >= 0, nmag, -nmag))
            dead3 = i_dead.bool() | (alive & (lsp_cnt > nbits_rel2))
            cur3 = i_cur + torch.minimum(
                lsp_cnt, torch.clamp(nbits_rel2, min=0))
            new = torch.stack([
                i_lip_w + i_lip_add, i_lis_w, i_lsp, other_lip, other_lis,
                cur3, torch.clamp(n - 1, min=0), dead3.to(_I32),
                (done.bool() | (~dead3 & (n == 0))).to(_I32),
            ], 1)
            P.copy_(torch.where(actc, new, P))
        self.steps = (loop.chunks - chunks0) * K_STEPS
        return rec[:, :N].reshape((B,) + self.geom[:3]).clone()


class _Sequential(_Machine):
    """``_build_decoder`` with the trace (the only way the reference's
    entry points build it): decode(words (B, cap_words) int32, nbits
    (B,), max_n (B,)) -> (rec (B, c, h, w) int32, meta (B, meta_rows, 8)
    int32), one list entry a step."""

    def __init__(self, c, h, w, ll_h, ll_w, level, rect_tab, cap_words,
                 meta_rows):
        super().__init__(c, h, w, ll_h, ll_w, cap_words)
        if self.N >= 1 << 24:
            raise ValueError("geometry too large for packed queue entries")
        g = dec_geom(c, h, w, ll_h, ll_w)
        if meta_rows < 1:
            raise ValueError("the sequential machine writes the trace")
        self.level = level
        self.meta_rows = meta_rows
        if rect_tab is not None:
            self.rtab = np.asarray(rect_tab, np.int32).reshape(level + 1, 4, 4)
        else:
            self.rtab = rect_table(level, ll_h, ll_w, None)
        # exact bounds from the geometry's parent multiplicity
        self.LIP_CAP = g["ent_bound"] + 1
        self.LIS_CAP = 2 * g["lis_bound"] + 1
        self.ENT_CAP = g["ent_bound"] + 1
        self.LIP0 = 0
        self.LIS0 = 2 * self.LIP_CAP
        self.LSP0 = self.LIS0 + 2 * self.LIS_CAP
        self.SCR = self.LSP0 + self.ENT_CAP
        self.lip_init = _pack(torch.as_tensor(g["lip_init"]), 0, _F_LL, level)
        self.lis_init = _pack(torch.as_tensor(g["lis_init"]), 1, _F_LL, level)

    def _alloc(self, dev, B):
        def z(*shape, dtype=_I32):
            return torch.zeros((B,) + shape, dtype=dtype, device=dev)

        st = dict(
            words=z(self.cap_words), w64=z(self.cap_words, dtype=torch.int64),
            nbits=z(), Q=z(self.SCR + 1), rec=z(self.N + 1),
            meta=z(self.meta_rows + 1, 8),  # row meta_rows: scratch
            # lipcur, liscur, lip_cnt, lip_i, lip_w, lip_add, lis_cnt,
            # lis_i, lis_w, lsp_cnt, lsp_snap, ref_i, cur, n, phase, dead,
            # done
            S=z(17),
            rtab=torch.as_tensor(self.rtab, device=dev),
        )
        T = _statics(*self.geom, dev)
        st["loop"] = _Loop(lambda: self._step(st, T),
                           lambda: (st["S"][:, 15] | st["S"][:, 16]) == 0)
        return st

    def _step(self, st, T):
        """One list entry (or phase advance) of every active stream."""
        Q, rec, nbits, S = st["Q"], st["rec"], st["nbits"], st["S"]
        (lipcur, liscur, lip_cnt, lip_i, lip_w, lip_add, lis_cnt, lis_i,
         lis_w, lsp_cnt, lsp_snap, ref_i, cur, n, phase, dead, done) = (
            S.unbind(1))
        N, scr = self.N, self.SCR
        act = (dead | done) == 0
        in_lip, in_lis, in_ref = phase == 0, phase == 1, phase == 2
        lip_have = act & in_lip & (lip_i < lip_cnt)
        lis_have = act & in_lis & (lis_i < lis_cnt)
        ref_have = act & in_ref & (ref_i < lsp_snap)
        # phase advances (no bits consumed)
        adv_lip = in_lip & ~lip_have
        adv_lis = in_lis & ~lis_have
        pe = in_ref & ~ref_have

        # ---- fetch the active entry (clamped, as the reference's) ----
        qidx = torch.where(
            lip_have,
            self.LIP0 + lipcur * self.LIP_CAP
            + torch.clamp(lip_i, 0, self.LIP_CAP - 1),
            torch.where(
                lis_have,
                self.LIS0 + liscur * self.LIS_CAP
                + torch.clamp(lis_i, 0, self.LIS_CAP - 1),
                self.LSP0 + torch.clamp(ref_i, 0, self.ENT_CAP - 1)))
        e = Q.gather(1, qidx[:, None].long())[:, 0]
        node = torch.clamp(e >> 7, 0, N - 1)
        typ, filt, depth = (e >> 6) & 1, (e >> 4) & 3, e & 15
        is_a = lis_have & (typ == 1)
        is_b = lis_have & (typ == 0)
        gp = T["geo"][node.long()]
        hc = ((gp >> 24) & 1) == 1
        hg_n = ((gp >> 25) & 1) == 1
        cfilt = torch.where(filt == _F_LL, (gp >> 26) & 3, filt)
        cdep = torch.clamp(depth - 1, min=0)
        kids = torch.clamp((gp & 0xFFFFFF)[:, None] + T["coff4"], 0, N - 1)
        base_val = torch.where(
            n == 0, 1,
            (1 << torch.clamp(n - 1, min=0)) + (1 << n)).to(_I32)

        # ---- the pops: test bit, LIP sign, the offspring ladder -------
        win = self._funnel(st, cur)
        use0 = lip_have | lis_have | ref_have
        off0 = cur
        ok0 = use0 & (off0 < nbits)
        b0 = ((win & 1) == 1) & ok0
        dead0 = use0 & ~ok0
        lip_fired = lip_have & b0
        use1 = lip_fired
        off1 = off0 + use0.to(_I32)
        ok1 = use1 & (off1 < nbits) & ~dead0
        b1 = (((win >> 1) & 1) == 1) & ok1
        dead1 = use1 & ~ok1 & ~dead0
        a_fired = is_a & b0 & ~dead0
        run_children = a_fired & hc
        start = off1 + use1.to(_I32)
        okt, bt, oks, bs, uset, cnt, tdead = self._ladder(
            T, (win >> 1) & 0xFF, torch.clamp(nbits - start, 0, 8),
            run_children)
        consumed = start + cnt
        dead_c = dead0 | dead1 | tdead
        commit = bt & oks

        # ---- rec: lip commit, 4 child commits, refinement -------------
        nodes5 = torch.cat([node[:, None], kids], 1)
        rec5 = rec.gather(1, nodes5.long())  # values before this step
        x_old = rec5[:, 0]
        lip_commit = lip_fired & ok1
        ref_commit = ref_have & ok0
        mag = torch.abs(x_old)
        bitn = 1 << n
        mag = torch.where(b0, mag | bitn, mag & ~bitn)
        bv = base_val[:, None]
        rec.scatter_(1, torch.cat([
            torch.where(lip_commit, node, N)[:, None],
            torch.where(commit, kids, N),
            torch.where(ref_commit, node, N)[:, None],
        ], 1).long(), torch.cat([
            torch.where(b1, base_val, -base_val)[:, None],
            torch.where(bs, bv, -bv),
            torch.where(x_old >= 0, mag, -mag)[:, None],
        ], 1))

        # ---- queue writes: LSP appends, LIP retain and insignificant
        # children, LIS retain, B re-entry and A children --------------
        ce = _pack(kids, 0, cfilt[:, None], cdep[:, None])
        lsp_w = lsp_cnt + lip_commit.to(_I32)
        other_lip = 1 - lipcur
        other_lis = 1 - liscur
        lip_retain = lip_have & ok0 & ~b0
        lip_w_new = lip_w + lip_retain.to(_I32)
        insig = okt & ~bt
        lis_retain = lis_have & ok0 & ~b0
        lis_w_new = lis_w + lis_retain.to(_I32)
        # A fire -> B re-entry only after all children were consumed
        reapp = a_fired & hg_n & ~dead_c
        b_fired = is_b & b0 & ok0 & hc
        live = self.LIS0 + liscur * self.LIS_CAP
        tail = live + lis_cnt + reapp.to(_I32)
        lip_o = self.LIP0 + other_lip * self.LIP_CAP
        Q.scatter_(1, torch.cat([
            torch.where(lip_commit, self.LSP0 + lsp_cnt, scr)[:, None],
            torch.where(commit, (self.LSP0 + lsp_w)[:, None] + _excl(commit),
                        scr),
            torch.where(lip_retain, lip_o + lip_w, scr)[:, None],
            torch.where(insig, (lip_o + lip_w_new + lip_add)[:, None]
                        + _excl(insig), scr),
            torch.where(lis_retain, self.LIS0 + other_lis * self.LIS_CAP
                        + lis_w, scr)[:, None],
            torch.where(reapp, live + lis_cnt, scr)[:, None],
            torch.where(b_fired[:, None], tail[:, None] + T["kio"][:4], scr),
        ], 1).long(), torch.cat([
            e[:, None], ce, e[:, None], ce, e[:, None],
            _pack(node, 0, filt, depth)[:, None], ce | (1 << 6),
        ], 1))

        self._note(st, T, lip_have, ref_have, is_a, use0, use1, dead0,
                   dead.bool(), off0, off1, start, okt, bt, oks, uset,
                   nodes5, filt, cfilt, depth, cdep, n, rec5)

        # ---- scalar bookkeeping + phase machine ------------------------
        lip_add_new = lip_add + insig.sum(1, dtype=_I32)
        lsp_w_new = lsp_w + commit.sum(1, dtype=_I32)
        lis_w_cur = lis_cnt + reapp.to(_I32) + 4 * b_fired.to(_I32)
        zero = torch.zeros_like(n)
        phase_new = torch.where(
            adv_lip, 1, torch.where(adv_lis, 2, phase)).to(_I32)
        new = torch.stack([
            torch.where(pe, other_lip, lipcur),
            torch.where(pe, other_lis, liscur),
            torch.where(pe, lip_w_new + lip_add_new, lip_cnt),
            torch.where(pe, zero, lip_i + lip_have.to(_I32)),
            torch.where(pe, zero, lip_w_new),
            torch.where(pe, zero, lip_add_new),
            torch.where(pe, lis_w_new, lis_w_cur),
            torch.where(pe, zero, lis_i + lis_have.to(_I32)),
            torch.where(pe, zero, lis_w_new),
            lsp_w_new,
            torch.where(pe, lsp_w_new, lsp_snap),
            torch.where(pe, zero, ref_i + ref_have.to(_I32)),
            consumed,
            torch.where(pe, torch.clamp(n - 1, min=0), n),
            torch.where(pe, zero, phase_new),
            (dead.bool() | dead_c).to(_I32),
            (done.bool() | (pe & (n == 0))).to(_I32),
        ], 1)
        S.copy_(torch.where(act[:, None], new, S))

    def _note(self, st, T, lip_have, ref_have, is_a, use0, use1, dead0,
              dead, off0, off1, start, okt, bt, oks, uset, nodes5, filt,
              cfilt, depth, cdep, n, rec5):
        """The trace rows of this step, one per attempted pop (the one
        that fails included) at its stream offset: [action, local_h,
        local_w, channel, filter, depth, n, rec value before the step]."""
        B = n.shape[0]
        c, h, w = self.geom[:3]
        HW = h * w
        act0 = torch.where(
            lip_have, A_LIP,
            torch.where(ref_have, A_REF,
                        torch.where(is_a, A_DESC, A_LSIG))).to(_I32)
        ft5 = torch.cat([filt[:, None], cfilt[:, None].expand(B, 4)], 1)
        dp5 = torch.cat([depth[:, None], cdep[:, None].expand(B, 4)], 1)
        rect = st["rtab"][torch.clamp(dp5, 0, self.level).long(),
                          ft5.long()].reshape(-1, 4)
        nd = nodes5.reshape(-1)
        lh = meta_expand._local((nd % HW) // w, rect[:, 0:2]).to(_I32)
        lw = meta_expand._local(nd % w, rect[:, 2:4]).to(_I32)
        cols5 = torch.stack([
            lh.reshape(B, 5), lw.reshape(B, 5), (nodes5 // HW), ft5, dp5,
            n[:, None].expand(B, 5), rec5], 2)  # (B, 5, 7)
        # rows: the entry's test and LIP sign; each child's test and sign
        acts = torch.cat([
            act0[:, None], torch.full_like(act0[:, None], A_LIPSIGN),
            T["acts8"].expand(B, 8)], 1)
        # (B, 10, 8)
        rows = torch.cat([acts[:, :, None], cols5[:, T["pick10"]]], 2)
        inter = torch.stack([okt, oks], 2).reshape(B, 8)
        rowpos = torch.cat([off0[:, None], off1[:, None],
                            start[:, None] + _excl(inter)], 1)
        nd_ = ~dead[:, None]
        want = torch.cat([
            (use0 & ~dead)[:, None], (use1 & ~dead0 & ~dead)[:, None],
            torch.stack([uset & nd_, bt & nd_], 2).reshape(B, 8)], 1)
        ok = want & (rowpos <= self.meta_rows - 1)
        ridx = torch.where(ok, rowpos, self.meta_rows).long()
        st["meta"].view(B, -1).scatter_(
            1, (ridx[:, :, None] * 8 + T["ar8"]).reshape(B, 80),
            rows.reshape(B, 80))

    def __call__(self, words, nbits, max_n):
        dev = words.device
        B = words.shape[0]
        st = self._state(dev, B)
        max_n = self._words(st, words, nbits, max_n)
        Q, S = st["Q"], st["S"]
        Q.zero_()
        Q[:, self.LIP0: self.LIP0 + self.lip_init.numel()] = (
            self.lip_init.to(dev))
        Q[:, self.LIS0: self.LIS0 + self.lis_init.numel()] = (
            self.lis_init.to(dev))
        st["rec"].zero_()
        st["meta"].zero_()
        S.zero_()
        S[:, 2] = self.lip_init.numel()
        S[:, 6] = self.lis_init.numel()
        S[:, 13] = max_n
        loop = st["loop"]
        chunks0 = loop.chunks
        loop.run(dev)
        self.steps = (loop.chunks - chunks0) * K_STEPS
        rec = st["rec"][:, : self.N].reshape((B,) + self.geom[:3]).clone()
        return rec, st["meta"][:, :-1].clone()


@lru_cache(maxsize=4)
def _hybrid(c, h, w, ll_h, ll_w, cap_words) -> _Hybrid:
    return _Hybrid(c, h, w, ll_h, ll_w, cap_words)


@lru_cache(maxsize=2)
def _sequential(c, h, w, ll_h, ll_w, level, rect_tab, cap_words, meta_rows):
    return _Sequential(c, h, w, ll_h, ll_w, level, rect_tab, cap_words,
                       meta_rows)


def decode_device_fn(
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    cap_words: int,
    level: int = 0,
    rect_tab: Optional[Tuple] = None,
    meta_rows: int = 0,
):
    """The machine for one geometry and word count, for one stream:
    fn(words int32[cap_words], nbits, max_n) -> rec (c, h, w) int32 (the
    hybrid machine, ``meta_rows`` 0), or (rec, meta (meta_rows, 8)) (the
    sequential machine with the trace), tensors on the words' device.
    ``fn.machine`` is the batched machine it runs. A geometry the native
    scheduler refuses raises ``ValueError`` (``encoder.check_geometry``)."""
    check_geometry(c, h, w, ll_h, ll_w)
    if meta_rows == 0:
        machine = _hybrid(c, h, w, ll_h, ll_w, cap_words)
    else:
        machine = _sequential(c, h, w, ll_h, ll_w, level, rect_tab,
                              cap_words, meta_rows)

    def fn(words, nbits, max_n):
        dev = words.device
        out = machine(
            words.reshape(1, cap_words),
            torch.tensor([int(nbits)], dtype=_I32).to(dev),
            torch.tensor([int(max_n)], dtype=_I32).to(dev),
        )
        if meta_rows == 0:
            return out[0]
        return out[0][0], out[1][0]

    fn.machine = machine
    return fn


def decode_device(
    data: bytes, n: int, c: int, h: int, w: int, ll_h: int, ll_w: int,
    device=None,
) -> np.ndarray:
    """Decode bytes -> (C,H,W) int32 array on ``device`` (None: the
    card), routed by ``SPIHT_TPU_PALLAS_DECODER``: kernel B2 (B3 at odd
    LL), or the hybrid machine. Prefix-tolerant: any byte prefix decodes,
    the machine stopping mid-entry as the reference does; the byte-padded
    bit length is read, as the wire format reads it."""
    check_geometry(c, h, w, ll_h, ll_w)
    dev = resolve_device(device)
    if use_kernel("SPIHT_TPU_PALLAS_DECODER", dev):
        return decoder.decode(data, n, c, h, w, ll_h, ll_w, dev).cpu().numpy()
    words, nbits = decoder.words_tensor(data, dev)
    fn = decode_device_fn(c, h, w, ll_h, ll_w, words.numel())
    return fn(words, nbits, int(n)).cpu().numpy()


def decode_device_with_metadata(
    data: bytes,
    n: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    top_slice,
    other_slices,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + the per-bit decoder-state trace (len(data)*8 + 1, 8) on
    ``device`` (None: the card). ``SPIHT_TPU_PALLAS_META`` (unset: as
    ``SPIHT_TPU_PALLAS_DECODER``) routes it: kernel B2-log (B3-log at odd
    LL) and the log's expansion, or the sequential machine."""
    check_geometry(c, h, w, ll_h, ll_w)
    dev = resolve_device(device)
    flag = os.environ.get("SPIHT_TPU_PALLAS_META")
    if flag == "1" or (
        flag is None and use_kernel("SPIHT_TPU_PALLAS_DECODER", dev)
    ):
        rec, meta = meta_expand.decode_with_metadata(
            data, int(n), c, h, w, ll_h, ll_w, top_slice, other_slices, dev)
        return rec.cpu().numpy(), meta.cpu().numpy()
    level = len(other_slices)
    rect = meta_expand.rect_key(level, ll_h, ll_w, top_slice, other_slices)
    words, nbits = decoder.words_tensor(data, dev)
    fn = decode_device_fn(c, h, w, ll_h, ll_w, words.numel(), level=level,
                          rect_tab=rect, meta_rows=nbits + 1)
    rec, meta = fn(words, nbits, int(n))
    return rec.cpu().numpy(), meta.cpu().numpy()


def decode_device_batch(datas, ns, c, h, w, ll_h, ll_w, device=None):
    """Decode a batch of streams of one geometry on ``device`` (None: the
    card) -> (B, C, H, W) int32, routed by ``SPIHT_TPU_PALLAS_DECODER``:
    ``decoder.pallas_decode_batch`` (kernel B5, batched B3 at odd LL, or
    what the batch and machine switches route to), or the hybrid machine
    over B streams in lockstep. ns: one max_n or one per stream."""
    check_geometry(c, h, w, ll_h, ll_w)
    dev = resolve_device(device)
    datas = list(datas)
    B = len(datas)
    if np.isscalar(ns):
        ns = [ns] * B
    if use_kernel("SPIHT_TPU_PALLAS_DECODER", dev):
        return decoder.pallas_decode_batch(datas, ns, c, h, w, ll_h, ll_w,
                                           device=dev)
    words, nbits = decoder.words_batch(datas, dev)
    machine = _hybrid(c, h, w, ll_h, ll_w, words.shape[1])
    rec = machine(words, torch.tensor(nbits, dtype=_I32).to(dev),
                  torch.tensor([int(v) for v in ns], dtype=_I32).to(dev))
    return rec.cpu().numpy()
