"""Plain PyTorch reference of the SPIHT zerotree coder, vectorised.

SPIHT (Said & Pearlman 1996) in the stream format of theAdamColton/spiht
(``src/encoder_decoder.rs``): bit planes from ``max_n`` (the float32 log2
of the largest magnitude, truncated) down to 0; each plane a sorting pass
over the LIP, then over the LIS as a work list (entries appended during
the pass are visited in the same pass), then a refinement pass over the
LSP entries found in earlier planes. A significant coefficient's sign bit
is 1 for x >= 0. Spatial orientation trees: an LL cell at (even, even)
has no children, the other three of each LL 2x2 group parent the 2x2
block at ((i % 2) * ll_h + i // 2 * 2, (j % 2) * ll_w + j // 2 * 2);
elsewhere the children of (i, j) are the 2x2 block at (2i, 2j) when
2i + 1 < h and 2j + 1 < w. A type-A entry that expands is re-queued as
type B only when (2i + 1) * 2 + 1 < h and (2j + 1) * 2 + 1 < w, on the
entry's own coordinates. Channels are interleaved innermost in the
initial lists. The stream is cut at the budget, mid-symbol if need be,
and packed LSB first.

The work list is visited generation by generation: the entries a
generation appends are the next generation, in the order they were
appended, which is the order a FIFO work list visits them. So each
generation is a handful of whole-tensor operations. Significance of a
set is read from two per-node maxima, of the descendants (D) and of the
descendants of the children (L).

The decoder's reconstruction is derived from the same visit: a
coefficient whose sign bit lies before the cut holds +-(2^n + 2^(n-1))
(+-1 at n = 0) for the plane n that found it, and each refinement bit
before the cut sets bit n of its magnitude. That is what a decoder of the
first ``nbits`` bits holds, where the cut is at a byte boundary or the
stream is whole (a decoder reads the padding bits past an unaligned cut
as bits, which this derivation does not model; ``encode`` refuses it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def max_plane(arr: torch.Tensor) -> int:
    """The float32 log2 of the largest |x|, truncated; 0 for an all-zero
    array (the reference's ``(max as f32).log2() as u8``)."""
    m = int(arr.to(torch.int64).abs().max()) if arr.numel() else 0
    if m <= 0:
        return 0
    v = float(np.log2(np.float32(m)))
    return 0 if v < 0 else min(int(v), 255)


def _excl_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


class _Tree:
    """Children, the re-queue test and the D / L maxima of one array."""

    def __init__(self, arr: torch.Tensor, ll_h: int, ll_w: int):
        c, h, w = arr.shape
        dev = arr.device
        self.c, self.h, self.w, self.hw = c, h, w, h * w
        ii = torch.arange(h, device=dev)[:, None].expand(h, w)
        jj = torch.arange(w, device=dev)[None, :].expand(h, w)
        ll = (ii < ll_h) & (jj < ll_w)
        root = ll & (ii % 2 == 0) & (jj % 2 == 0)
        bi = torch.where(ll, (ii % 2) * ll_h + ii // 2 * 2, 2 * ii)
        bj = torch.where(ll, (jj % 2) * ll_w + jj // 2 * 2, 2 * jj)
        has = torch.where(ll, ~root, (2 * ii + 1 < h) & (2 * jj + 1 < w))
        base = (bi * w + bj).reshape(-1)
        step = torch.tensor([0, 1, w, w + 1], device=dev)
        # children (spatial) of every node; -1 where it has none
        self.child = torch.where(has.reshape(-1, 1), base[:, None] + step,
                                 torch.full((1, 4), -1, device=dev))
        self.requeue = (((2 * ii + 1) * 2 + 1 < h)
                        & ((2 * jj + 1) * 2 + 1 < w)).reshape(-1)
        self.mag = arr.to(torch.int64).abs().reshape(c, -1)
        nodes = torch.nonzero(has.reshape(-1)).reshape(-1)
        kids = self.child[nodes]  # (N, 4)
        d = torch.full_like(self.mag, -1)
        while True:  # D to its fixed point, one tree level a round
            g = torch.maximum(self.mag, d)
            nd = torch.full_like(d, -1)
            nd[:, nodes] = g[:, kids].amax(-1)
            if torch.equal(nd, d):
                break
            d = nd
        lmax = torch.full_like(d, -1)
        lmax[:, nodes] = d[:, kids].amax(-1)
        self.dmax, self.lmax = d.reshape(-1), lmax.reshape(-1)
        self.mag = self.mag.reshape(-1)

    def children(self, cells: torch.Tensor) -> torch.Tensor:
        """(N, 4) cell ids of the children of ``cells``."""
        k, s = cells // self.hw, cells % self.hw
        return k[:, None] * self.hw + self.child[s]


def _segment(n_bits: int, dev) -> torch.Tensor:
    return torch.zeros(n_bits, dtype=torch.bool, device=dev)


def encode(arr: torch.Tensor, ll_h: int, ll_w: int, max_bits: int
           ) -> Tuple[bytes, int, int, torch.Tensor]:
    """SPIHT-encode an int32 (C, H, W) packed array at a budget of
    ``max_bits`` bits. Returns (stream bytes, bits, max_n, rec): rec is
    the int64 (C, H, W) array a decoder of the stream reconstructs."""
    dev = arr.device
    c, h, w = arr.shape
    t = _Tree(arr, ll_h, ll_w)
    signs = (arr.reshape(-1) >= 0)
    max_n = max_plane(arr)
    max_bits = max(int(max_bits), 0)

    def lattice(cells):  # initial list order: i, j, then the channel
        return cells.permute(1, 2, 0).reshape(-1)

    ids = torch.arange(c * h * w, device=dev).reshape(c, h, w)
    lip = lattice(ids[:, :ll_h, :ll_w])
    ll_i = torch.arange(ll_h, device=dev)[:, None]
    ll_j = torch.arange(ll_w, device=dev)[None, :]
    keep = ~((ll_i % 2 == 0) & (ll_j % 2 == 0))
    lis = lattice(ids[:, :ll_h, :ll_w])[keep.reshape(-1).repeat_interleave(c)]
    lis_a = torch.ones_like(lis, dtype=torch.bool)
    lsp = torch.zeros(0, dtype=torch.long, device=dev)
    rec = torch.zeros(c * h * w, dtype=torch.int64, device=dev)
    chunks, pos = [], 0

    for n in range(max_n, -1, -1):
        if pos >= max_bits:
            break
        thr = 1 << n
        base = 1 if n == 0 else (1 << n) + (1 << (n - 1))
        old = lsp.numel()
        sign_cells, sign_pos = [], []
        new_lsp, new_lip = [lsp], []

        # sorting pass over the LIP
        sig = t.mag[lip] >= thr
        cnt = 1 + sig.long()
        start = _excl_cumsum(cnt)
        seg = _segment(int(cnt.sum()), dev)
        seg[start] = sig
        seg[start[sig] + 1] = signs[lip[sig]]
        sign_cells.append(lip[sig])
        sign_pos.append(pos + start[sig] + 1)
        new_lsp.append(lip[sig])
        new_lip.append(lip[~sig])
        chunks.append(seg)
        pos += seg.numel()

        # sorting pass over the LIS, a generation at a time
        gen, gen_a = lis, lis_a
        kept, kept_a = [gen[:0]], [gen_a[:0]]
        while gen.numel():
            sig = torch.where(gen_a, t.dmax[gen], t.lmax[gen]) >= thr
            grow = gen_a & sig  # type A entries that emit their children
            kids = t.children(gen[grow])  # (G, 4)
            ksig = t.mag[kids] >= thr
            kcnt = 1 + ksig.long()
            cnt = torch.ones_like(gen)
            cnt[grow] += kcnt.sum(1)
            start = _excl_cumsum(cnt)
            seg = _segment(int(cnt.sum()), dev)
            seg[start] = sig
            kstart = start[grow][:, None] + 1 + _excl_cumsum(kcnt, 1)
            seg[kstart] = ksig
            seg[kstart[ksig] + 1] = signs[kids[ksig]]
            sign_cells.append(kids[ksig])
            sign_pos.append(pos + kstart[ksig] + 1)
            new_lsp.append(kids[ksig])
            new_lip.append(kids[~ksig])
            chunks.append(seg)
            pos += seg.numel()
            kept.append(gen[~sig])
            kept_a.append(gen_a[~sig])
            # the next generation: an expanded A re-queued as B, or an
            # expanded B's four children as A, in visiting order
            slot = torch.full((gen.numel(), 4), -1, dtype=torch.long,
                              device=dev)
            as_b = torch.zeros_like(grow)
            as_b[grow] = t.requeue[gen[grow] % t.hw]
            slot[as_b, 0] = gen[as_b]
            open_b = ~gen_a & sig
            slot[open_b] = t.children(gen[open_b])
            slot_a = torch.ones_like(slot, dtype=torch.bool)
            slot_a[as_b, 0] = False
            valid = slot >= 0
            gen, gen_a = slot[valid], slot_a[valid]
        lis = torch.cat(kept)
        lis_a = torch.cat(kept_a)
        lip = torch.cat(new_lip)

        # refinement pass over the entries found before this plane
        rbits = ((t.mag[lsp] >> n) & 1).bool()
        chunks.append(rbits)
        rpos = pos + torch.arange(old, device=dev)
        pos += old
        lsp = torch.cat(new_lsp)

        # what a decoder of the first max_bits bits holds after this plane
        cells, where = torch.cat(sign_cells), torch.cat(sign_pos)
        cells = cells[where < max_bits]
        rec[cells] = torch.where(signs[cells], base, -base)
        r = rpos < max_bits
        cells, bit = lsp[:old][r], rbits[r].long()
        mag = (rec[cells].abs() & ~(1 << n)) | (bit << n)
        rec[cells] = torch.where(rec[cells] >= 0, mag, -mag)

    bits = torch.cat(chunks) if chunks else _segment(0, dev)
    if bits.numel() > max_bits and max_bits % 8:
        raise ValueError(f"a cut at {max_bits} bits is not byte aligned")
    bits = bits[:max_bits]
    nbits = bits.numel()
    packed = np.packbits(bits.cpu().numpy().astype(np.uint8),
                         bitorder="little").tobytes()
    return packed, nbits, max_n, rec.reshape(c, h, w)
