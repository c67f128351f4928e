"""Spatially-sharded DWT, the port of ``spiht_tpu/parallel/spatial.py``:
one huge image split across devices along W.

The reference does whole-image DWTs with no tiling (README.md:9); scaling
to 8K+ images means sharding the image across devices and exchanging only
filter-support-sized halos:

 * Every level's column pass runs with the W axis sharded over a mesh
   axis while its geometry permits (`_level_shardable`): each shard
   pulls a filter-support halo from its neighbor (`ppermute`, one hop);
   the global boundary extensions are materialized locally by the edge
   shards, so results are EXACTLY the unsharded transform — boundary
   semantics included.
 * The row pass is along the unsharded H axis — fully local.
 * Arbitrary global widths: the image is padded internally to equal
   shard blocks, only valid columns are ever read, and between levels a
   RESHARD step (a static number of ppermute hops + a clamped slice)
   absorbs the drift between the previous level's output blocks and the
   next level's input blocks that pywt's non-dyadic boundary growth
   creates. Tiny deep levels and periodization's ring wraparound fall
   back to one gather + compute on one device.

A sharded value is a list of per-shard tensors, shard s on the s-th
device along the mesh axis (``Mesh.axis_devices``), and each body below
loops over the shards. The edge shards' choices (``jnp.where(s == 0,
...)``, ``s == n - 1``) are static per shard here; with one shard, shard
0 is also the last. The collectives are ``ppermute``, ``all_gather``,
``broadcast``, ``pmax`` and ``psum`` below: the bodies call nothing else
to move data between shards.

On a single-controller mesh one process runs every shard: each copy
between shards is a real copy, also between two shards on one device. A
tensor runs on one row of shards, the axis's devices. A sharded input
(``mesh.place``) is used where its blocks lie, and where the other mesh
axis splits its leading (batch) dimension each row of shards transforms
its part of the batch on its own devices (the JAX bodies replicate over
that axis instead; the values are the same). Outputs live on the first
device of the sharded axis.

On a mesh over the ranks of a process group (``mesh.make_mesh`` after
``distributed.initialize``) every rank runs the same bodies, SPMD, and a
rank's list holds its own shard only: None at the other ranks' shards,
which the loops skip. The collectives then run over the group, every
rank issuing the same ones in the same order: ``ppermute`` is one
``batch_isend_irecv`` of the pairs that touch the rank, ``all_gather``
is ``dist.all_gather``, ``broadcast`` is ``dist.broadcast``, ``pmax`` /
``psum`` are ``all_reduce`` (MAX / SUM). Every shard's block has one
shape, as in JAX. A tensor input runs on every row of ranks (JAX
replicates over the other axis); a placed input whose batch is split
over the other axis is transformed by each row of ranks on its part and
joined by an all-gather over that axis. Every rank returns the outputs
JAX replicates, on its own device.

Everything stays elementwise (``dwt.extend``, ``dwt._shift_mac``): no
convolution or matrix product, so no TF32 pass touches a coefficient and
float64 results equal ``dwt.wavedec2_packed``'s bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..wavelets import dwt
from ..wavelets.filters import Wavelet, build_wavelet, dwt_coeff_len
from .mesh import Mesh, RankLine, ShardedTensor, to_wire

__all__ = [
    "sharded_dwt2_level1",
    "sharded_wavedec2_packed",
    "sharded_plane_stats",
    "levels_plan",
]


# ---------------------------------------------------------------------------
# collectives over a list of per-shard tensors (shard s on its device). With
# ``line``, a RankLine of two or more ranks, the list is this rank's: its
# own shard at ``line.me``, None elsewhere, and the data moves over the
# line's group. Under gloo each collective copies to the host and back
# (``mesh.to_wire``); under nccl device tensors move directly.
# ---------------------------------------------------------------------------


def _over_ranks(line: Optional[RankLine]) -> bool:
    return line is not None and len(line.ranks) > 1


def _wire_buffer(x: torch.Tensor, backend: str) -> torch.Tensor:
    """An empty tensor shaped like ``x`` where ``backend`` receives it."""
    return torch.empty(x.shape, dtype=x.dtype,
                       device="cpu" if backend == "gloo" else x.device)


def ppermute(blocks: List[torch.Tensor], perm,
             line: Optional[RankLine] = None) -> List[torch.Tensor]:
    """``lax.ppermute``: shard ``dst`` receives a copy of shard ``src``'s
    block for each (src, dst) in ``perm``; a shard no source sends to
    receives zeros of the same shape. Over ranks: one
    ``batch_isend_irecv`` of the pairs that touch this rank."""
    if not _over_ranks(line):
        out = [None] * len(blocks)
        for src, dst in perm:
            out[dst] = blocks[src].to(blocks[dst].device, copy=True)
        return [torch.zeros_like(b) if o is None else o
                for o, b in zip(out, blocks)]
    import torch.distributed as dist

    x = blocks[line.me]
    ops, got = [], None
    for src, dst in perm:
        if src == line.me:
            ops.append(dist.P2POp(dist.isend, to_wire(x, line.backend),
                                  line.ranks[dst]))
        if dst == line.me:
            got = _wire_buffer(x, line.backend)
            ops.append(dist.P2POp(dist.irecv, got, line.ranks[src]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = [None] * len(blocks)
    out[line.me] = torch.zeros_like(x) if got is None else got.to(x.device)
    return out


def all_gather(blocks: List[torch.Tensor], device,
               line: Optional[RankLine] = None) -> List[torch.Tensor]:
    """``lax.all_gather`` where its replicated result lives: a copy of
    every shard's block, in shard order, on ``device`` (over ranks, on
    every rank: ``dist.all_gather``)."""
    if not _over_ranks(line):
        return [b.to(device, copy=True) for b in blocks]
    import torch.distributed as dist

    x = to_wire(blocks[line.me], line.backend)
    got = [torch.empty_like(x) for _ in line.ranks]
    dist.all_gather(got, x, group=line.group)
    return [g.to(device) for g in got]


def broadcast(blocks: List[torch.Tensor], src: int, dsts,
              line: Optional[RankLine] = None) -> List[torch.Tensor]:
    """A copy of shard ``src``'s block for each shard in ``dsts``, on that
    shard's device (None at the other shards). Over ranks: one
    ``dist.broadcast`` from shard ``src``'s rank over the line."""
    if not _over_ranks(line):
        return [blocks[src].to(b.device, copy=True) if s in dsts else None
                for s, b in enumerate(blocks)]
    import torch.distributed as dist

    x = blocks[line.me]
    buf = (to_wire(x, line.backend).clone() if line.me == src
           else _wire_buffer(x, line.backend))
    dist.broadcast(buf, line.ranks[src], group=line.group)
    out = [None] * len(blocks)
    if line.me in dsts:
        out[line.me] = buf.to(x.device)
    return out


def _all_reduce(values, device, line: RankLine, op: str) -> torch.Tensor:
    """``all_reduce`` (``op``: "MAX" or "SUM") of this rank's value."""
    import torch.distributed as dist

    v = to_wire(values[line.me], line.backend).clone()
    dist.all_reduce(v, op=getattr(dist.ReduceOp, op), group=line.group)
    return v.to(device)


def pmax(values: List[torch.Tensor], device,
         line: Optional[RankLine] = None) -> torch.Tensor:
    """``lax.pmax`` of per-shard values, on ``device`` (over ranks:
    ``all_reduce`` MAX)."""
    if _over_ranks(line):
        return _all_reduce(values, device, line, "MAX")
    return torch.stack(all_gather(values, device)).amax(dim=0)


def psum(values: List[torch.Tensor], device,
         line: Optional[RankLine] = None) -> torch.Tensor:
    """``lax.psum`` of per-shard values in their dtype (int32 wraps as in
    JAX), on ``device`` (over ranks: ``all_reduce`` SUM)."""
    if _over_ranks(line):
        return _all_reduce(values, device, line, "SUM")
    g = all_gather(values, device)
    return torch.stack(g).sum(dim=0, dtype=g[0].dtype)


def _at(line: RankLine, value) -> list:
    """A list along ``line`` holding ``value`` at this rank's index."""
    return [value if k == line.me else None for k in range(len(line.ranks))]


def _each(fn, xs: list) -> list:
    """``fn`` of each shard this process holds; None stays None."""
    return [None if x is None else fn(x) for x in xs]


def _held(xs: list) -> torch.Tensor:
    """A shard this process holds (every shard has its shape)."""
    return next(x for x in xs if x is not None)


# ---------------------------------------------------------------------------


def _as_wavelet(wavelet: Union[str, Wavelet]) -> Wavelet:
    return wavelet if isinstance(wavelet, Wavelet) else build_wavelet(wavelet)


@dataclasses.dataclass(frozen=True)
class _Row:
    """One row of shards along the sharded axis: shard s on ``devs[s]``,
    the row's replicated outputs on ``out``; on a mesh over ranks,
    ``line`` is this rank's line along the axis."""

    devs: Tuple[torch.device, ...]
    out: torch.device
    line: Optional[RankLine] = None


def _rows(x, mesh: Mesh, axis_name: str):
    """The rows of shards a sharded function runs, ``([(row, x)],
    across)``. A tensor (or array) is one row on the axis's devices,
    whole: the body splits it. A ShardedTensor whose last dimension is
    split over ``axis_name`` is used where it lies: a row is the list of
    its blocks, one a shard. Where the other axis splits the leading
    dimension (``image_sharding``), each of its rows holds its own part of
    the batch; where it splits nothing its rows are replicas, and the
    first one runs. On a mesh over ranks each rank runs its own row, its
    list holding its own block; ``across`` is then its line along the
    other axis where that axis splits the batch (the rows' outputs are
    joined over it), else None."""
    line = mesh.line(axis_name)
    here = _Row(mesh.axis_devices(axis_name), mesh.output_device(axis_name),
                line)
    if not isinstance(x, ShardedTensor):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return [(here, x)], None
    ax = mesh.axis_names.index(axis_name)
    other = mesh.axis_names[1 - ax]
    spec = x.sharding.spec + (None,) * (len(x.shape) - len(x.sharding.spec))
    if (x.sharding.mesh != mesh or spec[-1] != axis_name
            or axis_name in spec[:-1] or other in spec[1:]):
        raise ValueError(
            f"a sharded input needs its last dimension split over "
            f"{axis_name!r} of this mesh and at most its first over "
            f"{other!r}; its spec is {x.sharding.spec}")
    if line is not None:
        i, j = mesh.position
        across = mesh.line(other) if spec[0] == other else None
        return [(here, _at(line, x.blocks[i][j]))], across
    grid = x.blocks if ax == 1 else tuple(zip(*x.blocks))
    devs = mesh.devices if ax == 1 else tuple(zip(*mesh.devices))
    rows = range(len(grid)) if spec[0] == other else range(1)
    return [(_Row(devs[k], devs[k][0]), list(grid[k])) for k in rows], None


def _join_rows(parts: List[torch.Tensor], device,
               across: Optional[RankLine] = None) -> torch.Tensor:
    """The rows' outputs, one batch on ``device`` (the first row's outputs
    are already there); over ranks, this row's output gathered over
    ``across``, the other axis."""
    if across is not None:
        parts = all_gather(_at(across, parts[0]), device, across)
    elif len(parts) > 1:
        parts = all_gather(parts, device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _split(x: torch.Tensor, row: _Row, S: int) -> List[torch.Tensor]:
    """Shard s gets a copy of columns [s*S, (s+1)*S) on its device (over
    ranks, this rank's shard only)."""
    me = None if row.line is None else row.line.me
    return [x[..., s * S:(s + 1) * S].to(d, copy=True) if me in (None, s)
            else None for s, d in enumerate(row.devs)]


def _mac(xl: torch.Tensor, taps, out_len: int) -> torch.Tensor:
    return dwt._shift_mac(xl, np.asarray(taps)[::-1], 2, out_len)


def _col_pass_local(xs, wav: Wavelet, mode: str, line=None):
    """Per-shard body: level-1 column (last-axis) DWT with halo exchange.

    xs: per-shard (..., H, Ws). Returns per-shard (cA, cD) of shape (...,
    H, q+e) where the last e columns are only meaningful on the last shard.
    """
    n = len(xs)
    F = wav.dec_len
    halo = F - 2
    e = (F - 1) // 2
    Ws = _held(xs).shape[-1]
    q = Ws // 2

    # neighbor halo: shard s receives the rightmost F-2 columns of s-1
    left_recv = ppermute(_each(lambda x: x[..., Ws - halo:], xs),
                         [(i, i + 1) for i in range(n - 1)], line)
    cA, cD = [], []
    for s, x in enumerate(xs):
        if x is None:  # another rank's shard
            cA.append(None)
            cD.append(None)
            continue
        # edge shards materialize the global boundary extension locally
        ext_full = dwt.extend(x, F - 1, mode)  # (..., Ws + 2F - 2)
        left = ext_full[..., 1:1 + halo] if s == 0 else left_recv[s]
        right_tail = ext_full[..., F - 1 + Ws:F - 1 + Ws + 2 * e]
        xl = torch.cat([left, x, right_tail], dim=-1)
        cA.append(_mac(xl, wav.dec_lo, q + e))
        cD.append(_mac(xl, wav.dec_hi, q + e))
    return cA, cD


def _reassemble(g, q: int, e: int) -> torch.Tensor:
    """n gathered (..., L, q+e) blocks -> (..., L, n*q+e) global array."""
    parts = [b[..., :q] for b in g]
    if e:
        parts.append(g[-1][..., q:])
    return torch.cat(parts, dim=-1)


def sharded_dwt2_level1(
    x,
    wavelet: Union[str, Wavelet],
    mode: str,
    mesh: Mesh,
    axis_name: str = "tile",
):
    """One 2D DWT level with W sharded over ``mesh[axis_name]``.

    x: (..., H, W) with W % n == 0 and (W//n) even. Returns the dict
    {'aa','ad','da','dd'} on the axis's first device (over ranks, on each
    rank's), exactly equal to dwt.dwt2(x).
    """
    wav = _as_wavelet(wavelet)
    n = mesh.shape[axis_name]
    W = x.shape[-1]
    F = wav.dec_len
    if W % n != 0 or (W // n) % 2 != 0:
        raise ValueError(
            f"W={W} must be divisible by {n} shards with even shard width"
        )
    if W // n < F:
        # edge shards materialize the global boundary extension from their
        # local block (reflect reaches column F-2) and neighbor halos come
        # from ONE ppermute hop — both need shard width >= filter length
        raise ValueError(
            f"shard width {W // n} must be >= filter length {F}"
        )
    e = (F - 1) // 2
    q = (W // n) // 2
    outs = []
    shard_rows, across = _rows(x, mesh, axis_name)
    for row, xr in shard_rows:
        xs = xr if isinstance(xr, list) else _split(xr, row, W // n)
        # row pass along H first (matches dwt2's axis order bit-for-bit; H
        # is unsharded so this is fully local)
        rows = _each(lambda xl: dwt.dwt1d(xl, wav, mode, axis=-2), xs)
        # column pass along the sharded W axis, with halo exchange
        aa, ad = _col_pass_local(_each(lambda r: r[0], rows), wav, mode,
                                 row.line)
        da, dd = _col_pass_local(_each(lambda r: r[1], rows), wav, mode,
                                 row.line)
        # gather the level-1 subbands; each is (..., H', q+e) per shard
        outs.append([_reassemble(all_gather(b, row.out, row.line), q, e)
                     for b in (aa, ad, da, dd)])
    dev0 = mesh.output_device(axis_name)
    # note pywt key convention (dwt2): first char = row axis
    return {k: _join_rows([o[i] for o in outs], dev0, across)
            for i, k in enumerate(("aa", "ad", "da", "dd"))}


# ---------------------------------------------------------------------------
# Recursive sharded multilevel DWT: every level runs with W sharded while
# its geometry permits, with NO constraints on the global width —
# arbitrary images are padded internally to equal shard blocks and only
# valid columns are ever read. Ownership convention per level: the global
# width Wl is padded to n*S (S = Wl/n rounded up to even); shard s owns
# global columns [s*S, (s+1)*S), the last shard's block being partially
# valid (V = Wl - (n-1)*S columns, a static count). The column pass gives
# shard s the outputs [s*S/2, ...), so the next level starts with a
# RESHARD step: a static number of ppermute hops brings the few columns of
# drift between the old output blocks and the new input blocks (the
# non-dyadic pywt boundary growth makes the two block sizes differ by
# O(F/n) columns per level).
# ---------------------------------------------------------------------------


def _even_ceil(W: int, n: int) -> int:
    s = -(-W // n)
    return s + (s % 2)


def _level_shardable(W: int, n: int, F: int, mode: str) -> bool:
    if mode in ("periodic", "periodization"):
        return False  # ring wraparound halos not implemented
    S = _even_ceil(W, n)
    V = W - (n - 1) * S
    # one-hop halos + locally-computable boundary extensions + no empty
    # shards + headroom for the reshard drift
    return S >= F + 2 * n and V >= max(F - 1, 1)


def _col_pass_general(xs, wav: Wavelet, mode: str, W: int, S: int,
                      line=None):
    """Column (last-axis) DWT of the equal-block sharded signal.

    xs: per-shard (..., H, S), shard s holding global cols [s*S, (s+1)*S)
    (last block valid only up to V = W - (n-1)*S). Returns per-shard (cA,
    cD) of shape (..., H, OBUF) where shard s owns outputs [s*S/2, ...):
    full shards own Ol = S/2, the last shard V' = W' - (n-1)*Ol (OBUF =
    max(Ol, V')).
    """
    n = len(xs)
    F = wav.dec_len
    hw = F - 2
    Ol = S // 2
    Wp = dwt_coeff_len(W, F, mode)
    V = W - (n - 1) * S
    Vp = Wp - (n - 1) * Ol
    eo = max(0, Vp - Ol)
    OBUF = Ol + eo

    # left halo: rightmost hw cols of the left neighbor (full blocks)
    left_recv = ppermute(_each(lambda x: x[..., S - hw:], xs),
                         [(i, i + 1) for i in range(n - 1)], line)
    # right fill (2*eo cols): interior shards read the right neighbor's
    # first cols; the LAST shard substitutes its valid block + the global
    # right boundary extension
    rf = 2 * eo
    if rf > 0:
        right_recv = ppermute(_each(lambda x: x[..., :rf], xs),
                              [(i + 1, i) for i in range(n - 1)], line)
    cA, cD = [], []
    for s, x in enumerate(xs):
        if x is None:  # another rank's shard
            cA.append(None)
            cD.append(None)
            continue
        if s == 0:
            # global left boundary extension
            left = dwt.extend(x, F - 1, mode)[..., 1:1 + hw]
        else:
            left = left_recv[s]
        if s < n - 1:
            parts = [left, x] + ([right_recv[s]] if rf > 0 else [])
        else:
            # last shard: [halo | valid V | extension+pad to S - V + rf]
            valid = x[..., :V]
            ext_last = dwt.extend(valid, F - 1, mode)[..., F - 1 + V:]
            fill_len = S - V + rf
            if fill_len > F - 1:
                pad = ext_last.new_zeros(
                    ext_last.shape[:-1] + (fill_len - (F - 1),))
                fill = torch.cat([ext_last, pad], dim=-1)
            else:
                fill = ext_last[..., :fill_len]
            parts = [left, valid, fill]
        xl = torch.cat(parts, dim=-1)
        cA.append(_mac(xl, wav.dec_lo, OBUF))
        cD.append(_mac(xl, wav.dec_hi, OBUF))
    return cA, cD


def _reshard_plan(n: int, Ol: int, eo: int, W_new: int, S_new: int):
    """Static plan to move from output blocks (stride Ol, buffer Ol+eo,
    last block valid to Ol+eo) to input blocks of stride S_new.

    Returns (KL, KR, fixups), or None if the drift exceeds what the
    frame construction covers (then the caller falls back to gathering).
    """
    def holder(c):
        return min(c // Ol, n - 1)

    KL = KR = 0
    for s in range(n):
        start = s * S_new
        end = min(min(start + S_new, W_new), n * Ol)
        if end <= start:
            continue
        KL = max(KL, s - holder(start))
        KR = max(KR, holder(end - 1) - s)
    if (KL + KR + 1) * Ol < S_new:
        # the frame cannot hold a block (one shard: KL = KR = 0 and the
        # block outgrows Ol). The JAX package's plan misses this and its
        # dynamic_slice raises at trace time; here the level falls back
        return None
    # frame validity: the part of shard s's slice below n*Ol must sit in
    # [(s-KL)*Ol, (s+KR+1)*Ol); global cols >= n*Ol (the last block's eo
    # tail) are patched in afterwards from a broadcast of that tail
    fixups = []
    for s in range(n):
        start = s * S_new
        end = min(start + S_new, W_new)
        lo = (s - KL) * Ol
        hi = (s + KR + 1) * Ol
        if start < lo or min(end, n * Ol) > hi:
            return None
        if end > n * Ol:
            t_len = end - n * Ol
            if t_len > eo or start > n * Ol:
                return None
            # tail goes at local position n*Ol - start (static)
            fixups.append((s, n * Ol - start, t_len))
    return KL, KR, fixups


def _reshard(bufs, Ol: int, S_new: int, KL: int, KR: int, fixups,
             line=None):
    """Per-shard body: rebuild the S_new-block from neighboring output
    buffers using KL left + KR right ppermute hops + a clamped slice;
    global columns past n*Ol (the last output block's tail) are patched
    from a broadcast of that tail for the statically-known shards that
    need them."""
    n = len(bufs)
    hops = {0: bufs}
    for d in range(-KL, KR + 1):
        if d:
            # bring block s+d to shard s (zeros where s+d is off the mesh)
            hops[d] = ppermute(
                bufs, [(i + d, i) for i in range(n) if 0 <= i + d < n], line)
    out = []
    for s in range(n):
        if bufs[s] is None:  # another rank's shard
            out.append(None)
            continue
        frame = torch.cat([hops[d][s][..., :Ol] for d in range(-KL, KR + 1)],
                          dim=-1)
        # lax.dynamic_slice clamps its start into [0, len - size]
        off = min(max(s * (S_new - Ol) + KL * Ol, 0),
                  frame.shape[-1] - S_new)
        out.append(frame[..., off:off + S_new])
    if fixups:
        tails = broadcast(_each(lambda b: b[..., Ol:], bufs), n - 1,
                          {st for st, _, _ in fixups}, line)
        for st, pos, t_len in fixups:
            if out[st] is None:
                continue
            t = tails[st]
            out[st] = torch.cat(
                [out[st][..., :pos], t[..., :t_len],
                 out[st][..., pos + t_len:]], dim=-1)
    return out


def levels_plan(W: int, n: int, F: int, mode: str, level: int):
    """The static schedule of `sharded_wavedec2_packed`: one entry per
    level that runs sharded, ``(Wl, S, reshard)`` with ``reshard`` None
    for the first level and else the ``(KL, KR, fixups)`` of
    `_reshard_plan`. Levels past the list run after the gather."""
    plan = []
    Wl, prev = W, None
    while len(plan) < level and _level_shardable(Wl, n, F, mode):
        S = _even_ceil(Wl, n)
        reshard = None
        if prev is not None:
            reshard = _reshard_plan(n, *prev, Wl, S)
            if reshard is None:
                break
        plan.append((Wl, S, reshard))
        Wp = dwt_coeff_len(Wl, F, mode)
        Ol = S // 2
        prev = (Ol, max(0, Wp - (n - 1) * Ol - Ol))
        Wl = Wp
    return plan


def sharded_wavedec2_packed(
    x,
    wavelet: Union[str, Wavelet],
    mode: str,
    level: int,
    mesh: Mesh,
    axis_name: str = "tile",
) -> Tuple[torch.Tensor, int, int]:
    """Multilevel packed DWT of a W-sharded image, recursively sharded.

    Any global width (no divisibility/padding requirements): every level
    whose geometry passes `_level_shardable` runs with W sharded and
    ppermute halo exchange; the residue (tiny deep levels, or
    periodization wraparound) runs on the row's first device after one
    gather (over ranks, on every rank, as JAX's replicated residue).
    Bit-equal to dwt.wavedec2_packed on a single device
    (tests/test_torch_parallel.py, incl. an 8-shard 8K-wide image; over
    ranks, tests/test_torch_rank_mesh.py).
    """
    wav = _as_wavelet(wavelet)
    if level < 1:
        raise ValueError("level must be >= 1")
    shard_rows, across = _rows(x, mesh, axis_name)
    outs = [_packed_row(xr, row, x.shape[-1], wav, mode, level)
            for row, xr in shard_rows]
    arr = _join_rows([o[0] for o in outs], mesh.output_device(axis_name),
                     across)
    return arr, outs[0][1], outs[0][2]


def _packed_row(x, row: _Row, W: int, wav: Wavelet, mode: str, level: int):
    """`sharded_wavedec2_packed` on one row of shards: ``x`` is the whole
    tensor, or the row's blocks of W/n columns where they lie."""
    F = wav.dec_len
    n = len(row.devs)
    line = row.line
    details = []  # fine -> coarse, on row.out

    plan = levels_plan(W, n, F, mode, level)
    bufs = None  # per-shard approximation buffers (..., H, OBUF)
    for Wl, S, reshard in plan:
        if bufs is not None:
            xs = _reshard(bufs, Ol, S, *reshard, line)
        elif isinstance(x, list):
            # placed blocks of W/n columns -> blocks of S (S - W/n is 0 or
            # 1, and a shardable level leaves room for the drift)
            xs = _reshard(x, W // n, S, *_reshard_plan(n, W // n, 0, W, S),
                          line)
        else:
            pad = n * S - Wl
            xg = torch.nn.functional.pad(x, (0, pad)) if pad else x
            xs = _split(xg, row, S)
        Wp = dwt_coeff_len(Wl, F, mode)
        Ol = S // 2
        Vp = Wp - (n - 1) * Ol
        # row pass (H axis, fully local)
        rows = _each(lambda xl: dwt.dwt1d(xl, wav, mode, axis=-2), xs)
        aa, ad = _col_pass_general(_each(lambda r: r[0], rows), wav, mode,
                                   Wl, S, line)
        da, dd = _col_pass_general(_each(lambda r: r[1], rows), wav, mode,
                                   Wl, S, line)
        # details: gather + trim to the true global width
        d = {}
        for k, b in (("ad", ad), ("da", da), ("dd", dd)):
            g = all_gather(b, row.out, line)
            d[k] = torch.cat([t[..., :Ol] for t in g[:-1]] + [g[-1][..., :Vp]],
                             dim=-1)
        details.append(d)
        bufs, Wl_out = aa, Wp

    # residue: gather the sharded approximation, finish on row.out (over
    # ranks, every rank finishes it)
    if bufs is not None:
        g = all_gather(bufs, row.out, line)
        a = torch.cat([t[..., :Ol] for t in g[:-1]] + [g[-1]],
                      dim=-1)[..., :Wl_out]
    elif isinstance(x, list):
        a = torch.cat(all_gather(x, row.out, line), dim=-1)
    else:
        a = x.to(row.out)
    lvl = len(plan)
    if lvl < level:
        coeffs = dwt.wavedec2(a, wav, mode, level - lvl) + details[::-1]
    else:
        coeffs = [a] + details[::-1]
    return dwt.pack(coeffs, a.dtype)


def sharded_plane_stats(
    arr,
    mesh: Mesh,
    axis_name: str = "tile",
    planes: int = 32,
):
    """Per-shard significance tallies + psum reduction (no gather).

    The SURVEY §2 "subband-partial reductions" component: every shard
    tallies its local columns of the W-sharded quantized coefficient
    array and the mesh combines them with one `pmax` and one `psum` — the
    global max-magnitude (for the f32-truncated max_n rule) and
    per-bit-plane significance counts (what the stream planner's budget
    narrowing consumes) never require materializing the full array on one
    device.

    arr: (..., H, W) int32, W divisible by the axis size (the packed
    array's W is under the caller's control, unlike raw images); a tensor
    (split here) or a ShardedTensor whose last dimension is split over the
    axis (its blocks are used where they lie, every row of them where the
    other axis splits the batch). Returns (max_abs 0-d, counts[planes]
    int32) on the axis's first device (over ranks, on every rank's: one
    ``pmax`` and one ``psum`` over the axis, and where the other axis
    splits the batch one more of each over it).
    """
    n = mesh.shape[axis_name]
    if arr.shape[-1] % n != 0:
        raise ValueError("packed width must divide the mesh axis")
    blocks = []
    shard_rows, across = _rows(arr, mesh, axis_name)
    for row, xr in shard_rows:
        blocks += xr if isinstance(xr, list) else _split(
            xr, row, arr.shape[-1] // n)
    maxes, counts = [], []
    for a in blocks:
        if a is None:  # another rank's shard
            maxes.append(None)
            counts.append(None)
            continue
        mag = torch.abs(a).to(torch.int32)
        maxes.append(mag.max())
        # mag >> p nonzero  <=>  mag >= 2^p (int32-safe for p up to 31);
        # one plane at a time, not a (..., planes) intermediate
        counts.append(torch.stack([
            ((mag >> p) > 0).sum(dtype=torch.int32) for p in range(planes)
        ]))
    dev0 = mesh.output_device(axis_name)
    line = mesh.line(axis_name)
    gmax, gcounts = pmax(maxes, dev0, line), psum(counts, dev0, line)
    if across is not None:  # each row of ranks tallied its part of the batch
        gmax = pmax(_at(across, gmax), dev0, across)
        gcounts = psum(_at(across, gcounts), dev0, across)
    return gmax, gcounts
