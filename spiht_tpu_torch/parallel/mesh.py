"""Device meshes and shardings, the port of ``spiht_tpu/parallel/mesh.py``.

The framework's two parallel axes (SURVEY.md §2, new-components table):
  * "batch" — data parallelism: independent images per device slice.
  * "tile"  — spatial parallelism: one image's W axis sharded, with DWT
    halo exchange (parallel/spatial.py).

Without a process group (or in a group of one process) a mesh is single
controller, as JAX's ``shard_map`` is: one process drives every device of
it. A mesh is a grid of ``torch.device``s, and a device may repeat:
``[torch.device("cuda", 0)] * 4`` gives four shards on one card, the
counterpart of XLA's virtual host devices
(``--xla_force_host_platform_device_count``); ``[torch.device("cpu")] *
8`` is the CPU tests' 8-device mesh. A value placed under a sharding is a
``ShardedTensor``: one block per mesh position, on that position's device
(``place``; ``gather`` puts the blocks back together).

After ``distributed.initialize`` with two or more processes, a mesh spans
the ranks of the group, as ``make_mesh`` spans every process's devices
after ``jax.distributed.initialize``: mesh position k (row-major) is rank
k, on that rank's device. Every rank runs the same program (SPMD); a
rank's ``ShardedTensor`` holds the block of its own position only (None
at the others), and the collectives of ``parallel.spatial`` move data
between ranks over the group. Outputs that JAX replicates (``P()``) are
on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import cuda_devices, resolve_device

__all__ = [
    "Mesh", "Sharding", "ShardedTensor", "make_mesh", "batch_sharding",
    "image_sharding", "place", "gather",
]


@dataclasses.dataclass(frozen=True)
class RankLine:
    """This rank's line of ranks along one axis of a mesh over ranks: its
    index ``me`` on the line, the line's global ``ranks`` in axis order,
    the ``group`` over them (None: the default group, when the line is
    the whole world) and the group's ``backend`` ("gloo" or "nccl")."""

    me: int
    ranks: Tuple[int, ...]
    group: object
    backend: str


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of devices with named axes. ``shape`` maps each axis
    name to its size, as ``jax.sharding.Mesh.shape`` does. On a mesh over
    the ranks of a process group, ``rank`` is this process's rank (its
    position is ``divmod(rank, sp)``) and ``lines`` holds its `RankLine`
    along each axis; both are None on a single-controller mesh."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str]
    rank: Optional[int] = None
    lines: Optional[Tuple[RankLine, RankLine]] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def position(self) -> Optional[Tuple[int, int]]:
        """This rank's (row, column) on a mesh over ranks, else None."""
        if self.rank is None:
            return None
        return divmod(self.rank, len(self.devices[0]))

    def line(self, axis_name: str) -> Optional[RankLine]:
        """This rank's line along ``axis_name``; None on a
        single-controller mesh."""
        if self.lines is None:
            return None
        return self.lines[self.axis_names.index(axis_name)]

    def axis_devices(self, axis_name: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis_name`` at index 0 of the other axis (on
        a mesh over ranks, at this rank's index): the shards a function
        sharded over that axis runs on."""
        k = 0 if self.rank is None else self.position[
            1 - self.axis_names.index(axis_name)]
        if self.axis_names.index(axis_name) == 0:
            return tuple(row[k] for row in self.devices)
        return self.devices[k]

    def output_device(self, axis_name: str) -> torch.device:
        """Where a function sharded over ``axis_name`` leaves the outputs
        that JAX replicates: the axis's first device, or on a mesh over
        ranks this rank's device."""
        if self.rank is None:
            return self.axis_devices(axis_name)[0]
        i, j = self.position
        return self.devices[i][j]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``NamedSharding(mesh, P(*spec))``: ``spec[d]`` names the mesh axis
    that dimension d is split over, or is None (whole on every device)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A global tensor of ``shape`` held as ``blocks[i][j]``, the block of
    mesh position (i, j), on that position's device. On a mesh over ranks
    a rank holds the block of its own position, and None at the others."""

    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    sharding: Sharding
    shape: Tuple[int, ...]


def _world():
    """(rank, world size) of the initialized process group, or None where
    there is none or it has one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() == 1:
        return None
    return dist.get_rank(), dist.get_world_size()


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("batch", "tile"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D (batch, tile) mesh over the given devices, by default
    every CUDA device (raises without a card).

    shape=None picks (n_devices, 1) — pure data parallelism; pass e.g.
    (2, 4) to dedicate 4-way spatial sharding within each DP group.

    In a process group of two or more ranks the mesh spans the ranks
    (`_rank_mesh`): every rank calls ``make_mesh`` with the same shape.
    """
    world = _world()
    if world is not None:
        return _rank_mesh(shape, tuple(axis_names), devices, *world)
    devices = [torch.device(d) for d in (
        cuda_devices() if devices is None else devices)]
    if shape is None:
        shape = (len(devices), 1)
    dp, sp = shape
    if dp * sp > len(devices):
        raise ValueError(f"mesh {shape} needs {dp*sp} devices, have {len(devices)}")
    grid = tuple(tuple(devices[i * sp:(i + 1) * sp]) for i in range(dp))
    return Mesh(grid, tuple(axis_names))


def _rank_mesh(shape, axis_names, devices, rank: int, world: int) -> Mesh:
    """A (dp, sp) mesh whose position k (row-major) is rank k.

    ``devices`` names this rank's device, one entry (``["cpu"]`` for CPU
    ranks); by default it is the card ``torch.cuda.current_device()``
    (raises without one), as ``make_mesh`` defaults to every card. The
    mesh must
    have one position a rank. The group's backend must be gloo or nccl
    (nccl needs a CUDA device). Collective: every rank exchanges its
    device's name, and a mesh with both axes longer than 1 creates a
    group for each row and each column (``dist.new_group``; they live as
    long as the default group).
    """
    import torch.distributed as dist

    dp, sp = shape if shape is not None else (world, 1)
    if dp * sp != world:
        raise ValueError(f"mesh {(dp, sp)} has {dp * sp} positions; the "
                         f"process group has {world} ranks")
    if devices is None:
        dev = resolve_device(None)
    elif len(devices) == 1:
        dev = torch.device(devices[0])
    else:
        raise ValueError(f"{len(devices)} devices for a mesh over ranks: "
                         f"name this rank's device only")
    backend = dist.get_backend()
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"a mesh over ranks needs a gloo or nccl group, "
                         f"not {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl group moves CUDA tensors; this rank's "
                         f"device is {dev}")
    names = [None] * world
    dist.all_gather_object(names, str(dev))
    grid = tuple(tuple(torch.device(names[i * sp + j]) for j in range(sp))
                 for i in range(dp))
    i, j = divmod(rank, sp)
    rows = [tuple(r * sp + c for c in range(sp)) for r in range(dp)]
    cols = [tuple(r * sp + c for r in range(dp)) for c in range(sp)]
    # every rank creates every group, in the same order
    groups = {}
    if dp > 1 and sp > 1:
        groups = {ranks: dist.new_group(list(ranks)) for ranks in rows + cols}
    lines = (RankLine(i, cols[j], groups.get(cols[j]), backend),
             RankLine(j, rows[i], groups.get(rows[i]), backend))
    return Mesh(grid, axis_names, rank, lines)


def to_wire(t: torch.Tensor, backend: str) -> torch.Tensor:
    """The tensor a collective of ``backend`` moves: ``t`` contiguous on
    its device for nccl; a contiguous host copy for gloo, which moves only
    host tensors in send/recv and all-gather (this is gloo's transport: the
    arithmetic stays on the rank's device)."""
    t = t.detach()
    if backend == "gloo":
        t = t.cpu()
    return t.contiguous()


def batch_sharding(mesh: Mesh) -> Sharding:
    """Sharding for a (B, C, H, W) image batch: B over 'batch'."""
    return Sharding(mesh, (mesh.axis_names[0],))


def image_sharding(mesh: Mesh) -> Sharding:
    """Sharding for a (B, C, H, W) batch with W over 'tile' as well."""
    a0, a1 = mesh.axis_names
    return Sharding(mesh, (a0, None, None, a1))


def _block_index(x_shape, sharding: Sharding, i: int, j: int):
    mesh = sharding.mesh
    coord = {mesh.axis_names[0]: i, mesh.axis_names[1]: j}
    idx = []
    for d, axis in enumerate(sharding.spec):
        if axis is None:
            idx.append(slice(None))
            continue
        n = mesh.shape[axis]
        if x_shape[d] % n:
            raise ValueError(
                f"dimension {d} of size {x_shape[d]} does not divide over "
                f"mesh axis {axis!r} of size {n}"
            )
        k = x_shape[d] // n
        idx.append(slice(coord[axis] * k, (coord[axis] + 1) * k))
    return tuple(idx)


def place(x, sharding: Sharding) -> ShardedTensor:
    """``jax.device_put(x, sharding)``: each mesh position gets its own copy
    of its block, on its device. Every split dimension must divide over its
    axis. On a mesh over ranks every rank passes the same full value and
    keeps the block of its own position (None at the others)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if len(sharding.spec) > x.dim():
        raise ValueError(f"spec {sharding.spec} has more entries than "
                         f"the {x.dim()} dims of the value")
    pos = sharding.mesh.position
    blocks = tuple(
        tuple(x[_block_index(x.shape, sharding, i, j)].to(dev, copy=True)
              if pos in (None, (i, j)) else None
              for j, dev in enumerate(row))
        for i, row in enumerate(sharding.mesh.devices)
    )
    return ShardedTensor(blocks, sharding, tuple(x.shape))


def gather(xs: ShardedTensor, device=None) -> torch.Tensor:
    """The global tensor of ``xs`` on ``device`` (default: the first mesh
    device; on a mesh over ranks, this rank's device, on every rank: one
    all-gather of the blocks, which all have one shape). Replicated
    positions hold equal blocks; the last one written stands."""
    mesh = xs.sharding.mesh
    blocks = xs.blocks
    if mesh.rank is not None:
        import torch.distributed as dist

        i, j = mesh.position
        backend = mesh.lines[0].backend
        mine = to_wire(blocks[i][j], backend)
        sp = len(blocks[0])
        got = [torch.empty_like(mine) for _ in range(len(blocks) * sp)]
        dist.all_gather(got, mine)
        blocks = tuple(tuple(got[r * sp:(r + 1) * sp])
                       for r in range(len(blocks)))
    dev = mesh.output_device(mesh.axis_names[1]) if device is None else device
    first = blocks[0][0]
    out = torch.empty(xs.shape, dtype=first.dtype, device=dev)
    for i, row in enumerate(blocks):
        for j, block in enumerate(row):
            out[_block_index(xs.shape, xs.sharding, i, j)] = block.to(dev)
    return out
