"""Device meshes and shardings, the port of ``spiht_tpu/parallel/mesh.py``.

The framework's two parallel axes (SURVEY.md §2, new-components table):
  * "batch" — data parallelism: independent images per device slice.
  * "tile"  — spatial parallelism: one image's W axis sharded, with DWT
    halo exchange (parallel/spatial.py).

Single controller, as JAX's ``shard_map`` is: one process drives every
device of its mesh. A mesh is a grid of ``torch.device``s, and a device
may repeat: ``[torch.device("cuda", 0)] * 4`` gives four shards on one
card, the counterpart of XLA's virtual host devices
(``--xla_force_host_platform_device_count``); ``[torch.device("cpu")] *
8`` is the CPU tests' 8-device mesh. A value placed under a sharding is a
``ShardedTensor``: one block per mesh position, on that position's device
(``place``; ``gather`` puts the blocks back together).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import cuda_devices

__all__ = [
    "Mesh", "Sharding", "ShardedTensor", "make_mesh", "batch_sharding",
    "image_sharding", "place", "gather",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of devices with named axes. ``shape`` maps each axis
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str]

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def axis_devices(self, axis_name: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis_name`` at index 0 of the other axis: the
        shards a function sharded over that axis runs on."""
        if self.axis_names.index(axis_name) == 0:
            return tuple(row[0] for row in self.devices)
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``NamedSharding(mesh, P(*spec))``: ``spec[d]`` names the mesh axis
    that dimension d is split over, or is None (whole on every device)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A global tensor of ``shape`` held as ``blocks[i][j]``, the block of
    mesh position (i, j), on that position's device."""

    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    sharding: Sharding
    shape: Tuple[int, ...]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("batch", "tile"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D (batch, tile) mesh over the given devices, by default
    every CUDA device (raises without a card).

    shape=None picks (n_devices, 1) — pure data parallelism; pass e.g.
    (2, 4) to dedicate 4-way spatial sharding within each DP group.
    """
    devices = [torch.device(d) for d in (
        cuda_devices() if devices is None else devices)]
    if shape is None:
        shape = (len(devices), 1)
    dp, sp = shape
    if dp * sp > len(devices):
        raise ValueError(f"mesh {shape} needs {dp*sp} devices, have {len(devices)}")
    grid = tuple(tuple(devices[i * sp:(i + 1) * sp]) for i in range(dp))
    return Mesh(grid, tuple(axis_names))


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
    axis."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if len(sharding.spec) > x.dim():
        raise ValueError(f"spec {sharding.spec} has more entries than "
                         f"the {x.dim()} dims of the value")
    blocks = tuple(
        tuple(x[_block_index(x.shape, sharding, i, j)].to(dev, copy=True)
              for j, dev in enumerate(row))
        for i, row in enumerate(sharding.mesh.devices)
    )
    return ShardedTensor(blocks, sharding, tuple(x.shape))


def gather(xs: ShardedTensor, device=None) -> torch.Tensor:
    """The global tensor of ``xs`` on ``device`` (default: the first mesh
    device). Replicated positions hold equal blocks; the last one written
    stands."""
    dev = xs.sharding.mesh.devices[0][0] if device is None else device
    first = xs.blocks[0][0]
    out = torch.empty(xs.shape, dtype=first.dtype, device=dev)
    for i, row in enumerate(xs.blocks):
        for j, block in enumerate(row):
            out[_block_index(xs.shape, xs.sharding, i, j)] = block.to(dev)
    return out
