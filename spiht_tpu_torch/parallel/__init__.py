"""Parallel/scaling layer, the port of ``spiht_tpu/parallel``: device
meshes, spatial sharding, consistency checks, multi-process glue, health.

  * mesh.py        — (batch, tile) meshes of torch devices, shardings,
                     ``place`` / ``gather`` (the port's ``device_put``)
  * spatial.py     — halo-exchange sharded DWT and plane statistics, with
                     the collectives (ppermute, all_gather, pmax, psum)
  * codec.py       — the sharded single-image encode (kernel B1)
  * consistency.py — replication checks, checkify's float checks
  * distributed.py — process group (a mesh over its ranks), host batch
                     slices, manifests
  * health.py      — device probes, failover, the robust batch encode
  * scaling_check.py — the scaling-floor canary (a copy)

Single controller, as JAX's ``shard_map``: one process drives every
device of a mesh, and a device may repeat (four shards on one card).
After ``initialize()`` with two or more processes, ``make_mesh`` spans
the ranks of the process group instead, and the sharded functions run
SPMD across the processes, each returning the replicated outputs.
"""

from .mesh import (
    Mesh,
    Sharding,
    ShardedTensor,
    batch_sharding,
    gather,
    image_sharding,
    make_mesh,
    place,
)
from .spatial import (
    sharded_dwt2_level1,
    sharded_plane_stats,
    sharded_wavedec2_packed,
)
from .consistency import (
    assert_replicated,
    checked_call,
    replication_discrepancy,
)
from .codec import encode_image_sharded
from .distributed import (
    encode_manifest,
    host_batch_slice,
    initialize,
    load_manifest,
    merge_manifests,
)
from .health import (
    DeviceHealth,
    healthy_devices,
    probe_devices,
    robust_encode_images,
    run_with_failover,
)

__all__ = [
    "sharded_plane_stats",
    "assert_replicated",
    "checked_call",
    "replication_discrepancy",
    "make_mesh",
    "batch_sharding",
    "image_sharding",
    "place",
    "gather",
    "Mesh",
    "Sharding",
    "ShardedTensor",
    "sharded_dwt2_level1",
    "sharded_wavedec2_packed",
    "encode_image_sharded",
    "initialize",
    "host_batch_slice",
    "encode_manifest",
    "load_manifest",
    "merge_manifests",
    "DeviceHealth",
    "probe_devices",
    "healthy_devices",
    "run_with_failover",
    "robust_encode_images",
]
