"""Multi-process scaling glue, the port of
``spiht_tpu/parallel/distributed.py``.

 * `initialize()` — ``torch.distributed.init_process_group`` at
   ``tcp://{coordinator_address}`` with a startup barrier, so every
   process has joined before any work starts: NCCL when this process has a
   CUDA card, gloo on the CPU. A process that drives one card of several
   picks it with ``torch.cuda.set_device`` first.
 * `host_batch_slice()` — which members of a global batch this process
   feeds.
 * `encode_manifest()` / `merge_manifests()` — per-batch checkpoint
   records (image id -> EncodingResult dict) so a long encoding job can
   resume after a host failure; the stream format itself is embedded /
   prefix-decodable, so partially-written streams remain usable. The
   three manifest functions are copies of the JAX package's
   (tests/test_torch_copies.py): the two packages read each other's
   manifests.

After `initialize()` with two or more processes, ``parallel.make_mesh``
spans the ranks of the group (mesh position k is rank k's device), and
the sharded DWT, plane statistics and ``encode_image_sharded`` run SPMD
across the processes, each returning the replicated outputs, as
``spiht_tpu.parallel`` does after ``jax.distributed.initialize``. Every
process calls the same functions with the same arguments. A collective
that waits past `TIMEOUT` (a rank that died, or one that issues other
collectives) raises instead of hanging the others.
"""

from __future__ import annotations

import datetime
import json
from typing import Dict, Iterable, Optional, Sequence

import torch

from ..settings import EncodingResult

__all__ = [
    "initialize",
    "host_batch_slice",
    "encode_manifest",
    "merge_manifests",
    "load_manifest",
]

# how long a collective of the group waits for the other ranks
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the process group and barrier until all processes join.

    No-op for single-process runs (num_processes in (None, 0, 1) and no
    coordinator configured). ``coordinator_address`` is ``host:port`` of
    rank 0; ``num_processes`` and ``process_id`` are the world size and
    this process's rank. Several processes need the coordinator's address:
    unlike JAX, nothing here reads it from a cluster's environment. The
    group's collectives time out after `TIMEOUT`.
    """
    import torch.distributed as dist

    if not coordinator_address:
        if (num_processes or 1) <= 1:
            return
        raise ValueError(
            f"{num_processes} processes need a coordinator_address "
            f"(host:port of rank 0)")
    cuda = torch.cuda.is_available()
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        timeout=TIMEOUT,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    # barrier: one all-reduce on this process's device
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    x = torch.zeros(1, dtype=torch.float32, device=dev)
    dist.all_reduce(x)
    if cuda:
        torch.cuda.synchronize(dev)


def host_batch_slice(global_batch: int, process_index=None, process_count=None) -> slice:
    """The contiguous slice of a global batch owned by this process (the
    rank and world size of the initialized group; 0 and 1 without one)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    per = -(-global_batch // pc)  # ceil
    start = min(pi * per, global_batch)
    stop = min(start + per, global_batch)
    return slice(start, stop)


def encode_manifest(ids: Sequence, results: Sequence[EncodingResult]) -> str:
    """Serialize a batch of encodings as a JSON manifest (checkpoint unit).

    Bytes are hex-encoded; the dict layout reuses EncodingResult's
    reference-compatible `encoding_result_` key prefix.
    """
    records = []
    for i, er in zip(ids, results):
        d = er.to_dict()
        d["encoding_result_encoded_bytes"] = d[
            "encoding_result_encoded_bytes"
        ].hex()
        records.append({"id": i, **d})
    return json.dumps(records)


def load_manifest(text: str) -> Dict[object, EncodingResult]:
    out: Dict[object, EncodingResult] = {}
    for rec in json.loads(text):
        rid = rec.pop("id")
        rec["encoding_result_encoded_bytes"] = bytes.fromhex(
            rec["encoding_result_encoded_bytes"]
        )
        out[rid] = EncodingResult.from_dict(rec)
    return out


def merge_manifests(texts: Iterable[str]) -> Dict[object, EncodingResult]:
    """Union of per-host manifests; later entries win on id collision."""
    out: Dict[object, EncodingResult] = {}
    for t in texts:
        out.update(load_manifest(t))
    return out
