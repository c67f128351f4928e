"""The port's multi-process glue (spiht_tpu_torch.parallel.distributed)
against the JAX package's: single-process init, host batch slices,
manifests (which both packages read from each other), and a real
two-process gloo group on the CPU whose per-process streams equal the JAX
package's. The two-process worker is this file's ``__main__``."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spiht_tpu_torch import SpihtSettings
from spiht_tpu_torch.parallel import (
    encode_manifest,
    host_batch_slice,
    initialize,
    load_manifest,
    merge_manifests,
)

ROOT = Path(__file__).resolve().parent.parent


def _images(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(shape) for _ in range(n)]


def test_initialize_single_process_noop():
    import torch.distributed as dist

    initialize()  # must be a no-op without a coordinator
    initialize(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize(None, 2, 0)
    assert not dist.is_initialized()


def test_host_batch_slice_partition():
    got = [host_batch_slice(10, pi, 3) for pi in range(3)]
    covered = []
    for s in got:
        covered.extend(range(10)[s])
    assert covered == list(range(10))
    assert host_batch_slice(7) == slice(0, 7)  # no group: one process


def test_manifest_roundtrip():
    from spiht_tpu_torch.codec import api

    settings = SpihtSettings()
    images = _images(3, (1, 24, 24), 1)
    ers = api.encode_images(images, settings, level=1, max_bits=500,
                            device="cpu")
    back = load_manifest(encode_manifest(["a", "b", "c"], ers))
    assert set(back) == {"a", "b", "c"}
    for k, er in zip(["a", "b", "c"], ers):
        assert back[k].to_dict() == er.to_dict()
        np.testing.assert_array_equal(
            api.decode_image(back[k], settings, device="cpu"),
            api.decode_image(er, settings, device="cpu"),
        )
    merged = merge_manifests([encode_manifest(["x"], ers[:1]),
                              encode_manifest(["y"], ers[1:2])])
    assert set(merged) == {"x", "y"}


def test_manifests_cross_load(monkeypatch):
    """A manifest written by either package loads in the other and decodes
    there as the original does (numpy transform on both sides: exact)."""
    import spiht_tpu
    from spiht_tpu import transform as jtr
    from spiht_tpu.parallel import distributed as jdist

    from spiht_tpu_torch import transform as ttr
    from spiht_tpu_torch.codec import api

    monkeypatch.setattr(jtr, "_BACKEND", "numpy")
    monkeypatch.setattr(ttr, "_BACKEND", "numpy")
    images = _images(2, (3, 24, 32), 2)
    js = spiht_tpu.SpihtSettings(color_model="ipt")
    ts = SpihtSettings(color_model="ipt")
    j_ers = spiht_tpu.encode_images(images, js, level=2, max_bits=1500)
    t_ers = api.encode_images(images, ts, level=2, max_bits=1500,
                              device="cpu")
    assert [e.encoded_bytes for e in j_ers] == [e.encoded_bytes for e in t_ers]
    j_text = jdist.encode_manifest([0, 1], j_ers)
    t_text = encode_manifest([0, 1], t_ers)
    assert j_text == t_text  # the same JSON
    in_port = load_manifest(j_text)
    in_jax = jdist.load_manifest(t_text)
    for i in range(2):
        np.testing.assert_array_equal(
            api.decode_image(in_port[i], ts, device="cpu"),
            api.decode_image(t_ers[i], ts, device="cpu"))
        np.testing.assert_array_equal(
            spiht_tpu.decode_image(in_jax[i], js),
            spiht_tpu.decode_image(j_ers[i], js))


def test_two_process_distributed(tmp_path, monkeypatch):
    """Two processes in one gloo group (a free local port): barrier, an
    all-reduce across them, their slices of a global batch, a manifest
    each; the merged streams equal the JAX package's."""
    import spiht_tpu
    from spiht_tpu import transform as jtr

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, f"127.0.0.1:{port}", "2", str(pid),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"

    ok0 = json.loads((tmp_path / "ok_0").read_text())
    ok1 = json.loads((tmp_path / "ok_1").read_text())
    assert ok0["world"] == ok1["world"] == 2
    assert ok0["sum"] == ok1["sum"] == 3.0  # ranks 0 and 1, each + 1
    assert (ok0["slice"], ok1["slice"]) == ([0, 3], [3, 5])

    merged = merge_manifests(
        [(tmp_path / f"manifest_{pid}.json").read_text() for pid in range(2)]
    )
    assert set(merged) == set(range(5))
    monkeypatch.setattr(jtr, "_BACKEND", "numpy")
    images = _images(5, (1, 16, 16), 7)
    for i in range(5):
        er = spiht_tpu.encode_image(images[i], spiht_tpu.SpihtSettings(), 1,
                                    400)
        assert merged[i].encoded_bytes == er.encoded_bytes, i
        assert merged[i].max_n == er.max_n, i


def _worker(coord: str, nprocs: int, pid: int, outdir: str) -> None:
    """One process of test_two_process_distributed."""
    import torch.distributed as dist

    from spiht_tpu_torch import transform
    from spiht_tpu_torch.codec import api

    initialize(coordinator_address=coord, num_processes=nprocs,
               process_id=pid)
    try:
        assert dist.get_world_size() == nprocs and dist.get_rank() == pid
        x = torch.tensor([float(pid) + 1.0])
        dist.all_reduce(x)  # every process sees both contributions

        transform._BACKEND = "numpy"
        sl = host_batch_slice(5)
        images = _images(5, (1, 16, 16), 7)  # same seed: a shared dataset
        ids = list(range(5))[sl]
        ers = [api.encode_image(images[i], SpihtSettings(), 1, 400,
                                device="cpu") for i in ids]
        with open(f"{outdir}/manifest_{pid}.json", "w") as f:
            f.write(encode_manifest(ids, ers))
        with open(f"{outdir}/ok_{pid}", "w") as f:
            json.dump({"world": dist.get_world_size(), "sum": float(x[0]),
                       "slice": [sl.start, sl.stop]}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
