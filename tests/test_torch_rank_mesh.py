"""The port's parallel layer on a mesh over the ranks of a process group.

Four processes in one gloo group on the CPU (this file's ``__main__``,
started once for the module; they import torch and the port only) build
``make_mesh`` over the ranks and run every case below; each rank writes
what it got. The parent holds every rank's outputs against the JAX
package's sharded programs on four of the test host's virtual devices
(``spiht_tpu.parallel``, compiled with XLA's backend optimizations off,
as tests/test_torch_parallel.py does: the op-by-op arithmetic, which the
port equals in f64 bit for bit) and against the port's one-process mesh.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
# chip_smoke.SHARD_SMALL's geometries (shape, wavelet, mode, level): every
# level sharded, tail fixups, the periodization gather fallback
PACKED = [
    ((3, 48, 96), "bior2.2", "reflect", 3),
    ((1, 16, 7900), "bior2.2", "reflect", 5),
    ((2, 12, 3001), "bior6.8", "symmetric", 4),
    ((2, 20, 77), "db3", "periodization", 2),
]
LEVEL1 = (3, 40, 64)
STATS = (3, 40, 64)
BATCH = (2, 3, 32, 64)  # image_sharding over a (2, 2) mesh
ENCODE = (3, 48, 96)  # configuration A's settings, 1.0 bpp
A_KW = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
            quantization_scale=1.0)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _ints(shape, seed):
    return (_x(shape, seed) * 5000).astype(np.int32)


def _image(shape, seed):
    return np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------


def _rank_cases(pid: int) -> dict:
    """Every case on this rank; the outputs by name."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch import parallel as tpar
    from spiht_tpu_torch.parallel.mesh import Sharding

    out = {}
    # (f) a mesh whose size is not the world's raises before any collective,
    # and without a card the default device raises as on one process
    for shape in ((1, 3), (3, 2), (1, 8)):
        try:
            tpar.make_mesh(shape, devices=["cpu"])
        except ValueError as e:
            out[f"mismatch_{shape[0]}x{shape[1]}"] = str(e)
    try:
        tpar.make_mesh((1, WORLD))
    except RuntimeError as e:
        out["no_card"] = str(e)
    try:  # a rank names its own device only
        tpar.make_mesh((1, WORLD), devices=["cpu"] * WORLD)
    except ValueError as e:
        out["devices"] = str(e)

    mesh = tpar.make_mesh((1, WORLD), devices=["cpu"])
    out["mesh"] = [mesh.rank, list(mesh.position), mesh.shape["tile"],
                   [str(d) for d in mesh.devices[0]]]
    tile = Sharding(mesh, (None, None, "tile"))
    # (a) the packed multilevel DWT, and from placed blocks where W divides
    for k, (shape, wav, mode, level) in enumerate(PACKED):
        x = torch.as_tensor(_x(shape, shape[-1]))
        arr, llh, llw = tpar.sharded_wavedec2_packed(x, wav, mode, level, mesh)
        out[f"packed_{k}"] = arr.numpy()
        out[f"packed_{k}_ll"] = np.array([llh, llw])
        if shape[-1] % WORLD == 0:
            xs = tpar.place(x, tile)
            out[f"packed_{k}_placed"] = tpar.sharded_wavedec2_packed(
                xs, wav, mode, level, mesh)[0].numpy()
    # (b) one level
    d = tpar.sharded_dwt2_level1(torch.as_tensor(_x(LEVEL1, 1)), "bior2.2",
                                 "reflect", mesh)
    for k, v in d.items():
        out[f"level1_{k}"] = v.numpy()
    # (c) plane statistics, of a tensor and of placed blocks
    arr = torch.as_tensor(_ints(STATS, 5))
    for tag, a in (("tensor", arr), ("placed", tpar.place(arr, tile))):
        gmax, counts = tpar.sharded_plane_stats(a, mesh)
        out[f"stats_{tag}"] = np.concatenate([[int(gmax)], counts.numpy()])
        out[f"stats_{tag}_dtype"] = str(counts.dtype)
    # replication over the ranks: 0 for the replicated output, > 0 where one
    # rank's copy is off by an ulp
    out["disc"] = float(tpar.replication_discrepancy(d["dd"], mesh, "tile"))
    off = d["dd"].clone()
    if pid == 2:
        off.view(-1)[7] = torch.nextafter(off.view(-1)[7], off.new_tensor(9.0))
    out["disc_off"] = float(tpar.replication_discrepancy(off, mesh, "tile"))
    # (d) the sharded encode (B1's plain version on each rank)
    er = tpar.encode_image_sharded(
        _image(ENCODE, 4), SpihtSettings(**A_KW), mesh, level=None,
        max_bits=ENCODE[1] * ENCODE[2])
    out["encode"] = np.frombuffer(er.encoded_bytes, np.uint8)
    out["encode_meta"] = np.array([er.max_n, er.h, er.w, er.c])

    # (e) a (2, 2) mesh with the batch split over its rows
    mesh22 = tpar.make_mesh((2, 2), devices=["cpu"])
    out["mesh22"] = list(mesh22.position)
    xb = torch.as_tensor(_x(BATCH, 3))
    sh = tpar.image_sharding(mesh22)
    xs = tpar.place(xb, sh)
    out["batch_block"] = np.array(
        [[b is not None for b in row] for row in xs.blocks])
    out["batch_gather"] = tpar.gather(xs).numpy()
    out["batch_packed"] = tpar.sharded_wavedec2_packed(
        xs, "bior2.2", "reflect", 2, mesh22)[0].numpy()
    out["batch_packed_tensor"] = tpar.sharded_wavedec2_packed(
        xb, "bior2.2", "reflect", 2, mesh22)[0].numpy()
    ab = torch.as_tensor(np.stack([_ints(STATS, 5), _ints(STATS, 6)]))
    gmax, counts = tpar.sharded_plane_stats(tpar.place(ab, sh), mesh22)
    out["batch_stats"] = np.concatenate([[int(gmax)], counts.numpy()])
    return out


def _rank_main(coord: str, pid: int, outdir: str) -> None:
    import torch.distributed as dist

    from spiht_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    # a rank that waits this long on the others fails instead of hanging
    distributed.TIMEOUT = datetime.timedelta(seconds=60)
    distributed.initialize(coord, WORLD, pid)
    try:
        out = _rank_cases(pid)
        strs = {k: v for k, v in out.items() if not isinstance(v, np.ndarray)}
        np.savez(f"{outdir}/rank{pid}.npz",
                 **{k: v for k, v in out.items() if k not in strs})
        with open(f"{outdir}/rank{pid}.json", "w") as f:
            json.dump(strs, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once; every rank's outputs, by rank."""
    out = tmp_path_factory.mktemp("ranks")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, __file__, f"127.0.0.1:{port}", str(pid), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(WORLD)]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so}\n{se}"
    got = []
    for pid in range(WORLD):
        with np.load(out / f"rank{pid}.npz") as z:
            r = {k: z[k] for k in z.files}
        r.update(json.loads((out / f"rank{pid}.json").read_text()))
        got.append(r)
    return got


def _jax_mesh(dp, sp):
    import jax

    from spiht_tpu.parallel import make_mesh

    return make_mesh((dp, sp), devices=jax.devices()[:dp * sp])


def _jax(fn, x, **kw):
    """``fn(x, **kw)`` of the JAX package compiled with XLA's backend
    optimizations off (tests/test_torch_parallel.py's ``_jax``)."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    return jax.jit(partial(fn, **kw)).lower(x).compile(
        compiler_options={"xla_backend_optimization_level": 0})(x)


def _one_process(dp, sp):
    from spiht_tpu_torch import parallel as tpar

    return tpar.make_mesh((dp, sp), devices=["cpu"] * (dp * sp))


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("k", range(len(PACKED)),
                         ids=["x".join(map(str, c[0])) for c in PACKED])
def test_rank_mesh_packed_exact(ranks, k):
    from spiht_tpu.parallel import spatial as jsp

    from spiht_tpu_torch import parallel as tpar

    shape, wav, mode, level = PACKED[k]
    x = _x(shape, shape[-1])
    want, llh, llw = _jax(jsp.sharded_wavedec2_packed, x, wavelet=wav,
                          mode=mode, level=level, mesh=_jax_mesh(1, WORLD))
    one, _, _ = tpar.sharded_wavedec2_packed(
        torch.as_tensor(x), wav, mode, level, _one_process(1, WORLD))
    got = _same_on_every_rank(ranks, f"packed_{k}")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, one.numpy())
    assert ranks[0][f"packed_{k}_ll"].tolist() == [int(llh), int(llw)]
    if shape[-1] % WORLD == 0:
        np.testing.assert_array_equal(
            _same_on_every_rank(ranks, f"packed_{k}_placed"), got)


def test_rank_mesh_level1_exact(ranks):
    from spiht_tpu.parallel import spatial as jsp

    want = _jax(jsp.sharded_dwt2_level1, _x(LEVEL1, 1), wavelet="bior2.2",
                mode="reflect", mesh=_jax_mesh(1, WORLD))
    for k in ("aa", "ad", "da", "dd"):
        np.testing.assert_array_equal(
            _same_on_every_rank(ranks, f"level1_{k}"), np.asarray(want[k]))


def test_rank_mesh_plane_stats(ranks):
    from spiht_tpu.parallel import sharded_plane_stats

    gmax, counts = sharded_plane_stats(_ints(STATS, 5), _jax_mesh(1, WORLD))
    want = [int(gmax)] + np.asarray(counts).tolist()
    for tag in ("tensor", "placed"):
        assert _same_on_every_rank(ranks, f"stats_{tag}").tolist() == want
        assert all(r[f"stats_{tag}_dtype"] == "torch.int32" for r in ranks)


def test_rank_mesh_replication(ranks):
    """replication_discrepancy over the ranks: 0 for the replicated level-1
    output, > 0 on every rank where rank 2's copy is one ulp off."""
    assert all(r["disc"] == 0.0 for r in ranks)
    assert all(r["disc_off"] > 0.0 for r in ranks)
    assert len({r["disc_off"] for r in ranks}) == 1


def test_rank_mesh_encode_image_sharded(ranks, monkeypatch):
    import spiht_tpu
    from spiht_tpu import parallel as jpar
    from spiht_tpu import transform as jtr

    im = _image(ENCODE, 4)
    mb = ENCODE[1] * ENCODE[2]
    settings = spiht_tpu.SpihtSettings(**A_KW)
    sharded = jpar.encode_image_sharded(im, settings, _jax_mesh(1, WORLD),
                                        level=None, max_bits=mb)
    monkeypatch.setattr(jtr, "_BACKEND", "jax")
    single = spiht_tpu.encode_image(im, settings, level=None, max_bits=mb)
    assert sharded.encoded_bytes == single.encoded_bytes
    for r in ranks:
        assert r["encode"].tobytes() == sharded.encoded_bytes
        assert r["encode_meta"].tolist() == [sharded.max_n, *ENCODE[1:],
                                             ENCODE[0]]


def test_rank_mesh_batch_2x2(ranks):
    """A (2, 2) mesh over the four ranks: ``place`` keeps each rank's
    block, ``gather`` returns the whole batch on every rank, and each row
    of ranks transforms its image (the join an all-gather over the batch
    axis), equal to JAX's program on a (2, 2) mesh and to the port's
    one-process mesh; a tensor input runs on both rows; plane statistics
    reduce over both axes."""
    from spiht_tpu.parallel import sharded_plane_stats
    from spiht_tpu.parallel import spatial as jsp

    from spiht_tpu_torch import parallel as tpar

    x = _x(BATCH, 3)
    assert [r["mesh22"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for pid, r in enumerate(ranks):
        want = np.zeros((2, 2), bool)
        want[divmod(pid, 2)] = True
        np.testing.assert_array_equal(r["batch_block"], want)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "batch_gather"),
                                  x)
    want, _, _ = _jax(jsp.sharded_wavedec2_packed, x, wavelet="bior2.2",
                      mode="reflect", level=2, mesh=_jax_mesh(2, 2))
    mesh = _one_process(2, 2)
    one = tpar.sharded_wavedec2_packed(
        tpar.place(torch.as_tensor(x), tpar.image_sharding(mesh)),
        "bior2.2", "reflect", 2, mesh)[0]
    for key in ("batch_packed", "batch_packed_tensor"):
        got = _same_on_every_rank(ranks, key)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, one.numpy())
    ab = np.stack([_ints(STATS, 5), _ints(STATS, 6)])
    gmax, counts = sharded_plane_stats(ab, _jax_mesh(2, 2))
    assert _same_on_every_rank(ranks, "batch_stats").tolist() == (
        [int(gmax)] + np.asarray(counts).tolist())


def test_rank_mesh_layout_and_refusals(ranks):
    """Mesh position k is rank k; a mesh whose size is not the world size,
    or a list of several devices, raises ValueError on every rank, and
    with no card and no devices= the default device raises."""
    for pid, r in enumerate(ranks):
        assert r["mesh"] == [pid, [0, pid], WORLD, ["cpu"] * WORLD]
        for shape in ("1x3", "3x2", "1x8"):
            assert "the process group has 4 ranks" in r[f"mismatch_{shape}"]
        assert "this rank's device only" in r["devices"]
        if not torch.cuda.is_available():
            assert "no CUDA device" in r["no_card"]


def test_group_of_one_keeps_the_single_controller_mesh():
    """A group of one process leaves make_mesh as it is without a group."""
    import torch.distributed as dist

    from spiht_tpu_torch import parallel as tpar

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tpar.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = tpar.make_mesh((1, 4), devices=["cpu"] * 4)
        assert mesh == _one_process(1, 4) and mesh.rank is None
        x = _x((3, 48, 96), 96)
        got = tpar.sharded_wavedec2_packed(torch.as_tensor(x), "bior2.2",
                                           "reflect", 3, mesh)[0]
        want = tpar.sharded_wavedec2_packed(torch.as_tensor(x), "bior2.2",
                                            "reflect", 3,
                                            _one_process(1, 4))[0]
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
