"""The port's parallel layer (spiht_tpu_torch.parallel) against the JAX
package, on meshes of CPU devices: the sharded DWT equals the JAX
package's unsharded ``dwt.dwt2`` / ``dwt.wavedec2_packed`` exactly (f64)
on every geometry of tests/test_parallel.py and more; the static helpers
equal the JAX ones; plane statistics equal numpy's; the sharded encode
equals ``spiht_tpu.encode_image`` byte for byte; the consistency tools
report what the JAX ones report."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiht_tpu
from spiht_tpu import parallel as jpar
from spiht_tpu import transform as jtr
from spiht_tpu.parallel import consistency as jcons
from spiht_tpu.parallel import spatial as jsp
from spiht_tpu.wavelets import dwt as jdwt
from spiht_tpu.wavelets.filters import build_wavelet, dwt_coeff_len

import spiht_tpu_torch as pt
from spiht_tpu_torch import parallel as tpar
from spiht_tpu_torch.parallel import spatial as tsp
from spiht_tpu_torch.parallel.consistency import checked_call
from spiht_tpu_torch.parallel.mesh import Sharding

torch.set_num_threads(1)


def _mesh(dp, sp):
    return tpar.make_mesh((dp, sp), devices=[torch.device("cpu")] * 8)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _jax(fn, x, **kw):
    """``fn(x, **kw)`` of the JAX package as one program compiled with
    XLA's backend optimizations off: at the default level XLA fuses
    multiply-adds, which moves the last bit; at 0 it gives the op-by-op
    arithmetic exactly (which the port equals), ~4x faster than op by
    op."""
    x = jnp.asarray(x)
    return jax.jit(partial(fn, **kw)).lower(x).compile(
        compiler_options={"xla_backend_optimization_level": 0})(x)


@pytest.mark.parametrize("wavelet,mode,sp,w", [
    ("bior2.2", "reflect", 2, 64), ("bior6.8", "symmetric", 8, 160),
])
def test_sharded_level1_exact(wavelet, mode, sp, w):
    x = _x((3, 40, w), sp)
    ref = _jax(jdwt.dwt2, x, wavelet=wavelet, mode=mode)
    out = tpar.sharded_dwt2_level1(torch.as_tensor(x), wavelet, mode,
                                   _mesh(1, sp))
    for k in ("aa", "ad", "da", "dd"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


# (shape, wavelet, mode, level, (dp, sp), levels run sharded)
PACKED = [
    ((3, 48, 96), "bior2.2", "reflect", 3, (1, 4), 2),
    ((2, 3, 32, 64), "bior2.2", "reflect", 2, (2, 4), 1),  # placed input
    ((2, 1, 16, 60), "bior2.2", "reflect", 2, (2, 4), 1),  # placed, W/n odd
    ((1, 32, 1024), "bior2.2", "reflect", 4, (1, 8), 3),
    ((1, 16, 7900), "bior2.2", "reflect", 5, (1, 8), 5),  # every level
    ((2, 12, 3001), "bior6.8", "symmetric", 4, (1, 8), 4),  # tail fixups
    ((2, 20, 77), "db3", "periodization", 2, (1, 4), 0),  # residue only
]


@pytest.mark.parametrize("case", PACKED, ids=lambda c: "x".join(map(str, c[0])))
def test_sharded_wavedec2_packed_exact(case):
    shape, wavelet, mode, level, (dp, sp), n_sharded = case
    x = _x(shape, shape[-1])
    ref, llh, llw = _jax(jdwt.wavedec2_packed, x, wavelet=wavelet, mode=mode,
                         level=level)
    mesh = _mesh(dp, sp)
    xt = torch.as_tensor(x)
    if dp > 1:  # already sharded, as test_sharded_batched_leading_dims
        xt = tpar.place(xt, tpar.image_sharding(mesh))
    out, llh2, llw2 = tpar.sharded_wavedec2_packed(xt, wavelet, mode, level,
                                                   mesh)
    assert (int(llh), int(llw)) == (llh2, llw2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    plan = tsp.levels_plan(shape[-1], sp, build_wavelet(wavelet).dec_len,
                           mode, level)
    assert len(plan) == n_sharded
    if wavelet == "bior6.8":
        assert any(r and r[2] for _, _, r in plan)  # _reshard patched tails


def test_sharded_rejects_bad_widths():
    mesh = _mesh(1, 4)
    for w, wavelet in ((36, "bior2.2"), (30, "bior2.2"), (32, "bior6.8")):
        x = torch.as_tensor(_x((1, 16, w), w))
        with pytest.raises(ValueError):
            tpar.sharded_dwt2_level1(x, wavelet, "symmetric", mesh)


def _jax_plan(n, Ol, eo, W, S):
    """The JAX package's reshard plan, None where its frame is shorter than
    a block: there its dynamic_slice raises (test_one_shard_falls_back)."""
    plan = jsp._reshard_plan(n, Ol, eo, W, S)
    if plan is not None and (plan[0] + plan[1] + 1) * Ol < S:
        return None
    return plan


def _jax_levels(W, n, F, mode, level):
    """The JAX loop's static decisions (sharded_wavedec2_packed :367-398)."""
    out, Wl, prev = [], W, None
    while len(out) < level and jsp._level_shardable(Wl, n, F, mode):
        S = jsp._even_ceil(Wl, n)
        plan = None
        if prev is not None:
            plan = _jax_plan(n, *prev, Wl, S)
            if plan is None:
                break
        out.append((Wl, S, plan))
        Wp = dwt_coeff_len(Wl, F, mode)
        Ol = S // 2
        prev = (Ol, max(0, Wp - (n - 1) * Ol - Ol))
        Wl = Wp
    return out


def test_static_helpers_equal_jax():
    for W in (7, 30, 64, 97, 301, 1024, 3001, 7681, 7900):
        for n in (1, 2, 3, 4, 8):
            assert tsp._even_ceil(W, n) == jsp._even_ceil(W, n)
            for F in (2, 6, 10, 18):
                for mode in ("reflect", "symmetric", "periodization"):
                    assert tsp._level_shardable(W, n, F, mode) == (
                        jsp._level_shardable(W, n, F, mode))
                    assert tsp.levels_plan(W, n, F, mode, 6) == _jax_levels(
                        W, n, F, mode, 6)
                S = tsp._even_ceil(W, n)
                for Ol in (4, 9, 40):
                    for eo in (0, 1, 3):
                        assert tsp._reshard_plan(n, Ol, eo, W, S) == (
                            _jax_plan(n, Ol, eo, W, S))


def test_one_shard_falls_back():
    """On a one-shard axis the JAX package's plan for level 2 keeps a frame
    shorter than the next block, so its dynamic_slice raises at trace time
    (a TypeError; not run here: a shard_map program compiles for ~30 s);
    the port runs level 1 sharded and the rest after the gather, equal to
    the unsharded transform."""
    Wp = dwt_coeff_len(160, 6, "reflect")
    KL, KR, _ = jsp._reshard_plan(1, 80, Wp - 80, Wp, jsp._even_ceil(Wp, 1))
    assert (KL + KR + 1) * 80 < jsp._even_ceil(Wp, 1)
    x = _x((3, 24, 160), 3)
    ref, _, _ = _jax(jdwt.wavedec2_packed, x, wavelet="bior2.2",
                     mode="reflect", level=3)
    out, _, _ = tpar.sharded_wavedec2_packed(torch.as_tensor(x), "bior2.2",
                                             "reflect", 3, _mesh(1, 1))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert len(tsp.levels_plan(160, 1, 6, "reflect", 3)) == 1


def test_collectives():
    blocks = [torch.full((2, 3), float(s)) for s in range(4)]
    got = tsp.ppermute(blocks, [(0, 1), (1, 2)])
    want = [0.0, 0.0, 1.0, 0.0]  # unsent shards receive zeros
    assert [float(b[0, 0]) for b in got] == want
    assert all(g.data_ptr() != b.data_ptr() for g, b in zip(got, blocks))
    assert int(tsp.psum([torch.tensor(2**30, dtype=torch.int32)] * 2,
                        "cpu")) == -2**31  # int32 wraps, as lax.psum
    assert float(tsp.pmax(blocks, "cpu")[0, 0]) == 3.0


@pytest.mark.parametrize("placed", ["tensor", "tile", "batch_and_tile"])
def test_sharded_plane_stats(placed):
    mesh = _mesh(2 if placed == "batch_and_tile" else 1, 4)
    shape = (2, 3, 40, 64) if placed == "batch_and_tile" else (3, 40, 64)
    arr = torch.as_tensor((_x(shape, 5) * 5000).astype(np.int32))
    if placed == "tile":
        arr = tpar.place(arr, Sharding(mesh, (None, None, "tile")))
    elif placed == "batch_and_tile":  # each row of shards tallies its half
        arr = tpar.place(arr, tpar.image_sharding(mesh))
    gmax, counts = tpar.sharded_plane_stats(arr, mesh)
    mag = np.abs((_x(shape, 5) * 5000).astype(np.int32))
    assert int(gmax) == mag.max()
    want = [(mag >= (1 << p)).sum() for p in range(32)]
    np.testing.assert_array_equal(counts.numpy(), want)
    assert counts.dtype == torch.int32
    with pytest.raises(ValueError):
        tpar.sharded_plane_stats(torch.zeros((1, 4, 62), dtype=torch.int32),
                                 mesh)


def test_sharded_input_placed_otherwise_raises():
    """Only a last dimension split over the tile axis (and at most the
    first over the batch axis) is taken where it lies."""
    mesh = _mesh(2, 4)
    x = torch.as_tensor(_x((4, 16, 64), 1))
    for spec in ((None, "tile", None), ("tile", None, None),
                 (None, "batch", "tile")):
        xs = tpar.place(x, Sharding(mesh, spec))
        with pytest.raises(ValueError, match="sharded input"):
            tpar.sharded_wavedec2_packed(xs, "bior2.2", "reflect", 2, mesh)
    xs = tpar.place(x, Sharding(_mesh(1, 4), (None, None, "tile")))
    with pytest.raises(ValueError, match="sharded input"):  # another mesh
        tpar.sharded_dwt2_level1(xs, "bior2.2", "reflect", mesh)


@pytest.mark.parametrize("case", [
    ((3, 48, 96), dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
                       quantization_scale=1.0), 2, 8000, 4),
    ((1, 24, 301), {}, 2, 4000, 8),
], ids=["ipt_4", "odd_width_8"])
def test_encode_image_sharded_equals_jax(case, monkeypatch):
    shape, kw, level, max_bits, sp = case
    im = np.random.default_rng(sp).random(shape)
    er = tpar.encode_image_sharded(im, pt.SpihtSettings(**kw), _mesh(1, sp),
                                   level=level, max_bits=max_bits)
    monkeypatch.setattr(jtr, "_BACKEND", "jax")
    want = spiht_tpu.encode_image(im, spiht_tpu.SpihtSettings(**kw),
                                  level=level, max_bits=max_bits)
    assert er.encoded_bytes == want.encoded_bytes
    assert er.max_n == want.max_n
    assert (er.h, er.w, er.c, er.level) == (want.h, want.w, want.c, want.level)


def test_mesh_and_shardings():
    mesh = _mesh(2, 4)
    assert mesh.shape == {"batch": 2, "tile": 4}
    assert mesh.axis_names == ("batch", "tile")
    with pytest.raises(ValueError):
        tpar.make_mesh((3, 3), devices=[torch.device("cpu")] * 8)
    assert tpar.make_mesh(devices=["cpu"] * 3).shape == {"batch": 3, "tile": 1}
    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float64).reshape(2, 3, 4, 8)
    for sh in (tpar.batch_sharding(mesh), tpar.image_sharding(mesh)):
        xs = tpar.place(x, sh)
        assert torch.equal(tpar.gather(xs), x)
    xs = tpar.place(x, tpar.image_sharding(mesh))
    assert xs.blocks[1][3].shape == (1, 3, 4, 2)
    assert torch.equal(xs.blocks[1][3], x[1:, :, :, 6:])
    with pytest.raises(ValueError):  # W=6 does not split 4 ways
        tpar.place(torch.zeros(2, 1, 1, 6), tpar.image_sharding(mesh))


def test_no_silent_cpu_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()


def test_all_names_of_the_reference():
    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(hasattr(tpar, n) for n in tpar.__all__)


def test_replication_discrepancy():
    mesh = _mesh(1, 8)
    x = torch.as_tensor(_x((4, 8), 1))
    assert float(tpar.replication_discrepancy(x, mesh, "tile")) == 0.0
    tpar.assert_replicated(x, mesh, "tile")
    d1 = tpar.sharded_dwt2_level1(torch.as_tensor(_x((1, 16, 64), 2)),
                                  "bior2.2", "reflect", mesh)
    tpar.assert_replicated(d1["dd"], mesh, "tile")
    copies = [d1["dd"].clone() for _ in range(8)]
    copies[5].view(-1)[7] = torch.nextafter(
        copies[5].view(-1)[7], torch.tensor(np.inf, dtype=torch.float64))
    assert float(tpar.replication_discrepancy(copies, mesh, "tile")) > 0.0
    with pytest.raises(AssertionError):
        tpar.assert_replicated(copies, mesh, "tile")
    with pytest.raises(ValueError):
        tpar.replication_discrepancy(copies[:3], mesh, "tile")


# (name, jax function, torch function, input): what checkify's
# float_checks reports and what it lets through
CHECKS = [
    ("log_neg", lambda v: jnp.log(v).sum(), lambda v: torch.log(v).sum(),
     [-1.0, 2.0]),
    ("log_zero_is_inf", lambda v: jnp.log(v).sum(),
     lambda v: torch.log(v).sum(), [0.0, 2.0]),
    ("div_zero", lambda v: (1.0 / v).sum(), lambda v: (1.0 / v).sum(),
     [0.0, 2.0]),
    ("zero_div_zero", lambda v: 0.0 / v, lambda v: 0.0 / v, [0.0]),
    ("nan_input_mul", lambda v: (v * 2).sum(), lambda v: (v * 2).sum(),
     [np.nan, 2.0]),
    ("inf_minus_inf", lambda v: (v - v).sum(), lambda v: (v - v).sum(),
     [np.inf, 2.0]),
    ("exp_overflow", lambda v: jnp.exp(v).sum(), lambda v: torch.exp(v).sum(),
     [1000.0, 2.0]),
    ("rem_zero", lambda v: v % 0.0, lambda v: v % 0.0, [1.0]),
    ("identity_nan", lambda v: v, lambda v: v, [np.nan]),
    ("max_nan", lambda v: v.max(), lambda v: v.max(), [np.nan, 1.0]),
    ("where_log", lambda v: jnp.where(v > 0, jnp.log(v), 0.0),
     lambda v: torch.where(v > 0, torch.log(v), 0.0), [-1.0, 1.0]),
    # NaN -> int differs by platform (0 / INT_MIN); "* 0" keeps the check
    ("cast_nan", lambda v: v.astype(jnp.int32) * 0,
     lambda v: v.to(torch.int32) * 0, [np.nan]),
    ("finite_sum", lambda v: v.sum(), lambda v: v.sum(), [1.0, 2.5]),
    # raises inside the op on the CPU: the check reads its flags first
    ("int_div_zero", lambda v: v.astype(jnp.int32) // v.astype(jnp.int32),
     lambda v: v.to(torch.int32) // v.to(torch.int32), [0.0, 2.0]),
]


@pytest.mark.parametrize("name,jfn,tfn,v", CHECKS, ids=[c[0] for c in CHECKS])
def test_checked_call_reports_what_checkify_reports(name, jfn, tfn, v):
    def run(call, fn, x):
        try:
            return False, np.asarray(call(fn, x))
        except Exception as e:  # noqa: BLE001 — which one is compared below
            return True, e

    j_raised, j = run(jcons.checked_call, jfn, jnp.asarray(v))
    t_raised, t = run(checked_call, tfn, torch.tensor(v, dtype=torch.float64))
    assert j_raised == t_raised, (j, t)
    if t_raised:
        assert isinstance(t, FloatingPointError)
    else:
        np.testing.assert_array_equal(t, j)
