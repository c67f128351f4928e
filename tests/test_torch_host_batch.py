"""The port's host-scheduled batch codec against the JAX package:
``encode_images`` streams byte for byte (budget path and compact path),
``decode_images`` images; kernel B6's plain version against the Pallas
kernel in interpret mode; the planner's counts and cut planes; kernel B7
(the sequential encoder) against B1 and the Pallas ``seq`` machine."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spiht_tpu
from spiht_tpu import jax_transform as jjt
from spiht_tpu.codec import api as japi
from spiht_tpu.codec import maps as jmaps
from spiht_tpu.codec import pallas_encoder as jpe
from spiht_tpu.codec import planning as jplan
from spiht_tpu.codec.oracle import compute_max_n
from spiht_tpu.ops.pallas_kernels import quantize_compact_m

import spiht_tpu_torch as pt
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch.codec import api, encoder, planning
from spiht_tpu_torch.codec.maps import significance_maps
from spiht_tpu_torch.native import runtime
from spiht_tpu_torch.ops.quantize_kernels import quantize_compact

torch.set_num_threads(1)

IPT = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
           quantization_scale=1.0)


def _images(seed, second=(3, 48, 40)):
    """Mixed shapes, two groups: 3x36x52 (LL 12x16) and, by default,
    3x48x40, whose LL band is odd (10x9 or 15x13)."""
    rng = np.random.default_rng(seed)
    return ([rng.random((3, 36, 52)) for _ in range(3)]
            + [rng.random(second) for _ in range(2)])


def _route_spy(monkeypatch):
    """Records whether the budget path returned streams."""
    called = []
    real = api._encode_images_budget

    def spy(*a):
        out = real(*a)
        called.append(out is not None)
        return out

    monkeypatch.setattr(api, "_encode_images_budget", spy)
    return called


@pytest.mark.parametrize(
    "kw,level,max_bits,budget_path",
    [
        ({}, 2, None, []),  # no budget: the compact path
        ({}, 2, 700, [False]),  # odd LL in the batch: budget path declines
        (IPT, None, [100, 5000, 2**40, 333, 1], []),  # a budget >= 2^40
    ],
)
def test_encode_images_equals_jax_package(kw, level, max_bits, budget_path,
                                          monkeypatch):
    ims = _images(1)
    called = _route_spy(monkeypatch)
    got = pt.encode_images(ims, pt.SpihtSettings(**kw), level, max_bits,
                           device="cpu")
    want = spiht_tpu.encode_images(ims, spiht_tpu.SpihtSettings(**kw), level,
                                   max_bits)
    assert called == budget_path
    assert [(e.encoded_bytes, e.max_n, e.h, e.w, e.c, e.level) for e in got] \
        == [(e.encoded_bytes, e.max_n, e.h, e.w, e.c, e.level) for e in want]


@pytest.mark.parametrize("kw,max_bits", [({}, [1, 900, 4097, 333, 60]),
                                         (IPT, 3000)])
def test_budget_path_equals_jax_package(kw, max_bits, monkeypatch):
    """Even-LL groups of two shapes: the budget-narrowed path returns the
    streams, each a prefix of the standard path's full stream."""
    ims = _images(2, second=(3, 33, 20))
    called = _route_spy(monkeypatch)
    got = pt.encode_images(ims, pt.SpihtSettings(**kw), None, max_bits,
                           device="cpu")
    want = spiht_tpu.encode_images(ims, spiht_tpu.SpihtSettings(**kw), None,
                                   max_bits)
    assert called == [True]
    assert [(e.encoded_bytes, e.max_n) for e in got] == [
        (e.encoded_bytes, e.max_n) for e in want]
    full = pt.encode_images(ims, pt.SpihtSettings(**kw), None, None,
                            device="cpu")
    mbs = max_bits if isinstance(max_bits, list) else [max_bits] * 5
    for e, f, mb in zip(got, full, mbs):
        assert e.max_n == f.max_n
        assert e.encoded_bytes[: mb // 8] == f.encoded_bytes[: mb // 8]


def test_encode_images_int16_overflow_takes_int32_transform():
    """Coefficients past int16: the int32 transform's streams."""
    settings = pt.SpihtSettings(quantization_scale=50000.0)
    ims = [np.random.default_rng(3).random((1, 32, 32))]
    arr16, overflow, _, _ = tt.forward_compact(torch.as_tensor(ims[0]),
                                               settings, 2)
    assert bool(overflow)
    got = pt.encode_images(ims, settings, 2, None, device="cpu")
    want = spiht_tpu.encode_images(
        ims, spiht_tpu.SpihtSettings(quantization_scale=50000.0), 2)
    assert got[0].encoded_bytes == want[0].encoded_bytes


def test_decode_images_equals_jax_and_device_decode():
    ims = _images(4)
    ers = spiht_tpu.encode_images(ims, spiht_tpu.SpihtSettings(**IPT), None,
                                  4000)
    ters = [pt.EncodingResult(**vars(e)) for e in ers]
    got = pt.decode_images(ters, pt.SpihtSettings(**IPT), device="cpu")
    want = spiht_tpu.decode_images(ers, spiht_tpu.SpihtSettings(**IPT))
    for g, w_ in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w_.shape
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-12)
    dev = pt.decode_images_device(ters[:3], pt.SpihtSettings(**IPT),
                                  device="cpu")
    for g, d in zip(got[:3], dev):
        np.testing.assert_array_equal(g, d.numpy())


@pytest.mark.parametrize("spread,scale,over", [(100.0, 50.0, False),
                                               (900.0, 50.0, True),
                                               (3.0, 1.0, False)])
def test_quantize_plain_equals_pallas_kernel(spread, scale, over):
    """All four outputs, and the overflow flag set and clear."""
    x = (np.random.default_rng(int(spread)).standard_normal((3, 70, 130))
         * spread).astype(np.float32)
    x[0, 0, :4] = [0.0, -0.5 / scale, 1.0 / scale, -1.0 / scale]
    want = quantize_compact_m(jnp.asarray(x), scale, interpret=True)
    got = quantize_compact(torch.as_tensor(x), scale)
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert bool(got[3]) == bool(want[3]) == over


def test_forward_compact_equals_jax():
    """The float64 route's int16 coefficients and overflow flag equal
    _forward_compact_jit's (its XLA route on the CPU)."""
    im = np.random.default_rng(5).random((2, 3, 36, 52))
    for kw in ({}, IPT):
        fn = jjt._forward_compact_jit(
            jjt._settings_key(spiht_tpu.SpihtSettings(**kw)), None, "float64")
        w16, wofl = fn(jnp.asarray(im))
        g16, gofl, _, _ = tt.forward_compact(torch.as_tensor(im),
                                             pt.SpihtSettings(**kw))
        np.testing.assert_array_equal(g16.numpy(), np.asarray(w16))
        assert bool(gofl) == bool(wofl)


def _maps(seed, shape, ll):
    arr = (np.random.default_rng(seed).standard_normal(shape) * 700).astype(
        np.int32)
    arr[0, 1, 1] = 0
    return arr, significance_maps(torch.as_tensor(arr), *ll)


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((2, 44, 60), (12, 16))])
def test_planner_equals_jax(shape, ll):
    arr, (m, d, g) = _maps(sum(shape), shape, ll)
    mn = compute_max_n(arr)
    jm, jd, jg = (np.asarray(x) for x in jmaps.significance_maps(
        jnp.asarray(arr), *ll))
    np.testing.assert_array_equal(m.numpy(), jm)
    want = np.asarray(jplan.bits_per_plane_from_maps(
        jnp.asarray(jm), jnp.asarray(jd), jnp.asarray(jg), *ll, mn))
    got = planning.bits_per_plane_from_maps(m, d, g, *ll, mn)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        planning.bits_per_plane_from_maps_np(jm, jd, jg, *ll, mn), want)
    # the counts are the stream's: their sum is the full stream's length
    full, _ = japi.encode(arr, *ll)
    assert int(got.sum()) == int(want.sum()) >= len(full) * 8 - 7
    for mb in (1, 333, int(want.sum()) // 2, 10**9):
        wp, wb = jplan.cut_plane(jnp.asarray(want), mn, mb)
        gp, gb = planning.cut_plane(got, mn, mb)
        assert (int(gp), int(gb)) == (int(wp), int(wb))
        assert planning.cut_plane_np(got.numpy(), mn, mb) == (int(wp),
                                                               int(wb))


def test_planner_over_a_batch_equals_per_image():
    arrs = [_maps(s, (3, 24, 32), (6, 8)) for s in (7, 8)]
    m, d, g = (torch.stack([a[1][k] for a in arrs]) for k in range(3))
    mns = torch.tensor([compute_max_n(a[0]) for a in arrs])
    got = planning.bits_per_plane_from_maps(m, d, g, 6, 8, mns)
    for b, (arr, (mb, db, gb)) in enumerate(arrs):
        one = planning.bits_per_plane_from_maps(mb, db, gb, 6, 8, int(mns[b]))
        assert torch.equal(got[b], one)
    with pytest.raises(ValueError, match="even ll"):
        planning.bits_per_plane_from_maps(m, d, g, 5, 8, mns)


def test_plan_image_equals_jax():
    im = np.random.default_rng(9).random((3, 36, 52))
    want = jplan.plan_image(im, spiht_tpu.SpihtSettings(), None, 2000)
    got = planning.plan_image(im, pt.SpihtSettings(), None, 2000,
                              device="cpu")
    assert got == want


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((3, 19, 19), (5, 5))])
def test_seq_encoder_equals_b1(shape, ll):
    arr = (np.random.default_rng(10).standard_normal(shape) * 600).astype(
        np.int32)
    for mb in (2**31 - 2, 1, 333, 2001):
        seq = pt.encode(arr, *ll, mb, device="cpu", machine="seq")
        assert seq == encoder.encode(arr, *ll, mb, device="cpu")
        assert seq == japi.encode(arr, *ll, mb)
    with pytest.raises(ValueError, match="machine"):
        pt.encode(arr, *ll, device="cpu", machine="fast")


def test_seq_encoder_equals_pallas_seq_machine():
    arr = (np.random.default_rng(11).standard_normal((1, 16, 16)) * 300
           ).astype(np.int32)
    for mb in (2**31 - 2, 301):
        want = jpe.pallas_encode(arr, 4, 4, mb, interpret=True,
                                 machine="seq")
        assert pt.encode(arr, 4, 4, mb, device="cpu", machine="seq") == want


def test_native_loader_raises_on_a_failed_build(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "_SRCS", [bad])
    monkeypatch.setattr(runtime, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(runtime, "_LIB", None)
    with pytest.raises(RuntimeError, match="native kernel build failed"):
        runtime.load()
    assert not list((tmp_path / "build").iterdir())  # no half-written file
