"""The port's transforms against the JAX package's, in float64 on the CPU:
the packed DWT and its inverse for several wavelets in all nine modes, the
RGB <-> IPT conversion, every colour model name both ways, and the whole quantized analysis (int32
coefficients, max_n, M/D/G maps), which must be exactly equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spiht_tpu import jax_transform
from spiht_tpu.codec.device_encoder import device_max_n as jax_max_n
from spiht_tpu.color import jax_models
from spiht_tpu.settings import SpihtSettings as JSettings
from spiht_tpu.wavelets import dwt as jdwt

from spiht_tpu_torch import torch_transform
from spiht_tpu_torch.codec.maps import significance_maps
from spiht_tpu_torch.codec.maxn import device_max_n
from spiht_tpu_torch.color import torch_models
from spiht_tpu_torch.settings import SpihtSettings
from spiht_tpu_torch.wavelets import dwt

torch.set_num_threads(1)

MODES = ["zero", "constant", "symmetric", "reflect", "periodic", "smooth",
         "antisymmetric", "antireflect", "periodization"]
WAVELETS = ["haar", "bior2.2", "bior4.4"]

# Float results held to 1e-12 rather than exact equality, for two reasons
# named where used: IPT raises |x| to 0.43 and 1/0.43 with each library's
# own float64 pow (XLA's vs ATen's), which may differ by an ulp; and a
# jitted JAX program may contract a multiply-add into an FMA.
ATOL = 1e-12


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape)


@pytest.mark.parametrize("mode", MODES)
def test_extend_matches_jax(mode):
    for n in (1, 2, 5, 9):
        x = _img(n, (2, n))
        for pad in (1, 3, 7):
            np.testing.assert_array_equal(
                dwt.extend(torch.as_tensor(x), pad, mode).numpy(),
                np.asarray(jdwt.extend(jnp.asarray(x), pad, mode)),
            )


# Exact against the JAX module run op by op: both do one multiply and one
# add per tap in the same order. (Under jax.jit, XLA may contract a
# multiply-add into an FMA, which moves the last ulp; the quantized
# pipelines below are exact either way.)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_wavedec2_packed_and_waverec2_match_jax(wavelet, mode):
    x = _img(1, (2, 11, 14))
    aj, lhj, lwj = jdwt.wavedec2_packed(jnp.asarray(x), wavelet, mode, 1)
    at, lht, lwt = dwt.wavedec2_packed(torch.as_tensor(x), wavelet, mode, 1)
    assert (lht, lwt) == (lhj, lwj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))

    cj = jdwt.wavedec2(jnp.asarray(x), wavelet, mode, 1)
    ct = dwt.wavedec2(torch.as_tensor(x), wavelet, mode, 1)
    yj = jdwt.waverec2(cj, wavelet, mode)
    yt = dwt.waverec2(ct, wavelet, mode)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("mode", ["reflect", "periodization"])
def test_dwt1d_odd_lengths_match_jax(mode):
    for n in (1, 2, 7):
        x = _img(n, (3, n))
        for axis in (-1, 0):
            cj = jdwt.dwt1d(jnp.asarray(x), "bior2.2", mode, axis=axis)
            ct = dwt.dwt1d(torch.as_tensor(x), "bior2.2", mode, axis=axis)
            for a, b in zip(ct, cj):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            yj = jdwt.idwt1d(*cj, "bior2.2", mode, axis=axis)
            yt = dwt.idwt1d(*ct, "bior2.2", mode, axis=axis)
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_rgb_ipt_conversion_matches_jax():
    x = _img(2, (3, 17, 19))
    fj = np.asarray(jax_models.convert(jnp.asarray(x), "RGB", "ipt"))
    ft = torch_models.convert(torch.as_tensor(x), "RGB", "ipt").numpy()
    fj = np.array(fj)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=ATOL)
    bj = np.asarray(jax_models.convert(jnp.asarray(fj), "ipt", "RGB"))
    bt = torch_models.convert(torch.as_tensor(fj), "ipt", "RGB").numpy()
    np.testing.assert_allclose(bt, bj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(bt, x, rtol=0, atol=1e-9)
    assert torch.equal(
        torch_models.convert(torch.as_tensor(x), "rgb", "RGB"),
        torch.as_tensor(x),
    )


@pytest.mark.parametrize("name", sorted(torch_models.REFERENCE_MODELS))
def test_every_colour_model_converts(name):
    """Every name the JAX package accepts converts both ways, in any case
    of letters, to finite values of the input's shape."""
    x = torch.as_tensor(_img(3, (3, 5, 6)) * 0.98 + 0.01)
    out = torch_models.convert(x, "RGB", name.upper())
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    back = torch_models.convert(out, name, "rgb")
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0, atol=1e-6)


def test_unknown_colour_model_raises():
    x = torch.zeros(3, 4, 4, dtype=torch.float64)
    assert torch_models.SUPPORTED_MODELS == torch_models.REFERENCE_MODELS
    for src, dest in (("RGB", "no such model"), ("hsv", "RGB")):
        with pytest.raises(ValueError, match="not a supported color model"):
            torch_models.convert(x, src, dest)


CASES = [
    # (settings kwargs, level, shape)
    (dict(), 3, (3, 40, 36)),
    (dict(wavelet="bior4.4", mode="symmetric"), 2, (3, 33, 29)),
    (dict(wavelet="haar", mode="periodization", quantization_scale=80.0),
     None, (2, 32, 48)),
    (dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
          quantization_scale=1.0), 3, (3, 40, 44)),
    (dict(wavelet="bior4.4", mode="symmetric", color_model="ipt",
          per_channel_quant_scales=[50, 15, 15], quantization_scale=2.0),
     None, (3, 48, 48)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_quantized_analysis_and_maps_exact(case):
    kw, level, shape = CASES[case]
    x = _img(10 + case, shape)
    fn = jax_transform.analysis_fn(JSettings(**kw), level, True, "float64")
    aj, mj, dj, gj = (np.asarray(v) for v in fn(jnp.asarray(x)))
    at, ll_h, ll_w = torch_transform.forward(
        torch.as_tensor(x), SpihtSettings(**kw), level
    )
    np.testing.assert_array_equal(at.numpy(), aj)
    m, d, g = significance_maps(at, ll_h, ll_w)
    for a, b in ((m, mj), (d, dj), (g, gj)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(device_max_n(at)) == int(jax_max_n(jnp.asarray(aj)))


def test_max_n_exact_at_float32_edges():
    for v in (0, 1, 2, 3, 7, 8, 2**24 - 1, 2**25 - 2, 2**25 - 1, 2**30 + 5,
              2**31 - 1):
        a = np.zeros((1, 4, 4), np.int32)
        a[0, 1, 2] = -v if v % 2 else v
        assert int(device_max_n(torch.as_tensor(a))) == int(
            jax_max_n(jnp.asarray(a))
        ), v


@pytest.mark.parametrize("case", range(len(CASES)))
def test_inverse_matches_jax(case):
    kw, level, shape = CASES[case]
    c, h, w = shape
    fn = jax_transform.analysis_fn(JSettings(**kw), level, False, "float64")
    arr = np.asarray(fn(jnp.asarray(_img(20 + case, shape))))
    rec = (arr >> 2) << 2  # a coarser rec, as a decoder produces
    syn = jax_transform.synthesis_fn(JSettings(**kw), h, w, level, "float64")
    yj = np.asarray(syn(jnp.asarray(rec)))
    yt = torch_transform.inverse(
        torch.as_tensor(rec), h, w, level, SpihtSettings(**kw)
    ).numpy()
    assert yt.shape == yj.shape
    # the JAX synthesis is one jitted program, where XLA may fuse a
    # multiply-add into an FMA: a few ulp apart (IPT adds pow's ulp)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=ATOL)
    u8j = np.asarray(jax_transform.synthesis_fn(
        JSettings(**kw), h, w, level, "float64", as_uint8=True
    )(jnp.asarray(rec)))
    u8t = torch_transform.inverse(
        torch.as_tensor(rec), h, w, level, SpihtSettings(**kw),
        as_uint8=True,
    ).numpy()
    assert u8t.dtype == np.uint8
    # an ulp apart can round a pixel that sits on .5 the other way
    assert np.abs(u8t.astype(int) - u8j.astype(int)).max() <= 1


def test_float32_analysis_close_to_jax():
    x = _img(5, (3, 40, 36))
    fn = jax_transform.analysis_fn(JSettings(), 3, False, "float32")
    aj = np.asarray(fn(jnp.asarray(x)))
    at, _, _ = torch_transform.forward(
        torch.as_tensor(x), SpihtSettings(), 3, dtype=torch.float32
    )
    # float32 sums in the same order may still round differently at a
    # borderline truncation (the documented float32 caveat): off by one
    # at most, and rarely
    diff = np.abs(at.numpy().astype(np.int64) - aj)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
