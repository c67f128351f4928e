"""The names of the JAX package's ``__all__`` that the port exports on top
of its own entry points, each held to its JAX counterpart on the CPU
(the kernels' plain versions), with inputs made from a seed with numpy.

Streams and integers are held exactly, against ``spiht_tpu.encode`` /
``decode`` / ``decode_with_metadata`` (the native scheduler, bit-exact
with the JAX package's Pallas machines); B6's name against the Pallas
kernel in interpret mode. Transforms are held exactly in float64, the
jitted synthesis within ``ATOL`` (XLA fuses its multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu import jax_transform
from spiht_tpu.codec import maps as jmaps
from spiht_tpu.codec import pallas_decoder as jpd
from spiht_tpu.codec import pallas_encoder as jpe
from spiht_tpu.ops import pallas_kernels as jpk
from spiht_tpu.settings import SpihtSettings as JSettings

from spiht_tpu_torch import torch_transform
from spiht_tpu_torch.codec import (
    api, decoder, encoder, maps, meta_expand,
)
from spiht_tpu_torch.ops import quantize_kernels
from spiht_tpu_torch.settings import SpihtSettings
from spiht_tpu_torch.wavelets.geometry import (
    get_slices_and_h_w, slices_to_wire,
)

torch.set_num_threads(1)

CPU = "cpu"
ATOL = 1e-12  # the jitted JAX synthesis: a few ulp (fused multiply-adds)

# (c, h, w), (ll_h, ll_w): even LL (B2, B5) and odd LL (B3)
GEOMS = [((1, 16, 16), (4, 4)), ((3, 12, 20), (3, 5))]
GEOM_IDS = ["even_ll", "odd_ll"]
BUDGETS = [2**31 - 2, 700, 97]

SETTINGS = [
    (dict(), 3, (3, 40, 36)),
    (dict(wavelet="bior4.4", mode="symmetric", color_model="ipt",
          per_channel_quant_scales=[100, 20, 20], quantization_scale=1.0),
     2, (3, 33, 29)),
]


def _arr(shape, seed):
    return np.random.default_rng(seed).integers(
        -400, 400, shape).astype(np.int32)


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape)


@pytest.mark.parametrize("case,with_maps", [(0, True), (1, False)])
def test_analysis_fn_equals_jax(case, with_maps):
    kw, level, shape = SETTINGS[case]
    x = _img(shape, case)
    want = jax_transform.analysis_fn(JSettings(**kw), level, with_maps,
                                     "float64")(jnp.asarray(x))
    got = torch_transform.analysis_fn(SpihtSettings(**kw), level, with_maps,
                                      "float64")(torch.as_tensor(x))
    if not with_maps:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("case", range(len(SETTINGS)))
def test_synthesis_fn_equals_jax(case):
    kw, level, shape = SETTINGS[case]
    c, h, w = shape
    arr = torch_transform.analysis_fn(SpihtSettings(**kw), level, False)(
        torch.as_tensor(_img(shape, 10 + case)))
    rec = (arr.numpy() >> 3) << 3
    want = np.asarray(jax_transform.synthesis_fn(
        JSettings(**kw), h, w, level, "float64")(jnp.asarray(rec)))
    got = torch_transform.synthesis_fn(SpihtSettings(**kw), h, w, level,
                                       "float64")(torch.as_tensor(rec))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # exactly the port's op-by-op inverse
    assert torch.equal(got, torch_transform.inverse(
        torch.as_tensor(rec), h, w, level, SpihtSettings(**kw)))
    u8 = torch_transform.synthesis_fn(SpihtSettings(**kw), h, w, level,
                                      as_uint8=True)(torch.as_tensor(rec))
    u8j = np.asarray(jax_transform.synthesis_fn(
        JSettings(**kw), h, w, level, "float64", as_uint8=True)(
            jnp.asarray(rec)))
    assert u8.dtype == torch.uint8
    assert np.abs(u8.numpy().astype(int) - u8j.astype(int)).max() <= 1


@pytest.mark.parametrize("case", range(len(SETTINGS)))
def test_float32_factories_close_to_jax(case):
    """The float32 route of ``analysis_fn`` and ``synthesis_fn`` against
    JAX's float32 programs: the analysis within the float32 caveat of
    ``test_torch_transform.test_float32_analysis_close_to_jax`` (a
    borderline truncation may flip by one, rarely), the synthesis within
    16 float32 ulp of the image's largest value (XLA fuses the
    multiply-adds)."""
    kw, level, shape = SETTINGS[case]
    c, h, w = shape
    x = _img(shape, 30 + case)
    aj = np.asarray(jax_transform.analysis_fn(
        JSettings(**kw), level, False, "float32")(jnp.asarray(x)))
    at = torch_transform.analysis_fn(
        SpihtSettings(**kw), level, False, "float32")(torch.as_tensor(x))
    assert at.dtype == torch.int32 and at.shape == aj.shape
    diff = np.abs(at.numpy().astype(np.int64) - aj)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    rec = (aj >> 3) << 3
    sj = np.asarray(jax_transform.synthesis_fn(
        JSettings(**kw), h, w, level, "float32")(jnp.asarray(rec)))
    st = torch_transform.synthesis_fn(
        SpihtSettings(**kw), h, w, level, "float32")(torch.as_tensor(rec))
    assert st.dtype == torch.float32 and st.shape == sj.shape
    ulp = np.finfo(np.float32).eps * np.abs(sj).max()
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=16 * ulp)


@pytest.mark.parametrize("case", range(len(SETTINGS)))
def test_forward_with_maps_equals_jax(case):
    kw, level, shape = SETTINGS[case]
    x = _img(shape, 20 + case)
    aj, mdg_j, llh_j, llw_j = jax_transform.forward_with_maps(
        x, JSettings(**kw), level)
    at, mdg_t, llh, llw = torch_transform.forward_with_maps(
        torch.as_tensor(x), SpihtSettings(**kw), level)
    assert (llh, llw) == (llh_j, llw_j)
    np.testing.assert_array_equal(at.numpy(), aj)
    for g, wv in zip(mdg_t, mdg_j):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), wv)


def test_default_dtype_is_the_x64_reference_dtype():
    """Under x64 (the tests' JAX) the reference's default is float64: the
    port's working dtype on every device."""
    assert torch_transform.default_dtype() == torch.float64
    assert np.dtype(jax_transform.default_dtype()).name == "float64"
    assert torch_transform._as_dtype("float32") == torch.float32
    assert torch_transform._as_dtype(None) == torch.float64


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 3, 8, 12)])
def test_max_n_from_maps_equals_jax(shape):
    arr = _arr(shape, 3)
    arr.reshape(-1)[5] = 2**25 - 2  # exact rule: 24, the f32 rule gives 25
    arr.reshape(-1)[-1] = 0
    m = maps.significance_maps(torch.as_tensor(arr), 2, 2)[0]
    want = jmaps.max_n_from_maps(jnp.asarray(m.numpy()))
    got = maps.max_n_from_maps(m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zero = maps.max_n_from_maps(torch.full((1, 4, 4), -1, dtype=torch.int8))
    assert zero.tolist() == [0]


@pytest.mark.parametrize("shape,scale", [((3, 40, 36), 2.0),
                                         ((2, 3, 17, 24), 300.0)])
def test_quantize_compact_m_equals_pallas(shape, scale):
    """B6's plain version under the reference's name against the Pallas
    kernel in interpret mode: the four outputs, leading shape kept."""
    x = (np.random.default_rng(4).standard_normal(shape) * 60).astype(
        np.float32)
    want = jpk.quantize_compact_m(jnp.asarray(x), scale, interpret=True)
    got = quantize_kernels.quantize_compact_m(torch.as_tensor(x), scale)
    for g, wv, dt in zip(got, want, (torch.int32, torch.int16, torch.int8,
                                     torch.bool)):
        assert g.dtype == dt and tuple(g.shape) == tuple(np.shape(wv))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("max_bits", BUDGETS)
@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_pallas_encode_equals_reference(geom, max_bits):
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    arr = _arr((c, h, w), geom)
    want = spiht_tpu.encode(arr, ll_h, ll_w, max_bits)
    for machine in (None, "hybrid", "seq"):
        assert encoder.pallas_encode(arr, ll_h, ll_w, max_bits, machine,
                                     device=CPU) == want


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_pallas_encode_fn_equals_reference(geom):
    """(words, total, overflow) for a caller's max_n, and the overflow
    flag where the caller's buffer is smaller than the budget."""
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    arr = _arr((c, h, w), 10 + geom)
    want, mn = spiht_tpu.encode(arr, ll_h, ll_w, 600)
    for machine in (None, "seq"):
        fn = encoder.pallas_encode_fn(c, h, w, ll_h, ll_w,
                                      encoder.cap_words_for(c, h, w, 600),
                                      machine, device=CPU)
        words, total, ovf = fn(arr, mn, 600)
        assert not bool(ovf) and int(total) == 600
        assert encoder.stream_bytes(words, int(total)) == want
        small = encoder.pallas_encode_fn(c, h, w, ll_h, ll_w, 4, machine,
                                         device=CPU)
        words, total, ovf = small(torch.as_tensor(arr), torch.tensor(mn),
                                  600)
        assert bool(ovf) and int(total) == 128
        assert encoder.stream_bytes(words, 128) == want[:16]
    # the reference's EncCapacityOverflow: a RuntimeError, raised by
    # check_stat for the stream-capacity error
    assert issubclass(encoder.EncCapacityOverflow, RuntimeError)
    assert issubclass(jpe.EncCapacityOverflow, RuntimeError)
    with pytest.raises(encoder.EncCapacityOverflow):
        encoder.check_stat(torch.tensor([128, 1, 0, 0, 0, 0]), "enc")


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_pallas_encode_batch_equals_reference(geom):
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    arrs = np.stack([_arr((c, h, w), 20 + b) for b in range(3)])
    mbs = [2**31 - 2, 500, 64]
    want = [spiht_tpu.encode(a, ll_h, ll_w, mb) for a, mb in zip(arrs, mbs)]
    for machine in (None, "seq"):
        assert encoder.pallas_encode_batch(arrs, ll_h, ll_w, mbs, machine,
                                           device=CPU) == want
        cw = encoder.cap_words_for(c, h, w, 2**31 - 2)
        fn = encoder.pallas_encode_batch_fn(c, h, w, ll_h, ll_w, cw, machine,
                                            device=CPU)
        words, totals, ovf = fn(arrs, [mn for _, mn in want], mbs)
        assert not ovf.any()
        assert encoder.batch_stream_bytes(words, totals.tolist()) == [
            d for d, _ in want]


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_pallas_decode_equals_reference(geom):
    """pallas_decode and its fn (int32 and int16 rec, both machines) on
    full streams and byte prefixes."""
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    data, mn = spiht_tpu.encode(_arr((c, h, w), 30 + geom), ll_h, ll_w)
    for cut in (len(data), 37, 5):
        d = data[:cut]
        want = spiht_tpu.decode(d, mn, c, h, w, ll_h, ll_w)
        got = decoder.pallas_decode(d, mn, c, h, w, ll_h, ll_w, device=CPU)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        words, nbits = decoder.words_tensor(d, CPU)
        for machine in (None, "seq"):
            fn = decoder.pallas_decode_fn(c, h, w, ll_h, ll_w, words.numel(),
                                          machine, device=CPU)
            np.testing.assert_array_equal(fn(words, nbits, mn).numpy(), want)
        fn16 = decoder.pallas_decode_fn(c, h, w, ll_h, ll_w, words.numel(),
                                        out_dtype="int16", device=CPU)
        rec16 = fn16(words.numpy().view(np.uint32), nbits, mn)
        assert rec16.dtype == torch.int16
        np.testing.assert_array_equal(rec16.numpy(), want)


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_pallas_decode_batch_equals_reference(geom):
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    streams = [spiht_tpu.encode(_arr((c, h, w), 40 + b), ll_h, ll_w, mb)
               for b, mb in enumerate((2**31 - 2, 300, 90))]
    datas = [d for d, _ in streams]
    mns = [mn for _, mn in streams]
    want = np.stack([spiht_tpu.decode(d, mn, c, h, w, ll_h, ll_w)
                     for d, mn in streams])
    for machine in (None, "seq"):
        got = decoder.pallas_decode_batch(datas, mns, c, h, w, ll_h, ll_w,
                                          machine, device=CPU)
        np.testing.assert_array_equal(got, want)
        words, nbits = decoder.words_batch(datas, CPU)
        fn = decoder.pallas_decode_batch_fn(c, h, w, ll_h, ll_w,
                                            words.shape[1], machine,
                                            device=CPU)
        np.testing.assert_array_equal(fn(words, nbits, mns).numpy(), want)


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_pallas_decode_with_metadata_equals_reference(geom):
    """(rec, trace) through B2-log or B3-log and the expansion, against
    the reference's trace; at odd LL the reference's Pallas route raises
    MachineResourceLimit, the port decodes."""
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    data, mn = spiht_tpu.encode(_arr((c, h, w), 50 + geom), ll_h, ll_w, 900)
    slices, _, _ = get_slices_and_h_w(h, w, SpihtSettings(wavelet="haar"), 2)
    assert (slices[0][1].stop, slices[0][2].stop) == (ll_h, ll_w)
    top, other = slices_to_wire(slices)
    want = spiht_tpu.decode_with_metadata(data, mn, c, h, w, ll_h, ll_w,
                                          top, other)
    got = meta_expand.pallas_decode_with_metadata(
        data, mn, c, h, w, ll_h, ll_w, top, other, device=CPU)
    for g, wv in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, wv)


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
def test_fits_agree_with_reference_on_small_geometries(geom):
    """Where both take a small geometry, both say so; the port answers
    the same for a large one (no VMEM budget) and refuses past 2^29."""
    (c, h, w), (ll_h, ll_w) = GEOMS[geom]
    cw = 64
    assert encoder.machine_fits(c, h, w, ll_h, ll_w, cw) == \
        jpe.machine_fits(c, h, w, ll_h, ll_w, cw) is True
    assert decoder.machine_fits(c, h, w, ll_h, ll_w, cw) == \
        jpd.machine_fits(c, h, w, ll_h, ll_w, cw) is True
    assert encoder.interleaved_fits(4, c, h, w, ll_h, ll_w, cw) == \
        jpe.interleaved_fits(4, c, h, w, ll_h, ll_w, cw) is True
    # B5, as the reference's interleaved decoder, takes no duplicate parents
    assert decoder.interleaved_fits(4, c, h, w, ll_h, ll_w, cw) == \
        jpd.interleaved_fits(4, c, h, w, ll_h, ll_w, cw) == (geom == 0)
    assert encoder.machine_fits(3, 4096, 4096, 128, 128, 1 << 20)
    assert not encoder.machine_fits(4, 16384, 8192, 256, 128)
    assert issubclass(decoder.MachineResourceLimit, RuntimeError)
    assert issubclass(jpd.MachineResourceLimit, RuntimeError)


def test_api_exports_get_slices_and_h_w():
    s = SpihtSettings(wavelet="db2", mode="periodization")
    assert api.get_slices_and_h_w(37, 61, s, 2) == \
        spiht_tpu.codec.api.get_slices_and_h_w(
            37, 61, JSettings(wavelet="db2", mode="periodization"), 2)
