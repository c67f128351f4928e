"""The port's metadata trace (kernel B2-log's plain version, then the
event log's expansion in torch) against the JAX package: the rec and the
8-column trace of ``spiht_tpu.decode_with_metadata`` (its native route)
exactly, at budgets that cut after one bit and inside a symbol, full
streams and byte prefixes; the raw event log against the Pallas
``with_log`` kernel in interpret mode at one small shape."""

import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu.codec import meta_expand as jme

import spiht_tpu_torch as pt
from spiht_tpu_torch.codec import decoder, meta_expand
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w, slices_to_wire

torch.set_num_threads(1)

IPT = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
           quantization_scale=1.0)


def _geometry(shape, settings, level):
    c, h, w = shape
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    return ((c, enc_h, enc_w, slices[0][1].stop, slices[0][2].stop),
            slices_to_wire(slices))


@pytest.mark.parametrize(
    "shape,kw,level,budget,cut",
    [
        ((2, 64, 64), {}, 3, 1, None),  # one bit
        ((2, 64, 64), {}, 3, 4097, None),  # cut inside a symbol
        ((3, 44, 60), IPT, 2, None, None),  # full stream
        ((3, 44, 60), IPT, 2, None, 333),  # byte prefix of the full stream
        ((1, 64, 48), {}, None, None, 91),  # odd encoded dims, prefix
    ],
)
def test_trace_equals_jax_package(shape, kw, level, budget, cut):
    js, ts = spiht_tpu.SpihtSettings(**kw), pt.SpihtSettings(**kw)
    im = np.random.default_rng(sum(shape)).random(shape)
    er = spiht_tpu.encode_image(im, js, level, budget)
    data = er.encoded_bytes[:cut]
    geo, wire = _geometry(shape, ts, level)
    assert not decoder.has_duplicate_parents(*geo[1:])
    want_rec, want_meta = spiht_tpu.decode_with_metadata(
        data, er.max_n, *geo, *wire)
    rec, meta = pt.decode_with_metadata(data, er.max_n, *geo, *wire,
                                        device="cpu")
    assert meta.shape == (len(data) * 8 + 1, 8) and meta.dtype == np.int32
    np.testing.assert_array_equal(rec, want_rec)
    np.testing.assert_array_equal(meta, want_meta)


def test_raw_event_log_equals_pallas_with_log():
    """The port's event words equal the Pallas with_log kernel's (interpret
    mode), at every offset up to nbits and nowhere after."""
    settings = spiht_tpu.SpihtSettings()
    im = np.random.default_rng(3).random((2, 32, 32))
    er = spiht_tpu.encode_image(im, settings, 3, 1500)
    geo, _ = _geometry((2, 32, 32), pt.SpihtSettings(), 3)
    data = er.encoded_bytes[:150]
    _, jlog, _, nbits = jme.decode_event_log(data, er.max_n, *geo,
                                             interpret=True)
    rec, log, words, nb = meta_expand.decode_event_log(
        data, er.max_n, *geo, "cpu")
    jlog = np.asarray(jlog)
    assert nb == nbits and log.shape == (nbits + 1,)
    np.testing.assert_array_equal(log.numpy(), jlog[: nbits + 1])
    assert not jlog[nbits + 1:].any()
    assert log[nbits] != 0  # the read that found the stream empty


def test_decode_image_with_metadata():
    kw = dict(IPT)
    shape = (3, 36, 52)
    im = np.random.default_rng(4).random(shape)
    er = spiht_tpu.encode_image(im, spiht_tpu.SpihtSettings(**kw), None, 5000)
    want_img, want_meta = spiht_tpu.decode_image(
        er, spiht_tpu.SpihtSettings(**kw), return_metadata=True)
    img, meta = pt.decode_image(pt.EncodingResult(**vars(er)),
                                pt.SpihtSettings(**kw), return_metadata=True,
                                device="cpu")
    np.testing.assert_allclose(img, want_img, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(meta, want_meta)
    plain = pt.decode_image(pt.EncodingResult(**vars(er)),
                            pt.SpihtSettings(**kw), device="cpu")
    np.testing.assert_array_equal(plain, img)


def test_decode_rec_array_fields():
    settings = pt.SpihtSettings()
    im = np.random.default_rng(5).random((1, 28, 44))
    er = pt.encode_image(im, settings, 2, 800, device="cpu")
    jer = spiht_tpu.encode_image(im, spiht_tpu.SpihtSettings(), 2, 800)
    assert (er.encoded_bytes, er.max_n) == (jer.encoded_bytes, jer.max_n)
    d = pt.decode_rec_array(er, settings, return_metadata=True, device="cpu")
    j = spiht_tpu.decode_rec_array(
        spiht_tpu.EncodingResult(**vars(er)), spiht_tpu.SpihtSettings(),
        return_metadata=True)
    assert set(d) == set(j)
    np.testing.assert_array_equal(d["rec_arr"], j["rec_arr"])
    np.testing.assert_array_equal(d["spiht_metadata"], j["spiht_metadata"])
    assert (d["h"], d["w"], d["level"], d["slices"]) == (
        j["h"], j["w"], j["level"], j["slices"])


def test_odd_ll_and_oversize_raise():
    """Duplicate-parent geometries are not traced (ROADMAP Queue A item
    10); the event word's fields bound c*h*w and max_n."""
    with pytest.raises(ValueError, match="Queue A item 10"):
        pt.decode_with_metadata(b"\x00", 3, 1, 19, 19, 5, 5, [(0, 5), (0, 5)],
                                [], device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        meta_expand.decode_event_log(b"\x00", 3, 1, 4096, 4096, 16, 16, "cpu")
    words, nbits = decoder.words_tensor(b"\xff", "cpu")
    args = decoder.machine_args(words, nbits, 31, 1, 16, 16, 4, 4)
    with pytest.raises(ValueError, match="max_n <= 30"):
        decoder.decode_lsp_log(*args)


def test_entry_points_need_the_card_or_cpu(monkeypatch):
    """Without a card and without device="cpu" the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decode_with_metadata(b"\x00", 3, 1, 16, 16, 4, 4, [(0, 4), (0, 4)],
                                [], )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decode(b"\x00", 3, 1, 16, 16, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.encode_images([np.zeros((1, 16, 16))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decode_images([pt.EncodingResult(b"\x00", 16, 16, 1, 3, 2)],
                         pt.SpihtSettings())
