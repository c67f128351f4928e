"""The port's metadata trace (kernel B2-log's plain version, or B3-log's
at odd LL, then the event log's expansion in torch) against the JAX
package: the rec and the 8-column trace of ``spiht_tpu.decode_with_metadata``
(its native route) exactly, at budgets that cut after one bit and inside a
symbol, full streams and byte prefixes, on duplicate-free and on
duplicate-parent geometries (nodes whose instances differ in filter
included) and on one just past 2^24 cells; the raw event log against the
Pallas ``with_log`` kernel in interpret mode at one small shape."""

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


B44 = dict(wavelet="bior4.4", mode="symmetric")


def _nodes_with_two_filters(data, max_n, geo):
    """Nodes whose events in B3-log's log carry more than one filter (the
    instances of a node with several LL parents)."""
    _, log, _, nbits = meta_expand.decode_event_log(data, max_n, *geo, "cpu")
    lg = log[: nbits + 1].numpy()
    lg = lg[lg != 0]
    node, filt = lg & 0xFFFFFFFF, (lg >> 40) & 3
    pairs = np.unique(np.stack([node, filt], 1), axis=0)
    nodes, counts = np.unique(pairs[:, 0], return_counts=True)
    return nodes[counts > 1]


@pytest.mark.parametrize(
    "shape,kw,level,budget,cut,odd",
    [
        ((2, 64, 64), {}, 3, 1, None, False),  # one bit
        ((2, 64, 64), {}, 3, 4097, None, False),  # cut inside a symbol
        ((3, 44, 60), IPT, 2, None, None, False),  # full stream
        ((3, 44, 60), IPT, 2, None, 333, False),  # byte prefix of the full stream
        ((1, 64, 48), {}, None, None, 91, False),  # odd encoded dims, prefix
        # odd LL (LL 15x15, duplicate parents): B3-log
        ((3, 64, 64), B44, 3, None, None, True),  # full stream
        ((3, 64, 64), B44, 3, None, 1111, True),  # byte prefix
        ((3, 64, 64), B44, 3, 9999, None, True),  # cut inside a symbol
        ((2, 40, 40), {}, 3, None, None, True),  # LL 9x9
    ],
)
def test_trace_equals_jax_package(shape, kw, level, budget, cut, odd):
    js, ts = spiht_tpu.SpihtSettings(**kw), pt.SpihtSettings(**kw)
    im = np.random.default_rng(sum(shape)).random(shape)
    er = spiht_tpu.encode_image(im, js, level, budget)
    data = er.encoded_bytes[:cut]
    geo, wire = _geometry(shape, ts, level)
    assert decoder.has_duplicate_parents(*geo[1:]) == odd
    if odd:  # the trace has rows of nodes whose instances differ in filter
        assert _nodes_with_two_filters(data, er.max_n, geo).size
    want_rec, want_meta = spiht_tpu.decode_with_metadata(
        data, er.max_n, *geo, *wire)
    rec, meta = pt.decode_with_metadata(data, er.max_n, *geo, *wire,
                                        device="cpu")
    assert meta.shape == (len(data) * 8 + 1, 8) and meta.dtype == np.int32
    np.testing.assert_array_equal(rec, want_rec)
    np.testing.assert_array_equal(meta, want_meta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_odd_ll_trace_on_random_words(seed):
    """Random words (no encoder's stream) at odd LL: nodes committed again
    by a second parent and refined by several instances, with bits that
    clear a magnitude's last bit (the sign lost at 0), replayed exactly."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    geo, wire = _geometry((3, 40, 40), pt.SpihtSettings(), 3)
    assert decoder.has_duplicate_parents(*geo[1:])
    max_n = 5 + 3 * seed
    want_rec, want_meta = spiht_tpu.decode_with_metadata(
        data, max_n, *geo, *wire)
    rec, meta = pt.decode_with_metadata(data, max_n, *geo, *wire,
                                        device="cpu")
    np.testing.assert_array_equal(rec, want_rec)
    np.testing.assert_array_equal(meta, want_meta)


def _past_2_24():
    """A 3-channel geometry just past 2^24 cells (3x2402x2402, LL 14x14)."""
    geo, wire = _geometry((3, 2365, 2365), pt.SpihtSettings(), None)
    assert 2**24 < geo[0] * geo[1] * geo[2] < 2**24 * 1.05
    return geo, wire


def test_trace_past_2_24_cells():
    """A few bytes of random words just past 2^24 cells: the 64-bit event
    word holds the node, and the trace equals the JAX package's."""
    geo, wire = _past_2_24()
    data = np.random.default_rng(24).integers(0, 256, 6, np.uint8).tobytes()
    want_rec, want_meta = spiht_tpu.decode_with_metadata(data, 9, *geo, *wire)
    rec, meta = pt.decode_with_metadata(data, 9, *geo, *wire, device="cpu")
    assert meta.shape == (6 * 8 + 1, 8)
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
    # the 64-bit word repacked to the Pallas word, node | action << 24 |
    # (n+1) << 27; B2-log's filter field is 0
    lg = log.numpy()
    assert not (lg >> 40).any()
    packed = (lg & 0xFFFFFF) | ((lg >> 32) & 7) << 24 | ((lg >> 35) & 31) << 27
    np.testing.assert_array_equal(packed.astype(np.uint32).view(np.int32),
                                  jlog[: nbits + 1])
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
    """What used to raise now returns, equal to the JAX package: the trace
    of a duplicate-parent geometry (B3-log) and the event log of one past
    2^24 cells (the 64-bit word). The plane field still bounds max_n."""
    args = (b"\x00", 3, 1, 19, 19, 5, 5, [(0, 5), (0, 5)], [])
    want_rec, want_meta = spiht_tpu.decode_with_metadata(*args)
    rec, meta = pt.decode_with_metadata(*args, device="cpu")
    np.testing.assert_array_equal(rec, want_rec)
    np.testing.assert_array_equal(meta, want_meta)
    geo, _ = _past_2_24()
    rec, log, _, nbits = meta_expand.decode_event_log(b"\x00", 3, *geo, "cpu")
    np.testing.assert_array_equal(rec.numpy(),
                                  spiht_tpu.decode(b"\x00", 3, *geo))
    assert log.shape == (9,) and (log != 0).all()
    words, nbits = decoder.words_tensor(b"\xff", "cpu")
    for wrapper, shape in ((decoder.decode_lsp_log, (1, 16, 16, 4, 4)),
                           (decoder.decode_seq_log, (1, 19, 19, 5, 5))):
        args = decoder.machine_args(words, nbits, 31, *shape)
        with pytest.raises(ValueError, match="max_n <= 30"):
            wrapper(*args)


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
