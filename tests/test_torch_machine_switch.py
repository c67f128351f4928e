"""The reference's machine switches in the port, on the CPU.

``SPIHT_TPU_PALLAS_ENC_MACHINE`` and ``SPIHT_TPU_PALLAS_DEC_MACHINE``
(``docs/API.md``) choose the machine of the JAX package's ``pallas_*``
functions where their ``machine`` is None. The port's counterparts read
them in the same places: ``seq`` routes every encode function to kernel
B7's wrapper ``encode_machine_seq`` and every decode function to B3's
(``decode_seq``, ``decode_seq_batch``), which the tests spy on; the
compact layouts refuse max_n > 15 with ``MachineResourceLimit`` as
``spiht_tpu.codec.pallas_encoder.pallas_encode`` does (it raises before
any Pallas call, so the reference runs here); unset, the routes are the
defaults (B1, B4, B2, B5, B3 at odd LL). Streams and rec are held to
``spiht_tpu.encode`` / ``decode``
(the native scheduler, bit-exact with the JAX package's machines).
"""

import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu.codec import pallas_encoder as jpe

from spiht_tpu_torch.codec import decoder, encoder

torch.set_num_threads(1)

CPU = "cpu"
ENC = "SPIHT_TPU_PALLAS_ENC_MACHINE"
DEC = "SPIHT_TPU_PALLAS_DEC_MACHINE"
# (c, h, w), (ll_h, ll_w): even LL (B1, B2, B5) and odd LL (B3 regardless)
GEOMS = [((1, 16, 16), (4, 4)), ((3, 12, 20), (3, 5))]
GEOM_IDS = ["even_ll", "odd_ll"]
MAX_BITS = 900


def _arr(shape, seed, spread=400):
    return np.random.default_rng(seed).integers(
        -spread, spread, shape).astype(np.int32)


def _spy(monkeypatch, module, name):
    """Replace ``module.name`` by a wrapper that counts its calls."""
    real = getattr(module, name)
    calls = []

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _encode_with(fn, arrs, ll):
    """[(bytes, max_n)] of each array of ``arrs`` through one of the four
    ``pallas_*`` encode functions, on the CPU."""
    B, c, h, w = arrs.shape
    if fn == "pallas_encode":
        return [encoder.pallas_encode(a, *ll, MAX_BITS, device=CPU)
                for a in arrs]
    if fn == "pallas_encode_batch":
        return encoder.pallas_encode_batch(arrs, *ll, MAX_BITS, device=CPU)
    cw = encoder.cap_words_for(c, h, w, MAX_BITS)
    mns = [spiht_tpu.encode(a, *ll, MAX_BITS)[1] for a in arrs]
    if fn == "pallas_encode_fn":
        f = encoder.pallas_encode_fn(c, h, w, *ll, cw, device=CPU)
        outs = [f(a, mn, MAX_BITS) for a, mn in zip(arrs, mns)]
        words = torch.stack([o[0] for o in outs])
        totals = [int(o[1]) for o in outs]
    else:
        f = encoder.pallas_encode_batch_fn(c, h, w, *ll, cw, device=CPU)
        words, tot, _ = f(arrs, mns, [MAX_BITS] * B)
        totals = tot.tolist()
    return list(zip(encoder.batch_stream_bytes(words, totals), mns))


ENC_FNS = ["pallas_encode", "pallas_encode_fn", "pallas_encode_batch",
           "pallas_encode_batch_fn"]


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
@pytest.mark.parametrize("fn", ENC_FNS)
@pytest.mark.parametrize("value", [None, "seq", "hybrid"])
def test_enc_machine_switch_routes(monkeypatch, fn, geom, value):
    """``seq`` sends each of the four encode functions to B7's wrapper
    once a stream; unset or ``hybrid``, they run B1 (B4 for a batch) as
    before. The streams equal the reference's either way."""
    if value is None:
        monkeypatch.delenv(ENC, raising=False)
    else:
        monkeypatch.setenv(ENC, value)
    (c, h, w), ll = GEOMS[geom]
    arrs = np.stack([_arr((c, h, w), 10 * geom + b) for b in range(2)])
    seq = _spy(monkeypatch, encoder, "encode_machine_seq")
    b1 = _spy(monkeypatch, encoder, "encode_machine")
    b4 = _spy(monkeypatch, encoder, "encode_machine_batch")
    got = _encode_with(fn, arrs, ll)
    assert got == [spiht_tpu.encode(a, *ll, MAX_BITS) for a in arrs]
    batch = fn.startswith("pallas_encode_batch")
    if value == "seq":
        assert (len(seq), b1, b4) == (2, [], [])
    elif batch:
        assert (seq, b1, len(b4)) == ([], [], 1)
    else:
        assert (seq, len(b1), b4) == ([], 2, [])


DEC_FNS = ["pallas_decode", "pallas_decode_fn", "pallas_decode_batch",
           "pallas_decode_batch_fn"]


def _decode_with(fn, datas, mns, geo):
    """(B, c, h, w) rec of ``datas`` through one of the four ``pallas_*``
    decode functions, on the CPU."""
    if fn == "pallas_decode":
        return np.stack([decoder.pallas_decode(d, mn, *geo, device=CPU)
                         for d, mn in zip(datas, mns)])
    if fn == "pallas_decode_batch":
        return decoder.pallas_decode_batch(datas, mns, *geo, device=CPU)
    words, nbits = decoder.words_batch(datas, CPU)
    if fn == "pallas_decode_fn":
        f = decoder.pallas_decode_fn(*geo, words.shape[1], device=CPU)
        return np.stack([f(wd, nb, mn).numpy()
                         for wd, nb, mn in zip(words, nbits, mns)])
    f = decoder.pallas_decode_batch_fn(*geo, words.shape[1], device=CPU)
    return f(words, nbits, mns).numpy()


@pytest.mark.parametrize("geom", range(len(GEOMS)), ids=GEOM_IDS)
@pytest.mark.parametrize("fn", DEC_FNS)
@pytest.mark.parametrize("value", [None, "seq", "hybrid_hbm"])
def test_dec_machine_switch_routes(monkeypatch, fn, geom, value):
    """``seq`` sends each of the four decode functions to B3 (batched B3
    for a batch) in every geometry; unset or ``hybrid_hbm``, an even LL
    runs B2 (B5) and an odd LL B3, as before. The rec equals the
    reference's either way, on a full stream and a prefix."""
    if value is None:
        monkeypatch.delenv(DEC, raising=False)
    else:
        monkeypatch.setenv(DEC, value)
    (c, h, w), ll = GEOMS[geom]
    full = [spiht_tpu.encode(_arr((c, h, w), 20 + geom + b), *ll)
            for b in range(2)]
    datas = [full[0][0], full[1][0][: len(full[1][0]) // 2]]
    mns = [mn for _, mn in full]
    calls = {name: _spy(monkeypatch, decoder, name) for name in (
        "decode_seq", "decode_seq_batch", "decode_lsp", "decode_lsp_batch")}
    rec = _decode_with(fn, datas, mns, (c, h, w, *ll))
    want = np.stack([spiht_tpu.decode(d, mn, c, h, w, *ll)
                     for d, mn in zip(datas, mns)])
    np.testing.assert_array_equal(rec, want)
    batch = fn.startswith("pallas_decode_batch")
    seq = value == "seq" or decoder.has_duplicate_parents(h, w, *ll)
    name = ("decode_seq" if seq else "decode_lsp") + (
        "_batch" if batch else "")
    assert {k: len(v) for k, v in calls.items() if v} == {
        name: 1 if batch else 2}


@pytest.mark.parametrize("layout", ["compact", "compact_hbm"])
@pytest.mark.parametrize("how", ["env", "argument"])
def test_compact_refuses_max_n_past_15(monkeypatch, layout, how):
    """A compact layout with max_n > 15 raises ``MachineResourceLimit``
    in ``pallas_encode`` and ``pallas_encode_batch``, as the reference's
    ``pallas_encode`` does (before any Pallas call); at max_n <= 15 the
    port encodes as the reference's host codec does."""
    (c, h, w), ll = GEOMS[0]
    big = _arr((c, h, w), 3, spread=200_000)
    small = _arr((c, h, w), 4)
    machine = layout if how == "argument" else None
    if how == "env":
        monkeypatch.setenv(ENC, layout)
    assert spiht_tpu.encode(big, *ll)[1] > 15
    with pytest.raises(jpe.MachineResourceLimit, match="max_n"):
        jpe.pallas_encode(big, *ll, MAX_BITS, machine=machine)
    with pytest.raises(encoder.MachineResourceLimit, match="max_n"):
        encoder.pallas_encode(big, *ll, MAX_BITS, machine, device=CPU)
    with pytest.raises(encoder.MachineResourceLimit, match="max_n"):
        encoder.pallas_encode_batch(np.stack([small, big]), *ll, MAX_BITS,
                                    machine, device=CPU)
    assert encoder.pallas_encode(small, *ll, MAX_BITS, machine,
                                 device=CPU) == spiht_tpu.encode(
        small, *ll, MAX_BITS)


@pytest.mark.parametrize("value", ["sequential", "hybrid_hbm", "compact"])
@pytest.mark.parametrize("var", [ENC, DEC])
def test_unknown_machine_name_runs_seq(monkeypatch, var, value):
    """A switch set to a name its reference function does not know runs
    the sequential machine, as the reference's does: ``pallas_encode_fn``
    / ``pallas_decode_fn`` of the JAX package return their ``_seq_fn``
    (spied, so no Pallas call runs), and the port's ``pallas_encode`` /
    ``pallas_decode`` launch B7 / B3 once, with the reference's stream and
    rec. (``hybrid_hbm`` is a decode layout only, ``compact`` an encode
    one.)"""
    from spiht_tpu.codec import pallas_decoder as jpd

    known = {ENC: ("hybrid", "compact", "compact_hbm", "seq"),
             DEC: ("hybrid", "hybrid_hbm", "seq")}[var]
    monkeypatch.setenv(var, value)
    (c, h, w), ll = GEOMS[0]
    arr = _arr((c, h, w), 5)
    ref = jpe if var == ENC else jpd
    ref_seq = _spy(monkeypatch, ref, "_seq_fn")
    if var == ENC:
        jpe.pallas_encode_fn(c, h, w, *ll, 64)
        ours = _spy(monkeypatch, encoder, "encode_machine_seq")
        got = encoder.pallas_encode(arr, *ll, MAX_BITS, device=CPU)
        assert got == spiht_tpu.encode(arr, *ll, MAX_BITS)
    else:
        jpd.pallas_decode_fn(c, h, w, *ll, 64)
        ours = _spy(monkeypatch, decoder, "decode_seq")
        data, mn = spiht_tpu.encode(arr, *ll)
        rec = decoder.pallas_decode(data, mn, c, h, w, *ll, device=CPU)
        np.testing.assert_array_equal(
            rec, spiht_tpu.decode(data, mn, c, h, w, *ll))
    assert (len(ref_seq), len(ours)) == (
        (0, 0) if value in known else (1, 1))
