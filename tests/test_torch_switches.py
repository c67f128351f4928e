"""The JAX package's documented switches in the port, on the CPU.

Each switch is read where the reference reads it (``docs/API.md``):

* ``SPIHT_TPU_PALLAS_ENC_BATCH`` / ``_DEC_BATCH`` (``ilv`` / ``map``) and
  ``SPIHT_TPU_PALLAS_ILV_B`` route the batch functions (``pallas_*_batch``,
  their ``_fn`` forms, ``encode_device_batch`` / ``decode_device_batch``)
  between one launch of B4 / B5 / batched B3, launches of at most
  ``ILV_B`` streams, and single launches of B1 (B7) / B2 (B3); the
  pipelines read ``ILV_B`` only, as the reference's do.
* ``SPIHT_TPU_DEVICE_ENCODER`` / ``_DEVICE_DECODER`` route the raw
  ``encode`` / ``decode`` / ``decode_with_metadata`` through the device
  codec, with the reference's conditions and fall-throughs.
* ``SPIHT_TPU_PALLAS`` routes the host-scheduled transform's quantize to
  B6 or to torch ops.
* ``SPIHT_TPU_NO_NATIVE`` schedules the host batch codec's bits in the
  oracle; ``SPIHT_TPU_CACHE`` names where the native library is built.

Every test spies on the kernels' wrappers (their plain versions run on
CPU tensors) and holds the outputs to the unset route's and to the JAX
package's host codec (``spiht_tpu.encode`` / ``decode``: the native
scheduler, bit-exact with its machines).
"""

import shutil

import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu.codec import api as japi
from spiht_tpu.codec import pallas_decoder as jpd
from spiht_tpu.codec import pallas_encoder as jpe

import spiht_tpu_torch as pt
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch import transform
from spiht_tpu_torch.codec import (
    api, decoder, device_bench, device_decoder, device_encoder, encoder,
    meta_expand, oracle,
)
from spiht_tpu_torch.native import runtime

torch.set_num_threads(1)

CPU = "cpu"
ENC_BATCH = "SPIHT_TPU_PALLAS_ENC_BATCH"
DEC_BATCH = "SPIHT_TPU_PALLAS_DEC_BATCH"
ILV_B = "SPIHT_TPU_PALLAS_ILV_B"
SWITCHES = (ENC_BATCH, DEC_BATCH, ILV_B, "SPIHT_TPU_PALLAS_ENC_MACHINE",
            "SPIHT_TPU_PALLAS_DEC_MACHINE", "SPIHT_TPU_PALLAS_ENCODER",
            "SPIHT_TPU_PALLAS_DECODER", "SPIHT_TPU_PALLAS_META",
            "SPIHT_TPU_DEVICE_ENCODER", "SPIHT_TPU_DEVICE_DECODER",
            "SPIHT_TPU_PALLAS", "SPIHT_TPU_NO_NATIVE", "SPIHT_TPU_CACHE",
            "SPIHT_TPU_BUDGET_TRANSFER")
# (c, h, w), (ll_h, ll_w): even LL (B4, B5) and odd LL (batched B3)
EVEN = ((1, 16, 16), (4, 4))
ODD = ((3, 12, 20), (3, 5))
MAX_BITS = 900
B = 3
WRAPPERS = {
    encoder: ("encode_machine", "encode_machine_seq", "encode_machine_batch"),
    decoder: ("decode_lsp", "decode_seq", "decode_lsp_batch",
              "decode_seq_batch", "decode_lsp_log", "decode_seq_log"),
    meta_expand: ("decode_lsp_log", "decode_seq_log"),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)


def _setenv(monkeypatch, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)


def _spies(monkeypatch):
    """Replace every kernel wrapper by one that counts its calls; returns
    a function giving the counts of the wrappers called."""
    calls = {}
    for module, names in WRAPPERS.items():
        for name in names:
            real = getattr(module, name)

            def spy(*a, _real=real, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **kw)

            monkeypatch.setattr(module, name, spy)
    return lambda: dict(calls)


def _arr(shape, seed, spread=400):
    return np.random.default_rng(seed).integers(
        -spread, spread, shape).astype(np.int32)


def _arrs(geom, seed=0):
    (c, h, w), _ = geom
    return np.stack([_arr((c, h, w), seed + b) for b in range(B)])


# ---------------------------------------------------------------------------
# SPIHT_TPU_PALLAS_ENC_BATCH and SPIHT_TPU_PALLAS_ILV_B: the encode batch
# ---------------------------------------------------------------------------

ENC_CASES = {  # env -> the launches of a batch of 3
    "unset": ({}, {"encode_machine_batch": 1}),
    "ilv": ({ENC_BATCH: "ilv"}, {"encode_machine_batch": 1}),
    "auto": ({ENC_BATCH: "auto"}, {"encode_machine_batch": 1}),
    "map": ({ENC_BATCH: "map"}, {"encode_machine": B}),
    "ilv_b_2": ({ILV_B: "2"}, {"encode_machine_batch": 2}),
    "ilv_b_0": ({ILV_B: "0"}, {"encode_machine_batch": B}),
    "ilv_b_past_batch": ({ILV_B: "16"}, {"encode_machine_batch": 1}),
    "ilv_b_garbage": ({ILV_B: "sixteen"}, {"encode_machine_batch": 1}),
    "ilv_and_ilv_b": ({ENC_BATCH: "ilv", ILV_B: "1"},
                      {"encode_machine_batch": B}),
}


def _encode_batch_with(fn, arrs, ll):
    """[(bytes, max_n)] of a batch through one of the encode batch
    routes, on the CPU."""
    if fn == "pallas_encode_batch":
        return encoder.pallas_encode_batch(arrs, *ll, MAX_BITS, device=CPU)
    if fn == "encode_device_batch":
        return device_encoder.encode_device_batch(arrs, *ll, MAX_BITS,
                                                  device=CPU)
    _, c, h, w = arrs.shape
    f = encoder.pallas_encode_batch_fn(
        c, h, w, *ll, encoder.cap_words_for(c, h, w, MAX_BITS), device=CPU)
    mns = [spiht_tpu.encode(a, *ll)[1] for a in arrs]
    words, totals, _ = f(arrs, mns, [MAX_BITS] * len(arrs))
    return list(zip(encoder.batch_stream_bytes(words, totals.tolist()), mns))


@pytest.mark.parametrize("case", list(ENC_CASES))
@pytest.mark.parametrize("fn", ["pallas_encode_batch",
                                "pallas_encode_batch_fn",
                                "encode_device_batch"])
def test_enc_batch_switches_route(monkeypatch, fn, case):
    """Unset, ``ilv`` and ``auto`` launch B4 once for the batch, ``map``
    B1 once a stream, ``ILV_B=k`` B4 once for every k streams (0 counts
    as 1, a value that does not parse as unset); the streams equal the
    reference's every time. ``encode_device_batch`` reaches the same
    route under ``SPIHT_TPU_PALLAS_ENCODER=1``."""
    env, want = ENC_CASES[case]
    _setenv(monkeypatch, env)
    if fn == "encode_device_batch":
        monkeypatch.setenv("SPIHT_TPU_PALLAS_ENCODER", "1")
    arrs = _arrs(EVEN)
    counts = _spies(monkeypatch)
    got = _encode_batch_with(fn, arrs, EVEN[1])
    assert got == [spiht_tpu.encode(a, *EVEN[1], MAX_BITS) for a in arrs]
    assert counts() == want


@pytest.mark.parametrize("fn", ["pallas_encode_batch",
                                "pallas_encode_batch_fn",
                                "encode_device_batch"])
def test_enc_batch_ilv_refuses_seq_before_any_launch(monkeypatch, fn):
    """``ENC_BATCH=ilv`` with the sequential machine raises
    ``MachineResourceLimit`` before any launch, as the reference's
    ``pallas_encode_batch`` does before any Pallas call; with ``map`` the
    batch runs B7 stream by stream."""
    _setenv(monkeypatch, {ENC_BATCH: "ilv",
                          "SPIHT_TPU_PALLAS_ENC_MACHINE": "seq",
                          "SPIHT_TPU_PALLAS_ENCODER": "1"})
    arrs = _arrs(EVEN, 7)
    with pytest.raises(jpe.MachineResourceLimit, match="ilv"):
        jpe.pallas_encode_batch(arrs, *EVEN[1], MAX_BITS)
    counts = _spies(monkeypatch)
    with pytest.raises(encoder.MachineResourceLimit, match="ilv"):
        _encode_batch_with(fn, arrs, EVEN[1])
    assert counts() == {}
    monkeypatch.setenv(ENC_BATCH, "map")
    got = _encode_batch_with(fn, arrs, EVEN[1])
    assert got == [spiht_tpu.encode(a, *EVEN[1], MAX_BITS) for a in arrs]
    assert counts() == {"encode_machine_seq": B}


# ---------------------------------------------------------------------------
# SPIHT_TPU_PALLAS_DEC_BATCH and SPIHT_TPU_PALLAS_ILV_B: the decode batch
# ---------------------------------------------------------------------------

DEC_CASES = {  # env -> (launches at even LL, at odd LL; None: refused)
    "unset": ({}, {"decode_lsp_batch": 1}, {"decode_seq_batch": 1}),
    "ilv": ({DEC_BATCH: "ilv"}, {"decode_lsp_batch": 1}, None),
    "map": ({DEC_BATCH: "map"}, {"decode_lsp": B}, {"decode_seq": B}),
    "ilv_b_2": ({ILV_B: "2"}, {"decode_lsp_batch": 2},
                {"decode_seq_batch": 2}),
    "ilv_b_0": ({ILV_B: "0"}, {"decode_lsp_batch": B},
                {"decode_seq_batch": B}),
    "ilv_b_garbage": ({ILV_B: "8x"}, {"decode_lsp_batch": 1},
                      {"decode_seq_batch": 1}),
}


def _streams(geom, seed):
    """B streams of ``geom``: two full, one cut to half its bytes."""
    (c, h, w), ll = geom
    full = [spiht_tpu.encode(_arr((c, h, w), seed + b), *ll)
            for b in range(B)]
    datas = [d for d, _ in full]
    datas[1] = datas[1][: len(datas[1]) // 2]
    return datas, [mn for _, mn in full]


def _decode_batch_with(fn, datas, mns, geo):
    if fn == "pallas_decode_batch":
        return decoder.pallas_decode_batch(datas, mns, *geo, device=CPU)
    if fn == "decode_device_batch":
        return device_decoder.decode_device_batch(datas, mns, *geo,
                                                  device=CPU)
    words, nbits = decoder.words_batch(datas, CPU)
    f = decoder.pallas_decode_batch_fn(*geo, words.shape[1], device=CPU)
    return f(words, nbits, mns).numpy()


@pytest.mark.parametrize("case", list(DEC_CASES))
@pytest.mark.parametrize("geom", [EVEN, ODD], ids=["even_ll", "odd_ll"])
@pytest.mark.parametrize("fn", ["pallas_decode_batch",
                                "pallas_decode_batch_fn",
                                "decode_device_batch"])
def test_dec_batch_switches_route(monkeypatch, fn, geom, case):
    """Unset, an even LL launches B5 once and an odd LL batched B3 once;
    ``ilv`` launches B5 and refuses an odd LL (duplicate parents) with
    ``MachineResourceLimit`` before any launch, as the reference's
    ``pallas_decode_batch`` does; ``map`` launches B2 (B3) once a stream;
    ``ILV_B=k`` one batched launch for every k streams. The rec equals
    the reference's every time, on full streams and a prefix."""
    env, want_even, want_odd = DEC_CASES[case]
    _setenv(monkeypatch, env)
    if fn == "decode_device_batch":
        monkeypatch.setenv("SPIHT_TPU_PALLAS_DECODER", "1")
    (c, h, w), ll = geom
    datas, mns = _streams(geom, 20)
    counts = _spies(monkeypatch)
    want = want_even if geom is EVEN else want_odd
    if want is None:
        with pytest.raises(jpd.MachineResourceLimit, match="ilv"):
            jpd.pallas_decode_batch(datas, mns, c, h, w, *ll)
        with pytest.raises(decoder.MachineResourceLimit, match="ilv"):
            _decode_batch_with(fn, datas, mns, (c, h, w, *ll))
        assert counts() == {}
        return
    rec = _decode_batch_with(fn, datas, mns, (c, h, w, *ll))
    np.testing.assert_array_equal(rec, np.stack([
        spiht_tpu.decode(d, mn, c, h, w, *ll) for d, mn in zip(datas, mns)]))
    assert counts() == want


def test_dec_batch_ilv_refuses_the_seq_machine(monkeypatch):
    """``DEC_BATCH=ilv`` takes B5 under the machines None and ``hybrid``
    only: ``seq`` is refused before any launch, as the reference's
    ``use_ilv`` refuses it."""
    _setenv(monkeypatch, {DEC_BATCH: "ilv",
                          "SPIHT_TPU_PALLAS_DEC_MACHINE": "seq"})
    (c, h, w), ll = EVEN
    datas, mns = _streams(EVEN, 30)
    counts = _spies(monkeypatch)
    with pytest.raises(decoder.MachineResourceLimit, match="ilv"):
        decoder.pallas_decode_batch(datas, mns, c, h, w, *ll, device=CPU)
    assert counts() == {}
    monkeypatch.setenv("SPIHT_TPU_PALLAS_DEC_MACHINE", "hybrid")
    rec = decoder.pallas_decode_batch(datas, mns, c, h, w, *ll, device=CPU)
    np.testing.assert_array_equal(rec, np.stack([
        spiht_tpu.decode(d, mn, c, h, w, *ll) for d, mn in zip(datas, mns)]))
    assert counts() == {"decode_lsp_batch": 1}


@pytest.mark.parametrize("ilv_b", [None, "2"])
def test_pipelines_read_ilv_b_only(monkeypatch, ilv_b):
    """The batch pipelines (``encode_images_device`` /
    ``decode_images_device``) read ``ILV_B``, as the reference's do, and
    not the batch switches: B4 and B5 once for 3 images unset, twice at
    ``ILV_B=2``, also under ``ENC_BATCH=map`` / ``DEC_BATCH=map``; the
    streams and images equal the single-image entry points'."""
    if ilv_b is not None:
        monkeypatch.setenv(ILV_B, ilv_b)
    _setenv(monkeypatch, {ENC_BATCH: "map", DEC_BATCH: "map"})
    rng = np.random.default_rng(5)
    ims = [rng.random((3, 36, 36)) for _ in range(B)]  # LL 12x12
    s = pt.SpihtSettings()
    counts = _spies(monkeypatch)
    ers = pt.encode_images_device(ims, s, 2, 2000, device=CPU)
    outs = pt.decode_images_device(ers, s, device=CPU)
    n = 1 if ilv_b is None else 2
    assert counts() == {"encode_machine_batch": n, "decode_lsp_batch": n}
    for im, er, out in zip(ims, ers, outs):
        one = pt.encode_image_device(im, s, 2, 2000, device=CPU)
        assert (one.encoded_bytes, one.max_n) == (er.encoded_bytes, er.max_n)
        assert torch.equal(pt.decode_image_device(er, s, device=CPU), out)


# ---------------------------------------------------------------------------
# SPIHT_TPU_DEVICE_ENCODER and SPIHT_TPU_DEVICE_DECODER: the raw API
# ---------------------------------------------------------------------------

DEV_ENC_CASES = {  # (env, geometry) -> (encode_device called, launches)
    "unset": ({}, EVEN, 0, {"encode_machine": 1}),
    "on_machine": ({"SPIHT_TPU_DEVICE_ENCODER": "1"}, EVEN, 1, {}),
    "on_kernel": ({"SPIHT_TPU_DEVICE_ENCODER": "1",
                   "SPIHT_TPU_PALLAS_ENCODER": "1"}, EVEN, 1,
                  {"encode_machine": 1}),
    "on_odd_ll": ({"SPIHT_TPU_DEVICE_ENCODER": "1"}, ODD, 0,
                  {"encode_machine": 1}),
    "not_1": ({"SPIHT_TPU_DEVICE_ENCODER": "true"}, EVEN, 0,
              {"encode_machine": 1}),
}


@pytest.mark.parametrize("case", list(DEV_ENC_CASES))
def test_device_encoder_switch(monkeypatch, case):
    """``SPIHT_TPU_DEVICE_ENCODER=1`` sends the raw ``encode`` of an
    even-LL array to ``device_encoder.encode_device`` (on CPU tensors the
    sorted-space machine, no kernel; under ``PALLAS_ENCODER=1`` B1); an
    odd LL, or any other value, keeps the default route (B1). The bytes
    equal the reference's every time."""
    env, geom, called, want = DEV_ENC_CASES[case]
    (c, h, w), ll = geom
    arr = _arr((c, h, w), 40)
    ref = spiht_tpu.encode(arr, *ll, MAX_BITS)
    _setenv(monkeypatch, env)
    dev_calls = []
    real = device_encoder.encode_device
    monkeypatch.setattr(device_encoder, "encode_device",
                        lambda *a: dev_calls.append(a) or real(*a))
    counts = _spies(monkeypatch)
    assert api.encode(arr, *ll, MAX_BITS, device=CPU) == ref
    assert (len(dev_calls), counts()) == (called, want)


def test_device_encoder_capacity_overflow_falls_through(monkeypatch):
    """A ``CapacityOverflow`` of the device encoder takes the default
    route (B1), as the reference's ``encode`` does."""
    (c, h, w), ll = EVEN
    arr = _arr((c, h, w), 41)
    ref = spiht_tpu.encode(arr, *ll, MAX_BITS)
    monkeypatch.setenv("SPIHT_TPU_DEVICE_ENCODER", "1")

    def overflow(*a):
        raise device_encoder.CapacityOverflow(10, 5)

    monkeypatch.setattr(device_encoder, "encode_device", overflow)
    counts = _spies(monkeypatch)
    assert api.encode(arr, *ll, MAX_BITS, device=CPU) == ref
    assert counts() == {"encode_machine": 1}


DEV_DEC_CASES = {  # env -> (decode_device calls, launches even / odd LL)
    "unset": ({}, 0, {"decode_lsp": 1}, {"decode_seq": 1}),
    "on_machine": ({"SPIHT_TPU_DEVICE_DECODER": "1"}, 1, {}, {}),
    "on_kernel": ({"SPIHT_TPU_DEVICE_DECODER": "1",
                   "SPIHT_TPU_PALLAS_DECODER": "1"}, 1, {"decode_lsp": 1},
                  {"decode_seq": 1}),
}


@pytest.mark.parametrize("case", list(DEV_DEC_CASES))
@pytest.mark.parametrize("geom", [EVEN, ODD], ids=["even_ll", "odd_ll"])
def test_device_decoder_switch(monkeypatch, geom, case):
    """``SPIHT_TPU_DEVICE_DECODER=1`` sends the raw ``decode`` to
    ``device_decoder.decode_device`` at every LL (on CPU tensors the
    hybrid machine; under ``PALLAS_DECODER=1`` B2 or B3); unset, B2 or
    B3. The rec equals the reference's on a prefix."""
    env, called, want_even, want_odd = DEV_DEC_CASES[case]
    (c, h, w), ll = geom
    data, mn = spiht_tpu.encode(_arr((c, h, w), 42), *ll)
    data = data[: 2 * len(data) // 3]
    ref = spiht_tpu.decode(data, mn, c, h, w, *ll)
    _setenv(monkeypatch, env)
    dev_calls = []
    real = device_decoder.decode_device
    monkeypatch.setattr(device_decoder, "decode_device",
                        lambda *a: dev_calls.append(a) or real(*a))
    counts = _spies(monkeypatch)
    np.testing.assert_array_equal(
        api.decode(data, mn, c, h, w, *ll, device=CPU), ref)
    assert (len(dev_calls), counts()) == (
        called, want_even if geom is EVEN else want_odd)


def test_device_decoder_value_error_falls_through(monkeypatch):
    """A ``ValueError`` of the device decoder (the reference's packed
    range) takes the default route (B2), as the reference's ``decode``
    does."""
    (c, h, w), ll = EVEN
    data, mn = spiht_tpu.encode(_arr((c, h, w), 43), *ll)
    ref = spiht_tpu.decode(data, mn, c, h, w, *ll)
    monkeypatch.setenv("SPIHT_TPU_DEVICE_DECODER", "1")

    def too_large(*a):
        raise ValueError("geometry too large for packed queue entries")

    monkeypatch.setattr(device_decoder, "decode_device", too_large)
    counts = _spies(monkeypatch)
    np.testing.assert_array_equal(
        api.decode(data, mn, c, h, w, *ll, device=CPU), ref)
    assert counts() == {"decode_lsp": 1}


@pytest.mark.parametrize("env,called,want", [
    ({}, 0, {"decode_lsp_log": 1}),
    ({"SPIHT_TPU_DEVICE_DECODER": "1"}, 1, {}),
    ({"SPIHT_TPU_DEVICE_DECODER": "1", "SPIHT_TPU_PALLAS_DECODER": "1"}, 1,
     {"decode_lsp_log": 1}),
], ids=["unset", "on_machine", "on_kernel"])
def test_device_decoder_switch_with_metadata(monkeypatch, env, called, want):
    """``SPIHT_TPU_DEVICE_DECODER=1`` sends ``decode_with_metadata`` to
    ``decode_device_with_metadata`` (on CPU tensors the sequential
    machine; under ``PALLAS_DECODER=1`` B2-log); rec and trace equal the
    reference's (a short stream: the machine takes ~1 ms a step here)."""
    (c, h, w), ll = EVEN
    data, mn = spiht_tpu.encode(_arr((c, h, w), 44), *ll, 160)
    wire = ([(0, 4), (0, 4)],
            [[[(4, 8), (0, 4)], [(0, 4), (4, 8)], [(4, 8), (4, 8)]],
             [[(8, 16), (0, 8)], [(0, 8), (8, 16)], [(8, 16), (8, 16)]]])
    jrec, jmeta = japi.decode_with_metadata(data, mn, c, h, w, *ll, *wire)
    _setenv(monkeypatch, env)
    dev_calls = []
    real = device_decoder.decode_device_with_metadata
    monkeypatch.setattr(device_decoder, "decode_device_with_metadata",
                        lambda *a: dev_calls.append(a) or real(*a))
    counts = _spies(monkeypatch)
    rec, meta = api.decode_with_metadata(data, mn, c, h, w, *ll, *wire,
                                         device=CPU)
    np.testing.assert_array_equal(rec, jrec)
    np.testing.assert_array_equal(meta, jmeta)
    assert (len(dev_calls), counts()) == (called, want)


# ---------------------------------------------------------------------------
# SPIHT_TPU_PALLAS: B6 in the host-scheduled transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,dtype,b6", [
    (None, torch.float32, 1), ("1", torch.float32, 1),
    ("0", torch.float32, 0), ("yes", torch.float32, 0),
    ("1", torch.float64, 0), (None, torch.float64, 0),
])
def test_pallas_switch_routes_b6(monkeypatch, value, dtype, b6):
    """``SPIHT_TPU_PALLAS``: set, "1" runs B6 (float32 only) and any other
    value the torch ops; unset, B6 on float32. ``forward_compact``'s
    outputs and ``encode_images``' streams (budget path off) equal the
    unset route's."""
    rng = np.random.default_rng(6)
    ims = [rng.random((3, 32, 32)) for _ in range(2)]
    s = pt.SpihtSettings(color_model="ipt",
                         per_channel_quant_scales=[100, 20, 20])
    monkeypatch.setenv("SPIHT_TPU_BUDGET_TRANSFER", "0")
    batch = torch.as_tensor(np.stack(ims))
    want16, want_ovf, *_ = tt.forward_compact(batch, s, 2, dtype)
    want = pt.encode_images(ims, s, 2, 3000, device=CPU, dtype=dtype,
                            backend="torch")
    if value is not None:
        monkeypatch.setenv("SPIHT_TPU_PALLAS", value)
    calls = []
    real = tt.quantize_compact
    monkeypatch.setattr(tt, "quantize_compact",
                        lambda *a: calls.append(1) or real(*a))
    arr16, ovf, *_ = tt.forward_compact(batch, s, 2, dtype)
    assert torch.equal(arr16, want16) and bool(ovf) == bool(want_ovf)
    got = pt.encode_images(ims, s, 2, 3000, device=CPU, dtype=dtype,
                           backend="torch")
    assert [(e.encoded_bytes, e.max_n) for e in got] == [
        (e.encoded_bytes, e.max_n) for e in want]
    assert len(calls) == 2 * b6


# ---------------------------------------------------------------------------
# SPIHT_TPU_NO_NATIVE and SPIHT_TPU_CACHE: the native scheduler
# ---------------------------------------------------------------------------


def _load_spy(monkeypatch):
    calls = []
    real = runtime.load
    monkeypatch.setattr(runtime, "load",
                        lambda: calls.append(1) or real())
    return calls


@pytest.mark.parametrize("backend", ["torch", "native", "numpy"])
@pytest.mark.parametrize("value", ["1", "0", ""])
def test_no_native_schedules_in_the_oracle(monkeypatch, value, backend):
    """``SPIHT_TPU_NO_NATIVE`` is a truthiness test, as the reference's:
    "1" and "0" send ``encode_images`` / ``decode_images`` to the oracle
    (no native call); "" keeps the native scheduler. Streams and images
    equal the native scheduler's under the same backend, where 'native'
    runs the numpy transforms as the JAX package's does (its inverse may
    differ from the C++ one in the last bit)."""
    rng = np.random.default_rng(7)
    ims = [rng.random((3, 32, 32)) for _ in range(2)]
    s = pt.SpihtSettings()
    monkeypatch.setattr(transform, "_BACKEND",
                        "numpy" if backend == "native" and value else backend)
    want = pt.encode_images(ims, s, 2, 3000, device=CPU)
    want_ims = pt.decode_images(want, s, device=CPU)
    monkeypatch.setattr(transform, "_BACKEND", backend)
    monkeypatch.setenv("SPIHT_TPU_NO_NATIVE", value)
    loads = _load_spy(monkeypatch)
    oracle_calls = []
    for name in ("encode_bits", "decode_bits"):
        real = getattr(oracle, name)
        monkeypatch.setattr(oracle, name, lambda *a, _r=real, _n=name: (
            oracle_calls.append(_n) or _r(*a)))
    got = pt.encode_images(ims, s, 2, 3000, device=CPU, backend=backend)
    got_ims = pt.decode_images(got, s, device=CPU)
    assert [(e.encoded_bytes, e.max_n) for e in got] == [
        (e.encoded_bytes, e.max_n) for e in want]
    for a, b in zip(got_ims, want_ims):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if value:
        assert loads == [] and sorted(oracle_calls) == (
            ["decode_bits"] * 2 + ["encode_bits"] * 2)
    else:
        assert loads and oracle_calls == []


def test_no_native_other_callers_raise_clearly(monkeypatch):
    """Under ``SPIHT_TPU_NO_NATIVE`` every caller without the oracle route
    (the bench's reference, the examples, ``load()`` itself) raises a
    ``RuntimeError`` that names the switch."""
    monkeypatch.setenv("SPIHT_TPU_NO_NATIVE", "1")
    assert runtime.disabled()
    with pytest.raises(RuntimeError, match="SPIHT_TPU_NO_NATIVE"):
        runtime.load()
    with pytest.raises(RuntimeError, match="SPIHT_TPU_NO_NATIVE"):
        device_bench._native()


def test_failed_native_build_still_raises(monkeypatch, tmp_path):
    """Without the switch, a native library that cannot be built raises
    in ``encode_images``: nothing falls back to the oracle on its own."""
    monkeypatch.setenv("SPIHT_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(runtime, "_LIB", None)

    def fail(so):
        raise RuntimeError("native kernel build failed:\nno g++")

    monkeypatch.setattr(runtime, "_build", fail)
    im = np.random.default_rng(8).random((3, 32, 32))
    with pytest.raises(RuntimeError, match="native kernel build failed"):
        pt.encode_images([im], pt.SpihtSettings(), 2, 3000, device=CPU)


def test_cache_names_the_native_build_directory(monkeypatch, tmp_path):
    """``SPIHT_TPU_CACHE`` puts the native library, under the port's own
    name, in that directory: ``load()`` builds it there (the build here
    copies the library already built) and loads it from there; one encode
    equals the reference's."""
    default = runtime._so_path()
    built = runtime.load()  # the default library, built if it is not
    cache = tmp_path / "cache"
    monkeypatch.setenv("SPIHT_TPU_CACHE", str(cache))
    assert runtime._so_path() == cache / default.name
    monkeypatch.setattr(runtime, "_LIB", None)
    builds = []

    def build(so):
        builds.append(so)
        so.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(default, so)

    monkeypatch.setattr(runtime, "_build", build)
    lib = runtime.load()
    assert builds == [cache / default.name] and lib is not built
    assert (cache / default.name).exists()
    arr = _arr((1, 16, 16), 45)
    assert lib.encode(arr, 4, 4, MAX_BITS) == spiht_tpu.encode(
        arr, 4, 4, MAX_BITS)
