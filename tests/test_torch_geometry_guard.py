"""The port refuses the geometries the reference's native scheduler
refuses (``spiht_tpu/native/spiht_kernel.cpp:398-402``, ``:743-747``):
LL dims of 1, and a level-0 "pyramid" whose LL children lie past the
array. Every public entry point raises ``ValueError`` there, on the CPU
route (the kernels' plain versions and the fallback machines), before any
table is built: at level 0 the significance maps would otherwise fail
with an ``IndexError``. Where the JAX package's host path raises, it is
held to raise too; at level 0 its XLA route returns a stream, and the
port raises all the same. At LL 2x2 the port's streams equal the JAX
package's byte for byte.
"""

import numpy as np
import pytest
import torch

import spiht_tpu
import spiht_tpu_torch
from spiht_tpu_torch.codec import (
    api, decoder, device_decoder, device_encoder, encoder, meta_expand,
)
from spiht_tpu_torch import torch_transform

from helpers.reference_native import load as reference_native

torch.set_num_threads(1)

CPU = "cpu"
DATA = b"\xa5\x3c\xff\x00\x81\x7e\x11\xee"
MAX_N = 6

# (c, h, w), (ll_h, ll_w): the native scheduler refuses each
RAW = [((1, 8, 23), (1, 3)), ((1, 8, 23), (2, 1)), ((1, 8, 23), (1, 1)),
       ((3, 2, 40), (2, 40))]
RAW_IDS = ["ll1x3", "ll2x1", "ll1x1", "level0"]

# (c, h, w), settings, level: images whose packed geometry the native
# scheduler refuses (LL 1x3, 2x1, 1x1 and level 0)
IMAGES = [((1, 8, 21), dict(wavelet="db1", mode="zero"), 3),
          ((1, 24, 16), dict(wavelet="haar", mode="reflect"), None),
          ((3, 16, 16), dict(wavelet="haar", mode="smooth"), None),
          ((3, 2, 40), dict(), 0)]


@pytest.fixture(autouse=True)
def _reference_kernel():
    """The reference's native kernel is loaded: its host path must refuse
    through the native scheduler, not a numpy fallback that a half-written
    in-place build left behind (``helpers/reference_native.py``)."""
    reference_native()


def _arr(shape, seed=0):
    return np.random.default_rng(seed).integers(
        -300, 300, shape).astype(np.int32)


def _slices(c, h, w, ll_h, ll_w):
    """A wire-format slice pair; the guard fires before it is read."""
    top = [0, ll_h, ll_w]
    return top, [[ll_h, ll_w, 0, h - ll_h, w - ll_w]]


def _raw_calls(c, h, w, ll_h, ll_w):
    """Every raw-array entry point of the port at one geometry."""
    arr = _arr((c, h, w))
    arrs = np.stack([arr, arr])
    top, other = _slices(c, h, w, ll_h, ll_w)
    cw = 2
    g = (c, h, w, ll_h, ll_w)
    words = torch.zeros(cw, dtype=torch.int32)
    log = torch.zeros(8 * len(DATA) + 1, dtype=torch.int64)
    return {
        "api.encode": lambda: api.encode(arr, ll_h, ll_w, device=CPU),
        "api.encode_seq": lambda: api.encode(arr, ll_h, ll_w, device=CPU,
                                             machine="seq"),
        "api.decode": lambda: api.decode(DATA, MAX_N, *g, device=CPU),
        "api.decode_with_metadata": lambda: api.decode_with_metadata(
            DATA, MAX_N, *g, top, other, device=CPU),
        "encoder.encode_batch": lambda: encoder.encode_batch(
            arrs, ll_h, ll_w, device=CPU),
        "decoder.decode_batch": lambda: decoder.decode_batch(
            [DATA, DATA], MAX_N, *g, device=CPU),
        "pallas_encode": lambda: encoder.pallas_encode(
            arr, ll_h, ll_w, device=CPU),
        "pallas_encode_fn": lambda: encoder.pallas_encode_fn(
            *g, cw, device=CPU),
        "pallas_encode_batch": lambda: encoder.pallas_encode_batch(
            arrs, ll_h, ll_w, 1000, device=CPU),
        "pallas_encode_batch_fn": lambda: encoder.pallas_encode_batch_fn(
            *g, cw, device=CPU),
        "pallas_decode": lambda: decoder.pallas_decode(
            DATA, MAX_N, *g, device=CPU),
        "pallas_decode_fn": lambda: decoder.pallas_decode_fn(
            *g, cw, device=CPU),
        "pallas_decode_batch": lambda: decoder.pallas_decode_batch(
            [DATA, DATA], MAX_N, *g, device=CPU),
        "pallas_decode_batch_fn": lambda: decoder.pallas_decode_batch_fn(
            *g, cw, device=CPU),
        "encode_device": lambda: device_encoder.encode_device(
            arr, ll_h, ll_w, 1000, device=CPU),
        "encode_device_fn": lambda: device_encoder.encode_device_fn(*g),
        "encode_device_batch": lambda: device_encoder.encode_device_batch(
            arrs, ll_h, ll_w, 1000, device=CPU),
        "decode_device": lambda: device_decoder.decode_device(
            DATA, MAX_N, *g, device=CPU),
        "decode_device_fn": lambda: device_decoder.decode_device_fn(*g, cw),
        "decode_device_with_metadata":
            lambda: device_decoder.decode_device_with_metadata(
                DATA, MAX_N, *g, top, other, device=CPU),
        "decode_device_batch": lambda: device_decoder.decode_device_batch(
            [DATA, DATA], MAX_N, *g, device=CPU),
        "meta_expand.decode_event_log": lambda: meta_expand.decode_event_log(
            DATA, MAX_N, *g, CPU),
        "meta_expand.expand_event_log": lambda: meta_expand.expand_event_log(
            log, words, 8 * len(DATA), *g, top, other),
        "meta_expand.decode_with_metadata":
            lambda: meta_expand.decode_with_metadata(
                DATA, MAX_N, *g, top, other, CPU),
        "pallas_decode_with_metadata":
            lambda: meta_expand.pallas_decode_with_metadata(
                DATA, MAX_N, *g, top, other, device=CPU),
        "encoder.machine_args": lambda: encoder.machine_args(
            torch.as_tensor(arr), ll_h, ll_w, 1000),
        "decoder.machine_args": lambda: decoder.machine_args(
            words, 64, MAX_N, *g),
    }


RAW_ENTRIES = sorted(_raw_calls(1, 8, 24, 2, 2))


@pytest.mark.parametrize("entry", RAW_ENTRIES)
@pytest.mark.parametrize("geom", range(len(RAW)), ids=RAW_IDS)
@pytest.mark.parametrize("flag", ["0", "1"])
def test_raw_entry_points_refuse(geom, entry, flag, monkeypatch):
    """Each raw entry point raises ValueError, naming the native's rule,
    whichever route the SPIHT_TPU_PALLAS_* flags pick."""
    for name in ("SPIHT_TPU_PALLAS_ENCODER", "SPIHT_TPU_PALLAS_DECODER",
                 "SPIHT_TPU_PALLAS_META"):
        monkeypatch.setenv(name, flag)
    (c, h, w), (ll_h, ll_w) = RAW[geom]
    with pytest.raises(ValueError, match="ll dims must be > 1"):
        _raw_calls(c, h, w, ll_h, ll_w)[entry]()


@pytest.mark.parametrize("geom", range(len(RAW)), ids=RAW_IDS)
def test_reference_host_path_refuses_too(geom):
    """The JAX package's raw host path refuses each geometry the port
    refuses (its batch route with another message: the type is held)."""
    (c, h, w), (ll_h, ll_w) = RAW[geom]
    arr = _arr((c, h, w))
    with pytest.raises(ValueError):
        spiht_tpu.encode(arr, ll_h, ll_w)
    with pytest.raises(ValueError):
        spiht_tpu.decode(DATA, MAX_N, c, h, w, ll_h, ll_w)


@pytest.mark.parametrize("geom", range(len(RAW)), ids=RAW_IDS)
def test_fits_answer_false(geom):
    (c, h, w), (ll_h, ll_w) = RAW[geom]
    assert not encoder.machine_fits(c, h, w, ll_h, ll_w, 16)
    assert not encoder.interleaved_fits(4, c, h, w, ll_h, ll_w, 16)
    assert not decoder.machine_fits(c, h, w, ll_h, ll_w, 16)
    assert not decoder.interleaved_fits(4, c, h, w, ll_h, ll_w, 16)


def _image_case(i):
    (c, h, w), kw, level = IMAGES[i]
    im = np.random.default_rng(i).random((c, h, w))
    return (im, spiht_tpu.SpihtSettings(**kw),
            spiht_tpu_torch.SpihtSettings(**kw), level)


def _image_calls(im, s, level):
    c, h, w = im.shape
    er = spiht_tpu_torch.EncodingResult(DATA, h, w, c, MAX_N, level)
    t = torch.as_tensor(im)
    words = torch.zeros(2, dtype=torch.int32)
    return {
        "encode_image": lambda: api.encode_image(im, s, level, device=CPU),
        "decode_image": lambda: api.decode_image(er, s, device=CPU),
        "decode_image_metadata": lambda: api.decode_image(
            er, s, return_metadata=True, device=CPU),
        "encode_images": lambda: api.encode_images([im, im], s, level,
                                                   device=CPU),
        "decode_images": lambda: api.decode_images([er, er], s, device=CPU),
        "encode_image_device": lambda: api.encode_image_device(
            im, s, level, device=CPU),
        "decode_image_device": lambda: api.decode_image_device(
            er, s, device=CPU),
        "encode_images_device": lambda: api.encode_images_device(
            [im, im], s, level, device=CPU),
        "decode_images_device": lambda: api.decode_images_device(
            [er, er], s, device=CPU),
        "encode_pipeline_fn": lambda: torch_transform.encode_pipeline_fn(
            s, level)(t, 1000),
        "decode_pipeline_fn": lambda: torch_transform.decode_pipeline_fn(
            s, h, w, level, c)(words, 64, MAX_N),
    }


IMAGE_ENTRIES = sorted(_image_calls(np.zeros((1, 8, 8)),
                                    spiht_tpu_torch.SpihtSettings(), 1))


@pytest.mark.parametrize("entry", IMAGE_ENTRIES)
@pytest.mark.parametrize("case", range(len(IMAGES)), ids=RAW_IDS)
def test_image_entry_points_refuse(case, entry):
    im, _, s, level = _image_case(case)
    with pytest.raises(ValueError, match="ll dims must be > 1"):
        _image_calls(im, s, level)[entry]()


@pytest.mark.parametrize("case", range(len(IMAGES)), ids=RAW_IDS)
def test_reference_image_host_path_refuses_too(case):
    """The JAX package's host image path refuses the same images:
    ``encode_image``, ``encode_images`` and ``decode_image``."""
    im, js, _, level = _image_case(case)
    c, h, w = im.shape
    er = spiht_tpu.EncodingResult(DATA, h, w, c, MAX_N, level)
    with pytest.raises(ValueError):
        spiht_tpu.encode_image(im, js, level)
    with pytest.raises(ValueError):
        spiht_tpu.encode_images([im, im], js, level)
    with pytest.raises(ValueError):
        spiht_tpu.decode_image(er, js)


def test_level0_image_packs_to_the_refused_geometry():
    """The level-0 case is the geometry the native refuses: LL is the
    whole 2x40 array, so its parity children would lie past it."""
    _, _, s, _ = _image_case(3)
    slices, enc_h, enc_w = spiht_tpu_torch.get_slices_and_h_w(2, 40, s, 0)
    assert (enc_h, enc_w) == (2, 40)
    assert (slices[0][1].stop, slices[0][2].stop) == (2, 40)


@pytest.mark.parametrize("max_bits", [2**31 - 2, 300, 41])
def test_ll2x2_streams_equal_the_reference(max_bits):
    """LL 2x2 at 1x8x24 is the smallest LL the native takes: the port's
    streams (raw, pallas_* and batch) equal ``spiht_tpu.encode``'s byte
    for byte, and decode to its coefficients."""
    arr = _arr((1, 8, 24), seed=max_bits)
    want, wmn = spiht_tpu.encode(arr, 2, 2, max_bits)
    assert api.encode(arr, 2, 2, max_bits, device=CPU) == (want, wmn)
    assert encoder.pallas_encode(arr, 2, 2, max_bits, device=CPU) == (
        want, wmn)
    assert encoder.pallas_encode_batch(arr[None], 2, 2, max_bits,
                                       device=CPU) == [(want, wmn)]
    assert device_encoder.encode_device(arr, 2, 2, max_bits, device=CPU) \
        == (want, wmn)
    rec = spiht_tpu.decode(want, wmn, 1, 8, 24, 2, 2)
    np.testing.assert_array_equal(
        api.decode(want, wmn, 1, 8, 24, 2, 2, device=CPU), rec)
    np.testing.assert_array_equal(
        decoder.pallas_decode(want, wmn, 1, 8, 24, 2, 2, device=CPU), rec)


def test_size_limit_is_a_resource_limit():
    """Past c*h*w < 2^29 with a valid LL the pallas_* factories raise
    MachineResourceLimit (a RuntimeError, as in the reference) before any
    table is built; the guard itself raises ValueError."""
    g = (4, 16384, 8192, 256, 128)
    assert not encoder.machine_fits(*g)
    for make in (encoder.pallas_encode_fn, encoder.pallas_encode_batch_fn,
                 decoder.pallas_decode_fn, decoder.pallas_decode_batch_fn):
        with pytest.raises(encoder.MachineResourceLimit):
            make(*g, 1, device=CPU)
    assert issubclass(encoder.MachineResourceLimit, RuntimeError)
    with pytest.raises(ValueError, match="2\\^29"):
        encoder.check_geometry(*g)
