"""The port's public batched codec on the CPU (the plain versions of its
kernels) against the JAX package's: ``encode_images_device`` byte for byte
and max_n for max_n, ``decode_images_device`` image for image; the
batched transform against the single-image one; and the API's edges
(mixed shapes, empty lists, budgets, no silent CPU run).

Decoded images are held exactly against the JAX package's own arithmetic:
its decoded coefficients through its inverse transform run op by op.
Its jitted ``decode_images_device`` is a few ulp from that (XLA fuses the
inverse's multiply-adds), so the port is held to it within ``JIT_ATOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spiht_tpu
import spiht_tpu_torch
from spiht_tpu import jax_transform
from spiht_tpu_torch import interop
from spiht_tpu_torch.codec import decoder
from spiht_tpu_torch.torch_transform import forward, inverse

from test_golden import _image

torch.set_num_threads(1)

RGB = dict()
IPT = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
           quantization_scale=1.0)
# a few ulp of images in [0, 1]: XLA's fused multiply-adds in the jitted
# JAX decode, and for IPT each library's float64 pow (XLA's and ATen's)
JIT_ATOL = 1e-12
POW_ATOL = 1e-12


def _pair(kw):
    return spiht_tpu.SpihtSettings(**kw), spiht_tpu_torch.SpihtSettings(**kw)


def _jax_image(er, js):
    """The JAX package's image of a stream, op by op: its host decoder's
    coefficients through its device inverse transform, not jitted."""
    rec = spiht_tpu.decode_rec_array(er, js)["rec_arr"]
    inv = jax_transform._inverse_jit(
        jax_transform._settings_key(js), er.h, er.w, er.level, "float64")
    return np.asarray(inv.__wrapped__(jnp.asarray(rec)))


def _same_results(et, ej):
    assert [e.encoded_bytes for e in et] == [e.encoded_bytes for e in ej]
    assert [(e.max_n, e.h, e.w, e.c, e.level) for e in et] == [
        (e.max_n, e.h, e.w, e.c, e.level) for e in ej]


@pytest.mark.parametrize("kw,atol", [(RGB, 0.0), (IPT, POW_ATOL)],
                         ids=["rgb", "ipt"])
def test_batch_round_trip_equals_jax(kw, atol):
    """The JAX package's own batch case (tests/test_device_encoder.py):
    per-image budgets, one past the full stream."""
    rng = np.random.default_rng(21)
    ims = [rng.random((3, 44, 60)) for _ in range(3)]
    mbs = [3000, 5000, 10**7]
    js, ts = _pair(kw)
    ej = spiht_tpu.encode_images_device(ims, js, level=2, max_bits=mbs)
    et = spiht_tpu_torch.encode_images_device(ims, ts, 2, mbs, device="cpu")
    _same_results(et, ej)
    yj = spiht_tpu.decode_images_device(ej, js)
    yt = spiht_tpu_torch.decode_images_device(et, ts, device="cpu")
    assert len(yt) == 3
    for a, b, e in zip(yt, yj, ej):
        assert isinstance(a, torch.Tensor) and a.shape == np.shape(b)
        np.testing.assert_allclose(a.numpy(), _jax_image(e, js), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=JIT_ATOL)


def test_odd_ll_and_wide_range_batch_equals_jax():
    """Batches the JAX API sends to its host encoder (odd LL; max_n > 15
    through a large quantization scale) are encoded by the port's batched
    machines, with the same bytes; odd-LL streams decode through batched
    B3."""
    js, ts = _pair(dict(wavelet="bior2.2", quantization_scale=3000))
    ims = [_image(s, (3, 64, 64)) for s in (31, 32)]
    ej = spiht_tpu.encode_images_device(ims, js, 6, [5000, 40])
    et = spiht_tpu_torch.encode_images_device(ims, ts, 6, [5000, 40],
                                              device="cpu")
    _same_results(et, ej)
    assert min(e.max_n for e in et) > 15
    assert decoder.has_duplicate_parents(89, 89, 5, 5)
    yt = spiht_tpu_torch.decode_images_device(et, ts, device="cpu")
    for a, e in zip(yt, ej):
        np.testing.assert_array_equal(a.numpy(), _jax_image(e, js))


def test_mixed_shapes_go_one_by_one():
    js, ts = _pair(RGB)
    ims = [_image(1, (3, 32, 32)), _image(2, (3, 40, 24)),
           _image(3, (3, 32, 32))]
    ej = spiht_tpu.encode_images_device(ims, js, 2, [900, 1500, 700])
    et = spiht_tpu_torch.encode_images_device(ims, ts, 2, [900, 1500, 700],
                                              device="cpu")
    _same_results(et, ej)
    yt = spiht_tpu_torch.decode_images_device(et, ts, device="cpu")
    for a, e in zip(yt, et):
        b = spiht_tpu_torch.decode_image_device(e, ts, device="cpu")
        assert torch.equal(a, b)


def test_budget_forms_and_empty_lists():
    js, ts = _pair(RGB)
    ims = [_image(s, (3, 24, 24)) for s in (4, 5)]
    for mb in (None, 777):
        ej = spiht_tpu.encode_images_device(ims, js, 2, mb)
        et = spiht_tpu_torch.encode_images_device(ims, ts, 2, mb,
                                                  device="cpu")
        _same_results(et, ej)
    assert spiht_tpu_torch.encode_images_device([], ts) == []
    assert spiht_tpu_torch.decode_images_device([], ts) == []
    with pytest.raises(ValueError, match="3 budgets for 2 images"):
        spiht_tpu_torch.encode_images_device(ims, ts, 2, [1, 2, 3],
                                             device="cpu")


def test_uint8_batch_output_and_prefix_streams():
    """Byte prefixes of different lengths in one batch, each decoded on
    its own length; as_uint8 as the single-image path gives it."""
    _, ts = _pair(RGB)
    ims = [_image(s, (3, 32, 32)) for s in (6, 7, 8)]
    full = spiht_tpu_torch.encode_images_device(ims, ts, 3, device="cpu")
    ers = [
        spiht_tpu_torch.EncodingResult(e.encoded_bytes[:cut], e.h, e.w, e.c,
                                       e.max_n, e.level)
        for e, cut in zip(full, (1, 7, None))
    ]
    ys = spiht_tpu_torch.decode_images_device(ers, ts, as_uint8=True,
                                              device="cpu")
    for y, e in zip(ys, ers):
        want = spiht_tpu_torch.decode_image_device(e, ts, as_uint8=True,
                                                   device="cpu")
        assert y.dtype == torch.uint8 and torch.equal(y, want)


@pytest.mark.parametrize("kw,level", [(IPT, None), (
    dict(wavelet="bior4.4", mode="symmetric", quantization_scale=50), 3)],
    ids=["ipt", "odd-ll"])
def test_batched_transform_equals_single(kw, level):
    ts = spiht_tpu_torch.SpihtSettings(**kw)
    ims = torch.as_tensor(np.stack([_image(s, (3, 40, 36)) for s in (9, 10)]))
    arr, ll_h, ll_w = forward(ims, ts, level)
    for b in range(2):
        one, lh, lw = forward(ims[b], ts, level)
        assert (lh, lw) == (ll_h, ll_w) and torch.equal(arr[b], one)
    back = inverse(arr, 40, 36, level, ts)
    for b in range(2):
        assert torch.equal(back[b], inverse(arr[b], 40, 36, level, ts))


def test_batch_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = spiht_tpu_torch.SpihtSettings()
    ims = [_image(1, (3, 24, 24))] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spiht_tpu_torch.encode_images_device(ims, ts, 2, 100)
    ers = spiht_tpu_torch.encode_images_device(ims, ts, 2, 100, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spiht_tpu_torch.decode_images_device(ers, ts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spiht_tpu_torch.codec.encoder.encode_batch(
            np.zeros((2, 1, 16, 16), np.int32), 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decoder.decode_batch([b"\x00"] * 2, 0, 1, 16, 16, 4, 4)


def test_batch_decode_rejects_other_stream_versions():
    ts = spiht_tpu_torch.SpihtSettings()
    er = spiht_tpu_torch.EncodingResult(b"", 8, 8, 1, 0, 1, "0.0.1")
    with pytest.raises(ValueError):
        spiht_tpu_torch.decode_images_device([er, er], ts, device="cpu")


def test_cross_decoding_a_jax_batch_through_interop():
    js, ts = _pair(RGB)
    ims = [_image(s, (3, 32, 32)) for s in (11, 12)]
    ej = spiht_tpu.encode_images_device(ims, js, 2, [1200, 2400])
    et = [interop.from_reference(e) for e in ej]
    yt = spiht_tpu_torch.decode_images_device(et, ts, device="cpu")
    for a, e in zip(yt, ej):
        np.testing.assert_array_equal(a.numpy(), _jax_image(e, js))
