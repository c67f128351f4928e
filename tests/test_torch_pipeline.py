"""The port's public single-image round trip on the CPU (the plain
versions of its kernels): the locked golden digests, equality with the JAX
package's on-device pipelines, cross-decoding through
``interop.from_reference``, and no silent CPU run without a card."""

import numpy as np
import pytest
import torch

import spiht_tpu
import spiht_tpu_torch
from spiht_tpu_torch import interop
from spiht_tpu_torch.codec import decoder, encoder

from test_golden import GOLDEN, _digest, _image

torch.set_num_threads(1)


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_golden_digests_through_port(case):
    seed, settings, level, max_bits, expect = GOLDEN[case]
    er = spiht_tpu_torch.encode_image_device(
        _image(seed), interop.from_reference(settings), level, max_bits,
        device="cpu",
    )
    assert _digest(er) == expect


RGB = dict()
IPT = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
           quantization_scale=1.0)


@pytest.mark.parametrize("kw,max_bits", [(RGB, 6000), (IPT, 9000)],
                         ids=["rgb", "ipt"])
def test_round_trip_equals_jax_device_pipelines(kw, max_bits):
    im = _image(11, (3, 48, 40))
    js = spiht_tpu.SpihtSettings(**kw)
    ts = spiht_tpu_torch.SpihtSettings(**kw)
    ej = spiht_tpu.encode_image_device(im, js, 3, max_bits)
    et = spiht_tpu_torch.encode_image_device(im, ts, 3, max_bits,
                                             device="cpu")
    assert et.encoded_bytes == ej.encoded_bytes
    assert (et.max_n, et.h, et.w, et.c, et.level) == (
        ej.max_n, ej.h, ej.w, ej.c, ej.level)
    yj = np.asarray(spiht_tpu.decode_image_device(ej, js))
    yt = spiht_tpu_torch.decode_image_device(et, ts, device="cpu").numpy()
    assert yt.shape == yj.shape
    # the JAX decode is one jitted program, where XLA may contract a
    # multiply-add into an FMA (and IPT adds each library's pow): a few
    # ulp apart
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)


def test_odd_ll_round_trip_equals_jax_host_path():
    """Odd LL (duplicate parents): the JAX on-device encoder has no CPU
    machine for it, so the port is held to the host path."""
    im = _image(12, (3, 64, 64))
    js = spiht_tpu.SpihtSettings(wavelet="bior2.2")
    ts = interop.from_reference(js)
    ej = spiht_tpu.encode_image(im, js, 6, 5000)
    et = spiht_tpu_torch.encode_image_device(im, ts, 6, 5000, device="cpu")
    assert decoder.has_duplicate_parents(89, 89, 5, 5)
    assert et.encoded_bytes == ej.encoded_bytes and et.max_n == ej.max_n
    yj = spiht_tpu.decode_image(ej, js)
    yt = spiht_tpu_torch.decode_image_device(et, ts, device="cpu").numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)


def test_cross_decoding_through_interop():
    im = _image(13, (3, 40, 40))
    js = spiht_tpu.SpihtSettings(wavelet="bior4.4", mode="symmetric")
    ts = interop.from_reference(js)
    assert ts == spiht_tpu_torch.SpihtSettings(wavelet="bior4.4",
                                               mode="symmetric")
    # JAX-encoded stream, embedded prefix included, decoded by the port
    ej = spiht_tpu.encode_image(im, js, 2, 4000)
    for cut in (len(ej.encoded_bytes), len(ej.encoded_bytes) // 4):
        ejc = spiht_tpu.EncodingResult(
            ej.encoded_bytes[:cut], ej.h, ej.w, ej.c, ej.max_n, ej.level)
        et = interop.from_reference(ejc)
        assert isinstance(et, spiht_tpu_torch.EncodingResult)
        yt = spiht_tpu_torch.decode_image_device(et, ts, device="cpu")
        yj = spiht_tpu.decode_image(ejc, js)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-12)
    # port-encoded stream decoded by the JAX package
    et = spiht_tpu_torch.encode_image_device(im, ts, 2, 4000, device="cpu")
    assert et.encoded_bytes == ej.encoded_bytes
    rec_j = spiht_tpu.decode_rec_array(et, js)["rec_arr"]
    words, nbits = decoder.words_tensor(et.encoded_bytes, "cpu")
    rec_t = decoder.decode_coeffs(words, nbits, et.max_n, 3, *rec_j.shape[1:],
                                  *_ll(ts, 40, 40, 2))
    np.testing.assert_array_equal(rec_t.numpy(), rec_j)


def _ll(settings, h, w, level):
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    return slices[0][1].stop, slices[0][2].stop


def test_from_reference_rejects_other_objects():
    with pytest.raises(TypeError):
        interop.from_reference(object())


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    im = _image(1)
    s = spiht_tpu_torch.SpihtSettings()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spiht_tpu_torch.encode_image_device(im, s, 3, 100)
    er = spiht_tpu_torch.encode_image_device(im, s, 3, 100, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spiht_tpu_torch.decode_image_device(er, s)
    arr = np.zeros((1, 16, 16), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encoder.encode(arr, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decoder.decode(b"\x00", 0, 1, 16, 16, 4, 4)


def test_decode_rejects_other_stream_versions():
    s = spiht_tpu_torch.SpihtSettings()
    er = spiht_tpu_torch.EncodingResult(b"", 8, 8, 1, 0, 1, "0.0.1")
    with pytest.raises(ValueError):
        spiht_tpu_torch.decode_image_device(er, s, device="cpu")
