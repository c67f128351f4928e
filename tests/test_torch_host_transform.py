"""The port's host transform backends and the API routes that choose
between them, against the JAX package on the CPU: the four host transform
functions exactly (the same numpy code and the same C++), the
``get_backend`` mapping, ``encode_image`` / ``decode_image`` under each
backend byte for byte against ``spiht_tpu`` under its counterpart, and
``encode_images`` / ``decode_images`` under 'native' and 'numpy'."""

import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu import transform as jtr
from spiht_tpu.settings import SpihtSettings as JSettings

import spiht_tpu_torch as pt
from spiht_tpu_torch import transform as ttr
from spiht_tpu_torch.codec import api

from helpers.reference_native import load as reference_native

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reference_kernel():
    """The reference's native kernel is loaded: its 'native' backend must
    not fall back to numpy (``helpers/reference_native.py``)."""
    reference_native()

SETTINGS = {
    "rgb": dict(),
    "ipt": dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
                quantization_scale=1.0),
    "lab": dict(wavelet="bior4.4", mode="symmetric", color_model="lab",
                quantization_scale=2.0),
}
# the counterpart of each of the port's backends in the JAX package
COUNTERPART = {"numpy": "numpy", "native": "native", "torch": "jax"}


def _img(seed, shape=(3, 40, 44)):
    return np.random.default_rng(seed).random(shape)


@pytest.fixture
def backends(monkeypatch):
    """Sets both packages' backends for one test and puts them back."""
    def set_(port_backend):
        monkeypatch.setattr(ttr, "_BACKEND", port_backend)
        monkeypatch.setattr(jtr, "_BACKEND", COUNTERPART[port_backend])

    return set_


@pytest.mark.parametrize("name", sorted(SETTINGS))
@pytest.mark.parametrize("level", [None, 2])
def test_host_transforms_equal_the_reference(name, level):
    kw = SETTINGS[name]
    x = _img(len(name) + (level or 0))
    ts, js = pt.SpihtSettings(**kw), JSettings(**kw)
    for fwd in ("forward_numpy", "forward_native"):
        a, lh, lw = getattr(ttr, fwd)(x, ts, level)
        b, jh, jw = getattr(jtr, fwd)(x, js, level)
        assert (lh, lw) == (jh, jw)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    h, w = x.shape[-2:]
    for inv in ("inverse_numpy", "inverse_native"):
        np.testing.assert_array_equal(getattr(ttr, inv)(a, h, w, level, ts),
                                      getattr(jtr, inv)(a, h, w, level, js))


def test_native_runs_numpy_where_the_kernel_cannot():
    """Periodization and level 0 take the numpy path in both packages."""
    x = _img(5, (3, 32, 48))
    for kw, level in ((dict(wavelet="db2", mode="periodization"), 2),
                      (dict(), 0)):
        a, *_ = ttr.forward_native(x, pt.SpihtSettings(**kw), level)
        b, *_ = jtr.forward_native(x, JSettings(**kw), level)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, ttr.forward_numpy(x, pt.SpihtSettings(**kw), level)[0])


def test_get_backend_mapping(monkeypatch):
    for value, want in (("numpy", "numpy"), ("native", "native"),
                        ("torch", "torch"), ("jax", "torch"),
                        ("auto", "torch")):
        monkeypatch.setattr(ttr, "_BACKEND", value)
        assert ttr.get_backend() == want


def test_torch_backend_returns_tensors_on_the_device(backends):
    backends("torch")
    x = _img(6)
    s = pt.SpihtSettings(**SETTINGS["ipt"])
    arr, lh, lw = ttr.forward(x, s, 3, device="cpu")
    assert isinstance(arr, torch.Tensor) and arr.dtype == torch.int32
    backends("numpy")
    np.testing.assert_array_equal(arr.numpy(), ttr.forward(x, s, 3)[0])
    backends("torch")
    rec = ttr.inverse(arr, 40, 44, 3, s, device="cpu")
    assert isinstance(rec, torch.Tensor) and rec.shape[-3] == 3


@pytest.mark.parametrize("backend", ["numpy", "native", "torch"])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_encode_decode_image_equal_the_reference(backends, backend, name):
    backends(backend)
    kw = SETTINGS[name]
    x = _img(20 + len(name))
    level = None if name == "ipt" else 3
    er = pt.encode_image(x, pt.SpihtSettings(**kw), level, 6000,
                         device="cpu")
    jer = spiht_tpu.encode_image(x, JSettings(**kw), level, 6000)
    assert er.encoded_bytes == jer.encoded_bytes
    assert (er.max_n, er.h, er.w, er.c, er.level) == (
        jer.max_n, jer.h, jer.w, jer.c, jer.level)
    img = pt.decode_image(er, pt.SpihtSettings(**kw), device="cpu")
    jimg = np.asarray(spiht_tpu.decode_image(jer, JSettings(**kw)))
    assert isinstance(img, np.ndarray) and img.shape == jimg.shape
    # numpy and native: the same code, exactly; torch against the jitted
    # JAX inverse, which may contract multiply-adds into FMAs
    np.testing.assert_allclose(img, jimg, rtol=0,
                               atol=0 if backend != "torch" else 1e-12)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_encode_decode_images_equal_the_reference(backends, backend):
    backends(backend)
    kw = SETTINGS["ipt"]
    rng = np.random.default_rng(9)
    ims = [rng.random((3, 36, 52)) for _ in range(3)] + [
        rng.random((3, 48, 40)) for _ in range(2)]
    mbs = [3000, None, 900, 5000, 2**62]
    ers = pt.encode_images(ims, pt.SpihtSettings(**kw), 2, mbs, device="cpu")
    jers = spiht_tpu.encode_images(ims, JSettings(**kw), 2, mbs)
    assert [e.encoded_bytes for e in ers] == [e.encoded_bytes for e in jers]
    assert [e.max_n for e in ers] == [e.max_n for e in jers]
    imgs = pt.decode_images(ers, pt.SpihtSettings(**kw), device="cpu")
    jimgs = spiht_tpu.decode_images(jers, JSettings(**kw))
    for a, b in zip(imgs, jimgs):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_budget_transfer_switch(monkeypatch, backends):
    """SPIHT_TPU_BUDGET_TRANSFER=0 skips the budget-narrowed path under
    'torch'; the streams are the same either way."""
    backends("torch")
    ims = [_img(30 + b, (3, 32, 32)) for b in range(3)]
    s = pt.SpihtSettings()
    called = []
    real = api._encode_images_budget
    monkeypatch.setattr(api, "_encode_images_budget",
                        lambda *a: called.append(1) or real(*a))
    a = pt.encode_images(ims, s, 2, 2000, device="cpu")
    assert called == [1]
    monkeypatch.setenv("SPIHT_TPU_BUDGET_TRANSFER", "0")
    b = pt.encode_images(ims, s, 2, 2000, device="cpu")
    assert called == [1]
    assert [e.encoded_bytes for e in a] == [e.encoded_bytes for e in b]


def test_decode_from_rec_arr_routes_by_backend(backends):
    kw = SETTINGS["lab"]
    x = _img(11)
    backends("native")
    er = pt.encode_image(x, pt.SpihtSettings(**kw), 2, device="cpu")
    d = pt.decode_rec_array(er, pt.SpihtSettings(**kw), device="cpu")
    outs = {}
    for b in ("numpy", "native", "torch"):
        backends(b)
        outs[b] = pt.decode_from_rec_arr(
            d["rec_arr"], d["h"], d["w"], d["level"], pt.SpihtSettings(**kw),
            device="cpu")
        assert isinstance(outs[b], np.ndarray)
    # three implementations of one inverse (numpy, C++, torch): equal to
    # a few ulp, as the JAX package's numpy and native inverses are
    for b in ("native", "torch"):
        np.testing.assert_allclose(outs[b], outs["numpy"], rtol=0,
                                   atol=1e-12)


def test_validate_rejects_nan(monkeypatch, backends):
    backends("native")
    x = _img(12)
    x[1, 3, 4] = np.nan
    s = pt.SpihtSettings()
    pt.encode_image(x, s, 2, 1000, device="cpu")  # opt-in: no check
    monkeypatch.setenv("SPIHT_TPU_VALIDATE", "1")
    for fn in (lambda: pt.encode_image(x, s, 2, 1000, device="cpu"),
               lambda: pt.encode_images([x], s, 2, 1000, device="cpu")):
        with pytest.raises(ValueError, match="NaN/Inf"):
            fn()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("backend", ["numpy", "native", "torch"])
def test_no_card_raises_under_every_backend(backends, backend):
    backends(backend)
    x = _img(13, (3, 32, 32))
    s = pt.SpihtSettings()
    er = pt.encode_image(x, s, 2, 1000, device="cpu")
    for fn in (lambda: pt.encode_image(x, s, 2, 1000),
               lambda: pt.decode_image(er, s),
               lambda: pt.encode_images([x], s, 2, 1000),
               lambda: pt.decode_images([er], s),
               lambda: ttr.forward(x, s, 2) if backend == "torch"
               else pt.decode_from_rec_arr(np.zeros((3, 32, 32), np.int32),
                                           32, 32, 2, s)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
