"""Two edge inputs that the JAX package takes, through the port's entry
points, each held to its ``spiht_tpu`` namesake on the CPU, streams byte
for byte and max_n exactly:

* budgets of 0 and below: the host entries (``encode_image``, the raw
  ``encode``, ``encode_images``) never cut there, as the native scheduler
  tests the budget only after a bit is written
  (``spiht_tpu/native/spiht_kernel.cpp:287``, ``:449``); the device
  entries (``encode_image_device``, ``encode_images_device``) read a
  negative budget as 0, an empty stream. The CLI's ``--bpp 0`` is such a
  budget. (At an odd LL the JAX package's device entries hand the image
  to its host path, which gives the full stream; the port's device
  entries encode it on the device: the geometry here has an even LL.)
* an int32 coefficient of -2^31: its magnitude is the native
  scheduler's uint32 2^31 (``spiht_kernel.cpp:164-177``), so max_n is 31,
  in ``encoder.encode`` and ``encode_batch`` (against the native
  scheduler and the oracle) and on the device entries (against the
  oracle's stream: the JAX package's own device route gives another
  there); an image bright enough to overflow the quantizer gives such
  coefficients through ``encode_image`` and the device quantize."""

import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu import cli as jcli
from spiht_tpu import transform as jtr
from spiht_tpu.codec import oracle
from spiht_tpu.ops.bitpack import bits_to_bytes

import spiht_tpu_torch as pt
from spiht_tpu_torch import cli
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch import transform as ttr
from spiht_tpu_torch.codec import api, encoder

from helpers.reference_native import load as reference_native

torch.set_num_threads(1)

CPU = "cpu"
SHAPE = (3, 64, 80)  # default settings: LL 8x10 (even)
BUDGETS = (0, -1, -5)
FULL = 2**31 - 2


def _img(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).random(shape)


@pytest.fixture
def numpy_transforms(monkeypatch):
    """Both packages' host transforms on numpy (the reference's host path
    whose int32 cast gives -2^31 at overflow)."""
    monkeypatch.setattr(ttr, "_BACKEND", "numpy")
    monkeypatch.setattr(jtr, "_BACKEND", "numpy")


def _same(er, jer):
    assert (er.encoded_bytes, er.max_n) == (jer.encoded_bytes, jer.max_n)


@pytest.mark.parametrize("max_bits", BUDGETS)
def test_encode_image_takes_no_budget_at_zero_and_below(numpy_transforms,
                                                        max_bits):
    im = _img()
    er = pt.encode_image(im, max_bits=max_bits, device=CPU)
    _same(er, spiht_tpu.encode_image(im, max_bits=max_bits))
    assert er.encoded_bytes == pt.encode_image(im, device=CPU).encoded_bytes
    arr, ll_h, ll_w = ttr.forward_numpy(im, pt.SpihtSettings(), None)
    assert (api.encode(arr, ll_h, ll_w, max_bits, device=CPU)
            == spiht_tpu.encode(arr, ll_h, ll_w, max_bits))


@pytest.mark.parametrize("max_bits", BUDGETS)
def test_encode_image_device_is_empty_at_zero_and_below(max_bits):
    im = _img(1)
    er = pt.encode_image_device(im, max_bits=max_bits, device=CPU)
    _same(er, spiht_tpu.encode_image_device(im, max_bits=max_bits))
    assert er.encoded_bytes == b""


def test_encode_images_device_is_empty_at_zero_and_below():
    ims = [_img(2 + k) for k in range(3)]
    ers = pt.encode_images_device(ims, max_bits=list(BUDGETS), device=CPU)
    jers = spiht_tpu.encode_images_device(ims, max_bits=list(BUDGETS))
    for er, jer in zip(ers, jers):
        _same(er, jer)
        assert er.encoded_bytes == b""


def test_encode_images_takes_no_budget_at_zero_and_below(numpy_transforms):
    ims = [_img(5 + k) for k in range(3)]
    ers = pt.encode_images(ims, max_bits=list(BUDGETS), device=CPU)
    for er, jer in zip(ers, spiht_tpu.encode_images(ims,
                                                    max_bits=list(BUDGETS))):
        _same(er, jer)
        assert len(er.encoded_bytes) > 10000


@pytest.mark.parametrize("backend", ["native", "device"])
def test_cli_at_zero_bpp(tmp_path, capsys, monkeypatch, backend):
    """Both CLIs refuse ``--bpp 0``; a positive ``--bpp`` that rounds to
    a budget of 0 bits (``round(bpp * h * w)``) gives what the reference's
    gives: its host path the full stream, its device path an empty one."""
    from PIL import Image

    reference_native()
    monkeypatch.setattr(ttr, "_BACKEND", ttr._BACKEND)
    monkeypatch.setattr(jtr, "_BACKEND", jtr._BACKEND)
    png = tmp_path / "img.png"
    arr = (_img(9) * 255).astype(np.uint8)
    Image.fromarray(np.moveaxis(arr, 0, -1)).save(png)
    args = ["encode-decode", str(png), "--backend", backend]
    assert cli.main(args + ["--bpp", "0", "--device", "cpu"]) == 2
    assert jcli.main(args + ["--bpp", "0"]) == 2
    err = capsys.readouterr().err
    assert err.count("error: --bpp must be > 0") == 2
    assert round(1e-5 * 64 * 80) == 0
    assert cli.main(args + ["--bpp", "1e-5", "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(args + ["--bpp", "1e-5"]) == 0
    theirs = capsys.readouterr().out

    def sizes(text):
        return [ln.split(" in ")[0] for ln in text.splitlines()
                if ln.startswith("encoded")]

    assert sizes(ours) == sizes(theirs) and sizes(ours)
    assert (": 0 bytes" in sizes(ours)[0]) == (backend == "device")


def _overflow_array(seed=0):
    """Random ints in [-1000, 1000) at 3x32x32 (LL 4x4), one of them
    -2^31."""
    arr = np.random.default_rng(seed).integers(-1000, 1000, (3, 32, 32),
                                               dtype=np.int32)
    arr[0, 5, 7] = -(2**31)
    return arr


def test_minimum_int32_encodes_as_the_native_scheduler():
    arr = _overflow_array()
    nat = reference_native()
    want = nat.encode(arr, 4, 4, FULL)
    bits, omn = oracle.encode_bits(arr, 4, 4, FULL)
    assert want == (bits_to_bytes(bits), omn)
    assert want[1] == 31 and len(want[0]) == 4568
    assert encoder.encode(arr, 4, 4, device=CPU) == want
    for mb in (1, 100, 4000, 36000):
        assert encoder.encode(arr, 4, 4, mb, device=CPU) == nat.encode(
            arr, 4, 4, mb)
    got = encoder.encode_batch(np.stack([arr, -arr, arr]), 4, 4,
                               [FULL, FULL, 3000], device=CPU)
    assert got == [want, nat.encode(-arr, 4, 4, FULL),
                   nat.encode(arr, 4, 4, 3000)]
    # the magnitude's neighbours were right before: they stay so
    for v in (2**31 - 1, -(2**31) + 1):
        near = arr.copy()
        near[0, 5, 7] = v
        assert encoder.encode(near, 4, 4, device=CPU) == nat.encode(
            near, 4, 4, FULL)


def test_minimum_int32_tables_and_max_n():
    arr = torch.as_tensor(_overflow_array())
    t1, t3s = encoder.encode_tables(arr, 4, 4)
    at = 5 * 32 + 7
    assert int(t3s[at]) == 0 and int(t1[at]) & 63 == 32  # M + 1
    assert int(encoder.device_max_n(arr)) == 31
    both = torch.stack([arr, arr.clamp(min=-999)])
    assert encoder.device_max_n(both).tolist() == [31, 9]


def test_overflowed_image_encodes_as_the_reference(numpy_transforms):
    """An image scaled by 1e9 overflows the quantizer: the numpy cast and
    the port's device quantize give -2^31 there, and ``encode_image``
    (numpy and torch transforms) and the device entries give the
    reference's host stream, max_n 31."""
    im = _img(0) * 1e9
    jer = spiht_tpu.encode_image(im)
    assert jer.max_n == 31
    _same(pt.encode_image(im, device=CPU), jer)
    arr, _, _ = tt.forward(torch.as_tensor(im), pt.SpihtSettings())
    np.testing.assert_array_equal(
        arr.numpy(), jtr.forward_numpy(im, spiht_tpu.SpihtSettings(), None)[0])
    _same(pt.encode_image_device(im, device=CPU), jer)
    _same(pt.encode_images_device([im, im], device=CPU)[1], jer)
    ttr._BACKEND = "torch"
    _same(pt.encode_image(im, device=CPU), jer)


def test_device_quantize_gives_the_minimum_int32_out_of_range():
    x = torch.tensor([1.7, -1.7, 3e9, -3e9, float("nan"), 2.0**31 - 1,
                      -(2.0**31), -(2.0**31) - 0.5, 2.0**31, float("inf")],
                     dtype=torch.float64)
    for dt in (torch.float64, torch.float32):
        want = x.to(dt).numpy().astype(np.int32)
        np.testing.assert_array_equal(tt._quantize(x.to(dt)).numpy(), want)
