"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (the card
check is skipped: ``cell.run`` is called with ``device="cpu"``), with
one fault planted in the system under test where its answer is made:
an answer altered (a stream bit flipped as the encoder returns it, a
pixel moved as the decoder returns it), half of a batch left out (the
rest's answers handed back for it), and the program's own float32 path
in place of the float64 the configuration states (the control)."""

import dataclasses

import pytest
import torch

import spiht_tpu_torch
from benchmark import cell, spec
from benchmark.tests.helpers import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _flip(er):
    data = bytearray(er.encoded_bytes)
    data[len(data) // 2] ^= 0x10
    return dataclasses.replace(er, encoded_bytes=bytes(data))


def _wrap(monkeypatch, name, fix):
    real = getattr(spiht_tpu_torch, name)
    monkeypatch.setattr(spiht_tpu_torch, name,
                        lambda *a, **k: fix(real(*a, **k)))


def _run(name, **kw):
    return cell.run(tiny(name), 3, 0.3, False, "cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["enc_streams_off"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_stream_bit_flipped(name, monkeypatch):
    _wrap(monkeypatch, "encode_images_device", lambda ers: [_flip(e) for e in ers])
    _wrap(monkeypatch, "encode_image_device", _flip)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["enc_streams_off"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_decoded_pixel_moved(name, monkeypatch):
    def move(im):
        im = im.clone()
        im[0, 1, 2] += 1e-6
        return im

    _wrap(monkeypatch, "decode_images_device", lambda ims: [move(i) for i in ims])
    _wrap(monkeypatch, "decode_image_device", move)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["enc_streams_off"]["value"] == 0
    assert res["checks"]["dec_max_err"]["value"] > res["checks"][
        "dec_max_err"]["limit"]


def test_mixed_budgets_in_a_batch_are_correct():
    """A batch whose images each have their own budget (``bpp`` a list):
    each answer is checked at its own budget."""
    res = cell.run(tiny("kodak-batch-1bpp", bpp=[0.25, 1.0, 2.0]), 3, 0.3,
                   False, "cpu")
    assert res["correct"] and res["checks"]["enc_streams_off"]["value"] == 0


def test_half_of_the_batch_left_out(monkeypatch):
    """One slot of three answered with another's stream: every slot of
    the window's last batch is checked, so this is caught whatever
    rounds the seeded sample draws."""
    real = spiht_tpu_torch.encode_images_device

    def half(images, settings, level, budgets, *a, **k):
        n, m = len(images), (len(images) + 1) // 2
        got = real(images[:m], settings, level, budgets[:m], *a, **k)
        return (got + got)[:n]

    monkeypatch.setattr(spiht_tpu_torch, "encode_images_device", half)
    res = _run("kodak-batch-1bpp")
    assert not res["correct"]
    assert res["checks"]["enc_streams_off"]["value"] > 0


def test_a_raising_call_fails_the_run(monkeypatch):
    real, calls = spiht_tpu_torch.decode_image_device, []

    def boom(*a, **k):  # past the two warm-up round trips
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("planted")
        return real(*a, **k)

    monkeypatch.setattr(spiht_tpu_torch, "decode_image_device", boom)
    res = _run("kodak-single-1bpp")
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_float32_control_fails(name):
    """The control: the program's own float32 path, the precision below
    the configuration's float64, fails the comparison."""
    res = _run(name, dtype=torch.float32)
    assert not res["correct"]
    assert res["checks"]["dec_max_err"]["value"] > res["checks"][
        "dec_max_err"]["limit"]
