"""The port's four examples (spiht_tpu_torch.examples) run with ``--device
cpu`` on a seeded 3x64x64 PNG and pass their own checks;
``interop.as_numpy_image`` equals the JAX package's on numpy, torch and
JAX inputs."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from spiht_tpu import interop as jinterop

import spiht_tpu_torch as pt
from spiht_tpu_torch import interop, transform
from spiht_tpu_torch.codec import encoder
from spiht_tpu_torch.examples import (
    demonstrate,
    metadata_ml_consumer,
    on_device_codec,
    progressive_gif,
)
from spiht_tpu_torch.native import runtime as native
from spiht_tpu_torch.torch_transform import forward, inverse
from spiht_tpu_torch.utils import imload, imsave
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


@pytest.fixture()
def png(tmp_path, monkeypatch):
    # the progressive example's command line sets the backend module-wide
    monkeypatch.setattr(transform, "_BACKEND", transform._BACKEND)
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:64] / 9.0
    im = np.stack([0.5 + 0.3 * np.sin(xx + k) * np.cos(yy) for k in range(3)])
    path = tmp_path / "im.png"
    imsave(str(path), np.clip(im + 0.05 * rng.standard_normal(im.shape), 0, 1))
    return str(path)


def _geo(h, w, settings, level):
    slices, eh, ew = get_slices_and_h_w(h, w, settings, level)
    return slices, (3, eh, ew, slices[0][1].stop, slices[0][2].stop)


def test_demonstrate(png, tmp_path, capsys):
    """Each point's stream is the native scheduler's on the transform's
    coefficients, and its reconstruction the inverse of the native
    decode of that stream."""
    points = demonstrate.main([png, str(tmp_path / "out")] + CPU)
    stats = [st for st, _, _ in points]
    assert [s.bpp for s in stats] == pytest.approx([0.1, 0.5, 1.0], abs=0.01)
    psnrs = [s.psnr_db for s in stats]
    assert psnrs == sorted(psnrs) and np.isfinite(psnrs).all()
    for bpp in (0.1, 0.5, 1.0):
        assert (tmp_path / "out" / f"rec_{bpp}.png").exists()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [d["stream_bytes"] for d in lines] == [s.stream_bytes
                                                 for s in stats]
    nat = native.load()
    image = imload(png)
    slices, geo = _geo(64, 64, demonstrate.SETTINGS, None)
    arr = forward(torch.as_tensor(image), demonstrate.SETTINGS, None)[0]
    for (_, er, rec), bpp in zip(points, (0.1, 0.5, 1.0)):
        assert (er.encoded_bytes, er.max_n) == nat.encode(
            arr.numpy(), *geo[3:], round(bpp * 64 * 64))
        want = pt.decode_from_rec_arr(
            nat.decode(er.encoded_bytes, er.max_n, *geo), 64, 64, None,
            demonstrate.SETTINGS, slices, "cpu")[..., :64, :64]
        np.testing.assert_array_equal(rec, want)


def test_on_device_codec(png):
    """The stream is the native scheduler's on the float32 transform's
    coefficients, and the preview the inverse of its native decode."""
    out = on_device_codec.main([png, "0.5"] + CPU)
    assert 15 < out["psnr_db"] < 60
    s, lv = on_device_codec.SETTINGS, on_device_codec.LEVEL
    slices, geo = _geo(64, 64, s, lv)
    nat = native.load()
    arr = forward(torch.as_tensor(imload(png), dtype=torch.float32), s, lv,
                  torch.float32)[0]
    data = encoder.stream_bytes(out["words"], out["bits"])
    assert (data, out["max_n"]) == nat.encode(arr.numpy(), *geo[3:],
                                              round(0.5 * 64 * 64))
    want = inverse(torch.as_tensor(nat.decode(data, out["max_n"], *geo)),
                   64, 64, lv, s, torch.float32, True)
    assert out["rec"].dtype == torch.uint8 and torch.equal(out["rec"], want)


def test_metadata_ml_consumer(capsys):
    metadata_ml_consumer.main(CPU)  # raises SystemExit("MISMATCH") if not
    out = capsys.readouterr().out
    assert "row-exact vs host metadata decoder: True; rec exact: True" in out


def test_featurize_counts_the_trace():
    """The event log's per-action counts equal the expanded trace's."""
    from spiht_tpu_torch import SpihtSettings, encode_image
    from spiht_tpu_torch.codec.meta_expand import (
        decode_event_log, expand_event_log,
    )
    from spiht_tpu_torch.wavelets.geometry import (
        get_slices_and_h_w, slices_to_wire,
    )

    im = np.random.default_rng(1).random((3, 32, 32))
    er = encode_image(im, SpihtSettings(), 2, 3000, device="cpu")
    slices, eh, ew = get_slices_and_h_w(32, 32, SpihtSettings(), 2)
    ll = (slices[0][1].stop, slices[0][2].stop)
    _, log, words, nbits = decode_event_log(er.encoded_bytes, er.max_n, 3, eh,
                                            ew, *ll, "cpu")
    counts, ones, _ = metadata_ml_consumer.featurize(log, words, nbits)
    meta = expand_event_log(log, words, nbits, 3, eh, ew, *ll,
                            *slices_to_wire(slices)).numpy()
    written = (log[:nbits] != 0).numpy()
    assert counts.tolist() == [int(((meta[:nbits, 0] == a) & written).sum())
                               for a in range(7)]
    bits = np.unpackbits(np.frombuffer(er.encoded_bytes, np.uint8),
                         bitorder="little")[:nbits]
    assert int(ones) == int((bits[written] == 1).sum())


def _progressive_reference(png, out):
    """The GIF of ``cli progressive`` at the example's settings, built from
    the native scheduler's stream and its decodes of each prefix."""
    from spiht_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["progressive", png, out, "--frames", "40", "--bpp", "2.0"])
    s = cli._settings_from_args(args)
    image = imload(png)
    c, h, w = image.shape
    level = cli._level(args, h, w)
    slices, geo = _geo(h, w, s, level)
    nat = native.load()
    arr = forward(torch.as_tensor(image), s, level)[0]
    data, mn = nat.encode(arr.numpy(), *geo[3:], round(2.0 * h * w))
    frames = []
    for f in range(1, 41):
        nb = max(1, round(len(data) * f / 40))
        rec = pt.decode_from_rec_arr(nat.decode(data[:nb], mn, *geo), h, w,
                                     level, s, slices, "cpu")[..., :h, :w]
        a = (np.clip(rec, 0, 1) * 255).astype(np.uint8)
        frames.append(Image.fromarray(np.moveaxis(a, 0, -1)))
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=args.duration, loop=0)


def test_progressive_gif(png, tmp_path, capsys):
    out = tmp_path / "p.gif"
    assert progressive_gif.main([png, str(out)] + CPU) == 0
    assert f"wrote {out} (40 frames)" in capsys.readouterr().out
    with Image.open(out) as gif:  # PIL merges equal consecutive frames
        assert 1 < gif.n_frames <= 40
    _progressive_reference(png, str(tmp_path / "ref.gif"))
    assert out.read_bytes() == (tmp_path / "ref.gif").read_bytes()


@pytest.mark.parametrize("kind", ["numpy", "torch", "torch_grad", "jax"])
def test_as_numpy_image_equals_jax(kind):
    base = np.random.default_rng(4).random((3, 8, 6))
    make = {
        "numpy": lambda: base,
        "torch": lambda: torch.as_tensor(base),
        "torch_grad": lambda: torch.as_tensor(base).requires_grad_(True) * 1,
        "jax": lambda: jnp.asarray(base),
    }[kind]
    got, want = interop.as_numpy_image(make()), jinterop.as_numpy_image(make())
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base)
