"""The port's command line and metrics against the JAX package's, on a
3x64x80 PNG with ``--device cpu``: every subcommand runs; ``encode`` stream
files, ``batch`` stream files, ``decode`` images, ``plan`` JSON and
``sweep`` points equal ``spiht_tpu.cli``'s under the native backend;
``psnr``, ``bits_per_plane`` and ``encode_stats`` equal
``spiht_tpu.metrics``'; ``trace`` is a no-op without a directory."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from spiht_tpu import cli as jcli
from spiht_tpu import metrics as jmetrics
from spiht_tpu import transform as jtr
from spiht_tpu.settings import SpihtSettings as JSettings

import spiht_tpu_torch as pt
from spiht_tpu_torch import cli, metrics
from spiht_tpu_torch import transform as ttr

from helpers.reference_native import load as reference_native

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _keep_backends(monkeypatch):
    """The CLI sets the transform backend module-wide: put both back. The
    reference's native kernel is loaded, so that its 'native' backend
    does not fall back to numpy (``helpers/reference_native.py``)."""
    reference_native()
    monkeypatch.setattr(ttr, "_BACKEND", ttr._BACKEND)
    monkeypatch.setattr(jtr, "_BACKEND", jtr._BACKEND)


def _array(seed=0, shape=(3, 64, 80)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0: shape[1], 0: shape[2]].astype(np.float64)
    base = 0.5 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    im = np.stack([base * (0.5 + 0.5 * c / shape[0])
                   for c in range(shape[0])])
    im += 0.1 * rng.standard_normal(shape)
    return np.clip(im, 0.0, 1.0)


@pytest.fixture
def png(tmp_path):
    path = tmp_path / "img.png"
    arr = (_array() * 255).astype(np.uint8)
    Image.fromarray(np.moveaxis(arr, 0, -1)).save(path)
    return str(path)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("backend", ["native", "numpy", "torch", "jax",
                                     "device"])
def test_encode_decode(png, tmp_path, capsys, backend):
    out = tmp_path / f"rec_{backend}.png"
    assert cli.main(["encode-decode", png, "--backend", backend, "--stats",
                     "--out", str(out)] + CPU) == 0
    text = capsys.readouterr().out
    assert jcli.main(["encode-decode", png, "--backend", "native", "--stats"]
                     ) == 0
    jtext = capsys.readouterr().out
    # the same size, geometry, PSNR and bits-per-plane lines
    def stable(t):
        return [ln.split(" in ")[0] if ln.startswith("encoded") else ln
                for ln in t.splitlines()
                if not ln.startswith(("decoded", "{", "wrote"))]
    assert stable(text) == stable(jtext)
    st, jst = _json_lines(text)[0], _json_lines(jtext)[0]
    for k in ("encode_s", "mpps"):
        st.pop(k), jst.pop(k)
    assert st.pop("psnr_db") == pytest.approx(jst.pop("psnr_db"), abs=1e-9)
    assert st == jst
    assert Image.open(out).size == (80, 64)


@pytest.mark.parametrize("backend", ["native", "numpy", "torch"])
def test_encode_stream_file_equals_the_reference(png, tmp_path, capsys,
                                                 backend):
    ours, theirs = tmp_path / "a.spiht", tmp_path / "b.spiht"
    args = ["--bpp", "0.5", "--color-model", "ipt",
            "--per-channel-quant-scales", "100,20,20",
            "--quantization-scale", "1"]
    assert cli.main(["encode", png, str(ours), "--backend", backend]
                    + args + CPU) == 0
    assert jcli.main(["encode", png, str(theirs), "--backend", "native"]
                     + args) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    # decode both ways to PNG: the same pixels
    assert cli.main(["decode", str(ours), str(tmp_path / "a.png"),
                     "--backend", backend] + args + CPU) == 0
    assert jcli.main(["decode", str(theirs), str(tmp_path / "b.png"),
                      "--backend", "native"] + args) == 0
    a = np.asarray(Image.open(tmp_path / "a.png"))
    b = np.asarray(Image.open(tmp_path / "b.png"))
    np.testing.assert_array_equal(a, b)
    capsys.readouterr()


def test_decode_bad_stream_files(tmp_path, capsys):
    bad = tmp_path / "bad.spiht"
    bad.write_bytes(b"not json\n")
    assert cli.main(["decode", str(tmp_path / "none.spiht"), "x.png"]
                    + CPU) == 2
    assert cli.main(["decode", str(bad), "x.png"] + CPU) == 2
    assert cli.main(["encode", "x.png", "y.spiht", "--bpp", "0"] + CPU) == 2
    assert "error" in capsys.readouterr().err


def test_batch_equals_the_reference(png, tmp_path, capsys):
    second = tmp_path / "two.png"
    arr = (_array(1, (3, 48, 40)) * 255).astype(np.uint8)
    Image.fromarray(np.moveaxis(arr, 0, -1)).save(second)
    ims = [png, str(second), png]
    dirs = {}
    for name, main, backend in (("native", cli.main, "native"),
                                ("device", cli.main, "device"),
                                ("jax", jcli.main, "native")):
        dirs[name] = tmp_path / name
        extra = CPU if main is cli.main else []
        assert main(["batch", *ims, "--outdir", str(dirs[name]),
                     "--bpp", "0.7", "--backend", backend] + extra) == 0
    files = sorted(p.name for p in dirs["jax"].iterdir())
    assert files == ["img-1.spiht", "img.spiht", "two.spiht"]
    for name in ("native", "device"):
        for f in files:
            assert (dirs[name] / f).read_bytes() == (
                dirs["jax"] / f).read_bytes(), (name, f)
    capsys.readouterr()


def test_plan_equals_the_reference(png, capsys):
    assert cli.main(["plan", png, "--bpp", "0.3"] + CPU) == 0
    ours = _json_lines(capsys.readouterr().out)[0]
    assert jcli.main(["plan", png, "--bpp", "0.3"]) == 0
    theirs = _json_lines(capsys.readouterr().out)[0]
    assert ours == theirs
    assert ours["cut_plane"] >= 0


def test_sweep_equals_the_reference(png, capsys):
    bpps = ["--bpps", "0.1,0.25,1.0"]
    assert cli.main(["sweep", png, *bpps] + CPU) == 0
    ours = _json_lines(capsys.readouterr().out)
    assert jcli.main(["sweep", png, *bpps]) == 0
    theirs = _json_lines(capsys.readouterr().out)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a["stream_bytes"] == b["stream_bytes"]
        assert a["max_n"] == b["max_n"]
        assert a["psnr_db"] == pytest.approx(b["psnr_db"], abs=1e-9)


def test_sweep_points_are_prefixes(png, capsys):
    """run_sweep on an array: each stream a byte prefix of the last."""
    args = cli.build_parser().parse_args(
        ["sweep", "unused.png", "--bpps", "0.25,0.5,1.0"] + CPU)
    points = cli.run_sweep(_array(), args)
    full = points[-1][1].encoded_bytes
    for _, er, _ in points:
        assert full[: len(er.encoded_bytes)] == er.encoded_bytes
    capsys.readouterr()


def test_progressive(png, tmp_path, capsys):
    gif, coeff = tmp_path / "p.gif", tmp_path / "c.gif"
    assert cli.main(["progressive", png, str(gif), "--frames", "4",
                     "--coeff-out", str(coeff), "--annotate"] + CPU) == 0
    assert Image.open(gif).n_frames == 4
    assert Image.open(coeff).n_frames == 4
    # from a stream file, no re-encode
    stream = tmp_path / "s.spiht"
    assert cli.main(["encode", png, str(stream)] + CPU) == 0
    assert cli.main(["progressive", str(stream), str(gif), "--frames", "3"]
                    + CPU) == 0
    assert Image.open(gif).n_frames == 3
    capsys.readouterr()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_without_device_cpu(png, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["encode", png, str(tmp_path / "a.spiht")])


def test_metrics_equal_the_reference():
    im = _array(3)
    kw = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
              quantization_scale=1.0)
    er = pt.encode_image(im, pt.SpihtSettings(**kw), 3, 8000, device="cpu")
    rec = pt.decode_image(er, pt.SpihtSettings(**kw), device="cpu")
    assert metrics.psnr(im, rec) == jmetrics.psnr(im, rec)
    assert metrics.psnr(im, im) == float("inf")
    assert metrics.bits_per_plane(er, pt.SpihtSettings(**kw), device="cpu") \
        == jmetrics.bits_per_plane(er, JSettings(**kw))
    a = metrics.encode_stats(im, er, 0.01, rec, {"dwt": 0.5}).__dict__
    b = jmetrics.encode_stats(im, er, 0.02, rec, {"dwt": 0.5}).__dict__
    for d in (a, b):
        d.pop("encode_s"), d.pop("mpps")
    assert a == b


def test_stage_timer_and_trace(tmp_path):
    timer = metrics.StageTimer()
    for _ in range(2):
        with timer.stage("dwt"):
            pass
    assert timer.counts == {"dwt": 2} and "dwt" in timer.pretty()
    assert set(timer.report()) == {"dwt"}
    with metrics.trace(None):
        x = torch.ones(3) + 1
    with metrics.trace(""):
        pass
    assert not any(tmp_path.iterdir())
    with metrics.trace(str(tmp_path / "t")):
        x = x * 2
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]
