"""The host-scheduled batch codec's device steps and the standalone
transforms as programs a key (``torch_transform.compact_program``,
``plan_program`` + ``narrow_program``, ``forward_program``,
``inverse_program``) on the CPU, where a program runs its body eagerly on
its static buffers (on the card it replays a CUDA graph of the same body;
``chip_smoke.py`` phase 27 holds that to the eager body).

Held here: each program against its eager body (``forward_compact``,
``forward_plan`` / ``narrow``, ``forward``, ``inverse``) and the JAX
package's jitted programs (``_forward_compact_jit``, ``_forward_plan_jit``,
``_narrow_jit``, ``_forward_jit``, ``_inverse_jit``) at float64 and small
shapes, the inverse within the 1e-8 that XLA's fused multiply-adds take;
``encode_images`` / ``decode_images`` under the torch backend (standard
and budget paths) against the JAX package; a group past ``batch_bound``
in equal parts through one key; the entry points that route to the
programs and return fresh tensors; and no read back to the host in the
bodies."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spiht_tpu
from spiht_tpu import jax_transform as jjt

import spiht_tpu_torch as pt
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch import transform
from spiht_tpu_torch.codec.maxn import device_max_n

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
IPT = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
           quantization_scale=1.0)
SHAPE = (3, 36, 52)  # LL 12x16 at level 2: the planner's even LL


def _settings(kw):
    return pt.SpihtSettings(**kw), spiht_tpu.SpihtSettings(**kw)


def _images(seed, n, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.random(shape) for _ in range(n)]


def _kinds():
    return [p.key[0] for p in tt.programs()]


def test_forward_and_inverse_programs_equal_eager_and_jax():
    s, js = _settings(IPT)
    batch = np.stack(_images(1, 2))
    x = torch.as_tensor(batch)
    key = jjt._settings_key(js)
    for with_maps in (False, True):
        prog = tt.forward_program(s, x.shape, 2, F64, with_maps, x.dtype, CPU)
        got = prog(x)
        arr, ll_h, ll_w = tt.forward(x, s, 2, F64)
        assert prog.ll == (ll_h, ll_w) and torch.equal(got[0], arr)
        want = jjt._forward_jit(key, 2, with_maps, "float64")(
            jnp.asarray(batch))
        want = want if with_maps else (want,)
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    rec = got[0]
    inv = tt.inverse_program(s, rec.shape, *SHAPE[1:], 2, F64, False,
                             rec.dtype, CPU)
    (img,) = inv(rec)
    assert torch.equal(img, tt.inverse(rec, *SHAPE[1:], 2, s, F64))
    want = np.asarray(jjt._inverse_jit(key, *SHAPE[1:], 2, "float64")(
        jnp.asarray(rec.numpy())))
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_compact_program_equals_eager_and_jax(dtype, monkeypatch):
    """Both routes (B6's plain version at float32, the torch ops at
    float64) equal the eager body; at float64 also the JAX package's
    ``_forward_compact_jit`` (its XLA route on the CPU); an overflow
    comes back as the eager body's."""
    monkeypatch.delenv("SPIHT_TPU_PALLAS", raising=False)
    s, js = _settings(IPT)
    for scale in (1.0, 5e4):  # the second overflows int16
        s = pt.SpihtSettings(**dict(IPT, quantization_scale=scale))
        js = spiht_tpu.SpihtSettings(**dict(IPT, quantization_scale=scale))
        batch = np.stack(_images(2, 2))
        x = torch.as_tensor(batch)
        prog = tt.compact_program(s, x.shape, 2, dtype, x.dtype, CPU)
        assert prog.key[6] == ("b6" if dtype == torch.float32 else "torch")
        a16, ovf = prog(x)
        e16, eovf, _, _ = tt.forward_compact(x, s, 2, dtype)
        assert torch.equal(a16, e16) and bool(ovf) == bool(eovf)
        assert bool(ovf) == (scale > 1)
        if dtype == F64:
            j16, jovf = jjt._forward_compact_jit(
                jjt._settings_key(js), 2, "float64")(jnp.asarray(batch))
            np.testing.assert_array_equal(a16.numpy(), np.asarray(j16))
            assert bool(ovf) == bool(jovf)


def test_plan_and_narrow_programs_equal_eager_and_jax():
    s, js = _settings(IPT)
    batch = np.stack(_images(3, 3))
    x = torch.as_tensor(batch)
    plan = tt.plan_program(s, x.shape, 2, F64, x.dtype, CPU)
    arr, head = plan(x)
    earr, mx, counts, mnd, ll_h, ll_w = tt.forward_plan(x, s, 2, F64)
    assert torch.equal(arr, earr)
    assert torch.equal(head[:, 0], mx.long())
    assert torch.equal(head[:, 1], mnd.long())
    assert torch.equal(head[:, 2], device_max_n(earr).long())
    assert torch.equal(head[:, tt.PLAN_HEAD:], counts)
    key = jjt._settings_key(js)
    jarr, jmx, jcounts, jmnd = jjt._forward_plan_jit(
        key, 2, (ll_h, ll_w), "float64")(jnp.asarray(batch))
    np.testing.assert_array_equal(arr.numpy(), np.asarray(jarr))
    np.testing.assert_array_equal(head[:, 0].numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(head[:, 1].numpy(), np.asarray(jmnd))
    np.testing.assert_array_equal(head[:, tt.PLAN_HEAD:].numpy(),
                                  np.asarray(jcounts))
    shifts = np.array([0, 3, 7], np.int32)
    for out_dtype in (torch.int8, torch.int16):
        nar = tt.narrow_program(arr.shape, out_dtype, CPU)
        (hi,) = nar(arr, shifts=shifts)
        assert torch.equal(hi, tt.narrow(arr, torch.as_tensor(shifts),
                                         out_dtype))
        want = jjt._narrow_jit(str(out_dtype).split(".")[1])(
            jnp.asarray(arr.numpy()), jnp.asarray(shifts))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_bits,path", [(None, "compact"),
                                           (3000, "budget")])
def test_encode_and_decode_images_through_programs(max_bits, path,
                                                   monkeypatch):
    """Under the torch backend the streams equal the JAX package's
    ``encode_images`` and the images its ``decode_images`` (float64, two
    shape groups), through the programs of each group: the compact or
    the plan and narrow programs, then the inverse programs."""
    monkeypatch.setattr(transform, "_BACKEND", "torch")
    s, js = _settings(IPT)
    ims = _images(4, 2) + _images(5, 1, (3, 44, 52))
    tt.clear_programs()
    ers = pt.encode_images(ims, s, 2, max_bits, device=CPU)
    jers = spiht_tpu.encode_images(ims, js, 2, max_bits)
    assert [(e.encoded_bytes, e.max_n) for e in ers] == [
        (e.encoded_bytes, e.max_n) for e in jers]
    want = (["forward_compact"] * 2 if path == "compact"
            else ["forward_plan", "narrow", "forward_plan", "narrow"])
    assert _kinds() == want
    tt.clear_programs()
    imgs = pt.decode_images(ers, s, device=CPU)
    assert _kinds() == ["inverse", "inverse"]
    for g, w_ in zip(imgs, spiht_tpu.decode_images(jers, js)):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-8)


def test_overflow_part_runs_the_forward_program(monkeypatch):
    """A part whose coefficients pass int16 takes the forward program of
    its shape (the int32 transform), as the JAX package's standard path
    does."""
    monkeypatch.setattr(transform, "_BACKEND", "torch")
    monkeypatch.setenv("SPIHT_TPU_BUDGET_TRANSFER", "0")
    kw = dict(IPT, quantization_scale=5e4)
    s, js = _settings(kw)
    ims = _images(6, 2)
    tt.clear_programs()
    ers = pt.encode_images(ims, s, 2, None, device=CPU)
    assert _kinds() == ["forward_compact", "forward"]
    jers = spiht_tpu.encode_images(ims, js, 2, None)
    assert [(e.encoded_bytes, e.max_n) for e in ers] == [
        (e.encoded_bytes, e.max_n) for e in jers]


@pytest.mark.parametrize("max_bits", [None, 2500])
def test_group_past_the_bound_runs_in_equal_parts(max_bits, monkeypatch):
    """Five images with a bound of two run as three parts of two through
    one key a step (the last part padded), with the whole group's
    streams and images."""
    monkeypatch.setattr(transform, "_BACKEND", "torch")
    s, _ = _settings(IPT)
    ims = _images(7, 5)
    tt.clear_programs()
    whole = pt.encode_images(ims, s, 2, max_bits, device=CPU)
    whole_imgs = pt.decode_images(whole, s, device=CPU)
    cells = int(np.prod(SHAPE))
    monkeypatch.setattr(tt, "_memory_limit",
                        lambda dev: 2 * tt.BATCH_BYTES_PER_CELL * cells)
    assert tt.batch_bound(SHAPE, CPU) == 2
    tt.clear_programs()
    split = pt.encode_images(ims, s, 2, max_bits, device=CPU)
    imgs = pt.decode_images(split, s, device=CPU)
    assert [(e.encoded_bytes, e.max_n) for e in split] == [
        (e.encoded_bytes, e.max_n) for e in whole]
    assert all(np.array_equal(a, b) for a, b in zip(imgs, whole_imgs))
    progs = tt.programs()
    kinds = [p.key[0] for p in progs]
    assert kinds == (["forward_compact", "inverse"] if max_bits is None
                     else ["forward_plan", "narrow", "inverse"])
    assert all(p.statics["x"].shape[0] == 2 for p in progs)
    assert progs[-1].replays == 0  # the CPU runs the body: no graph


def test_entry_points_route_to_programs_and_return_fresh_tensors(
        monkeypatch):
    """``analysis_fn``, ``synthesis_fn``, ``forward_with_maps`` and the
    torch backend's ``transform.forward`` / ``inverse`` run one program
    a key; what they return is the caller's, not a program's buffer."""
    monkeypatch.setattr(transform, "_BACKEND", "torch")
    s, _ = _settings(IPT)
    x = torch.as_tensor(np.stack(_images(8, 2)))
    tt.clear_programs()
    ana = tt.analysis_fn(s, 2, with_maps=False)
    arr = ana(x)
    kept = arr.clone()
    arr.zero_()
    assert torch.equal(ana(x), kept) and _kinds() == ["forward"]
    arr4 = tt.analysis_fn(s, 2)(x)
    assert len(arr4) == 4 and torch.equal(arr4[0], kept)
    syn = tt.synthesis_fn(s, *SHAPE[1:], 2)
    img = syn(kept)
    assert torch.equal(img, tt.inverse(kept, *SHAPE[1:], 2, s))
    img.zero_()
    assert torch.equal(syn(kept), tt.inverse(kept, *SHAPE[1:], 2, s))
    arr1, maps, ll_h, ll_w = tt.forward_with_maps(x[0], s, 2)
    assert torch.equal(arr1, kept[0]) and len(maps) == 3
    assert (ll_h, ll_w) == (12, 16)
    tt.clear_programs()
    farr, fll_h, fll_w = transform.forward(x[1].numpy(), s, 2, CPU)
    assert torch.equal(farr, kept[1]) and (fll_h, fll_w) == (12, 16)
    fimg = transform.inverse(farr.numpy(), *SHAPE[1:], 2, s, device=CPU)
    assert torch.equal(fimg, tt.inverse(farr, *SHAPE[1:], 2, s))
    assert _kinds() == ["forward", "inverse"]


READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
         "aten::equal", "aten::allclose"}


def _reads(run):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name in READS:
                self.seen.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    with Reads() as reads:
        run()
    return reads.seen


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_bodies_read_no_value_back(dtype, monkeypatch):
    """The bodies of the compact (both routes), plan, narrow, forward
    (with the maps) and inverse programs read nothing back: each
    program's ``start`` (its puts and its run) dispatches no read."""
    monkeypatch.delenv("SPIHT_TPU_PALLAS", raising=False)
    s, _ = _settings(IPT)
    x = torch.as_tensor(np.stack(_images(9, 1)))
    progs = [
        (tt.compact_program(s, x.shape, 2, dtype, x.dtype, CPU), {}),
        (tt.plan_program(s, x.shape, 2, dtype, x.dtype, CPU), {}),
        (tt.forward_program(s, x.shape, 2, dtype, True, x.dtype, CPU), {}),
    ]
    arr = tt.forward(x, s, 2, dtype)[0]
    progs.append((tt.inverse_program(s, arr.shape, *SHAPE[1:], 2, dtype,
                                     False, arr.dtype, CPU), {}))
    progs.append((tt.narrow_program(arr.shape, torch.int16, CPU),
                  {"shifts": np.array([3], np.int32)}))
    for prog, named in progs:
        inp = arr if prog.key[0] in ("inverse", "narrow") else x
        with prog.lock:
            assert _reads(lambda: prog.start(inp, **named)) == [], prog.key[0]
            prog.fresh()
