"""The program cache of ``torch_transform`` on the CPU through the
single-image round trip: ``encode_image_device`` and
``decode_image_device`` run the batch programs (``encode_batch_program``
/ ``decode_batch_program``) at B = 1, a program a key. On the CPU a
program runs its body eagerly on its static buffers (on the card it
replays a CUDA graph of the same body; ``chip_smoke.py`` phase 25 holds
that to the eager body).

Held here: the key (one program a key, another when any field changes),
equality with the JAX package's ``encode_image_device`` and with the
port's single-stream eager bodies (``encode_pipeline_eager`` /
``decode_pipeline_eager``, which share no code with the batch route's
launches), several budgets and stream lengths through one key (a stale
tail in the word buffer changes nothing), images that stay as they were
returned, eviction at the count and memory bounds, threads that take
turns through one key, no tensor made from numpy on a key's second call,
and a single call and a batch call of one image through one program."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import spiht_tpu
import spiht_tpu_torch as pt
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch.codec import decoder, encoder, geom, maps, maxn
from spiht_tpu_torch.color import torch_models
from spiht_tpu_torch.wavelets import dwt

from test_golden import _image

torch.set_num_threads(1)

CPU = torch.device("cpu")
FULL = 2**31 - 2
SHAPE = (3, 64, 80)
# A-like (even LL 12x14 at level None: B2) and B-like (odd LL 15x17 at
# level 3: B3), the settings of chip_smoke.py's configurations A and B
A = dict(wavelet="bior2.2", mode="reflect", color_model="ipt",
         per_channel_quant_scales=[100, 20, 20], quantization_scale=1.0)
B = dict(wavelet="bior4.4", mode="symmetric")
CASES = {"A": (A, None), "B": (B, 3)}


def _case(name):
    kw, level = CASES[name]
    return pt.SpihtSettings(**kw), spiht_tpu.SpihtSettings(**kw), level


def _eager_encode(im, s, level, max_bits):
    fn = tt.encode_pipeline_eager(s, level)
    words, stat, max_n = fn(torch.as_tensor(im), max_bits)
    total = encoder.check_stat(stat, "spiht_encode")[0]
    return encoder.stream_bytes(words, total), int(max_n)


def _eager_decode(data, max_n, s, level, shape=SHAPE):
    c, h, w = shape
    words, nbits = decoder.words_tensor(data, CPU)
    return tt.decode_pipeline_eager(s, h, w, level, c)(words, nbits, max_n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_routes(case):
    s, _, level = _case(case)
    slices, eh, ew = pt.get_slices_and_h_w(SHAPE[1], SHAPE[2], s, level)
    odd = decoder.has_duplicate_parents(eh, ew, slices[0][1].stop,
                                        slices[0][2].stop)
    assert odd == (case == "B")
    prog = tt.decode_batch_program(s, *SHAPE[1:], level, SHAPE[0], 1,
                                   device=CPU)
    assert prog.kernel == ("spiht_decode_seq_batch" if odd
                           else "spiht_decode_lsp_batch")
    assert prog.key[10:12] == ("map", None)  # B2 or B3 a stream


ENC_FIELDS = {  # field -> encode_batch_program keyword arguments
    "settings": dict(settings=pt.SpihtSettings(quantization_scale=40.0)),
    "c": dict(shape=(1, 1, 64, 80)),
    "h": dict(shape=(1, 3, 72, 80)),
    "w": dict(shape=(1, 3, 64, 88)),
    "level": dict(level=2),
    "dtype": dict(dtype=torch.float32),
    "in_dtype": dict(in_dtype=torch.uint8),
    "bucket": dict(max_bits=5000),
}


@pytest.mark.parametrize("field", sorted(ENC_FIELDS))
def test_encode_key(field):
    """The same key gives the same program; changing one field of it
    gives another."""
    base = dict(settings=pt.SpihtSettings(), shape=(1,) + SHAPE, level=3,
                dtype=torch.float64, in_dtype=torch.float64, device=CPU,
                max_bits=1100)
    p = tt.encode_batch_program(**base)
    assert tt.encode_batch_program(**base) is p
    # one bucket
    assert tt.encode_batch_program(**dict(base, max_bits=1900)) is p
    assert CPU in p.key and p.bucket == 64
    q = tt.encode_batch_program(**dict(base, **ENC_FIELDS[field]))
    assert q is not p and q.key != p.key


DEC_FIELDS = {
    "settings": dict(settings=pt.SpihtSettings(wavelet="bior4.4")),
    "c": dict(c=1),
    "h": dict(h=72),
    "w": dict(w=88),
    "level": dict(level=2),
    "dtype": dict(dtype=torch.float32),
    "as_uint8": dict(as_uint8=True),
    "bucket": dict(nbits=5000),
}


@pytest.mark.parametrize("field", sorted(DEC_FIELDS))
def test_decode_key(field):
    base = dict(settings=pt.SpihtSettings(), h=64, w=80, level=3, c=3, B=1,
                dtype=torch.float64, as_uint8=False, device=CPU,
                nbits=1100)
    p = tt.decode_batch_program(**base)
    assert tt.decode_batch_program(**base) is p
    # one bucket
    assert tt.decode_batch_program(**dict(base, nbits=1900)) is p
    assert CPU in p.key and p.bucket == 64
    q = tt.decode_batch_program(**dict(base, **DEC_FIELDS[field]))
    assert q is not p and q.key != p.key


@pytest.mark.parametrize("max_bits", [3000, None])
@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_jax_package(case, max_bits):
    """Streams equal ``spiht_tpu.encode_image_device`` (x64; at odd LL it
    takes its host path) byte for byte. Images equal the port's eager
    body exactly, and are within 1e-8 of the JAX package's jitted decode:
    XLA contracts the inverse transform's multiply-adds into fused
    multiply-adds, which the port's op-by-op arithmetic does not (ROADMAP
    Queue C, "Not faults")."""
    s, js, level = _case(case)
    im = _image(31, SHAPE)
    ej = spiht_tpu.encode_image_device(im, js, level, max_bits)
    et = pt.encode_image_device(im, s, level, max_bits, device=CPU)
    assert (et.encoded_bytes, et.max_n) == (ej.encoded_bytes, ej.max_n)
    got = pt.decode_image_device(et, s, device=CPU)
    assert torch.equal(got, _eager_decode(et.encoded_bytes, et.max_n, s,
                                          level))
    want = np.asarray(spiht_tpu.decode_image_device(ej, js))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_budgets_through_one_key(case):
    """Budgets that share a bucket share the program and give different
    streams, each its eager body's (``encode_pipeline_fn`` returns the
    words, stat and max_n that the eager body returns, fresh tensors on
    the device); the full stream's program takes every budget."""
    s, _, level = _case(case)
    im = _image(32, SHAPE)
    fn = tt.encode_pipeline_fn(s, level, device=CPU)
    body = tt.encode_pipeline_eager(s, level)
    one = (1,) + SHAPE
    p = tt.encode_batch_program(s, one, level, device=CPU, max_bits=1100)
    assert tt.encode_batch_program(s, one, level, device=CPU,
                                   max_bits=1900) is p
    streams, outs = [], []
    for mb in (1100, 1900):
        got = fn(im, mb)
        want = body(torch.as_tensor(im), mb)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        ((data, max_n),) = p([im], [mb])
        assert (data, max_n) == _eager_encode(im, s, level, mb)
        total = int(got[1][0])
        assert total <= mb and len(data) == (total + 7) // 8
        streams.append(data)
        outs.append(got)
    assert streams[0] != streams[1]
    # the first call's tensors are the caller's: the second left them be
    assert torch.equal(outs[0][0], body(torch.as_tensor(im), 1100)[0])
    full = tt.encode_batch_program(s, one, level, device=CPU)
    for mb in (1, 700, 4000, FULL):
        assert full([im], [mb]) == [_eager_encode(im, s, level, mb)]
    with pytest.raises(ValueError, match="does not fit"):
        p([im], [5000])


@pytest.mark.parametrize("case", sorted(CASES))
def test_longer_then_shorter_stream_through_one_key(case):
    """A shorter stream after a longer one in the same word buffer decodes
    as its eager body does: the buffer's tail past it is zeroed."""
    s, _, level = _case(case)
    er = pt.encode_image_device(_image(33, SHAPE), s, level, 4000,
                                device=CPU)
    data = er.encoded_bytes
    short = data[: len(data) * 3 // 4 + 1]
    p = tt.decode_batch_program(s, *SHAPE[1:], level, SHAPE[0], 1,
                                device=CPU, nbits=len(data) * 8)
    assert tt.decode_batch_program(s, *SHAPE[1:], level, SHAPE[0], 1,
                                   device=CPU, nbits=len(short) * 8) is p
    for d in (data, short, data, short[:5]):
        (got,) = p([d], [len(d) * 8], [er.max_n])
        assert torch.equal(got, _eager_decode(d, er.max_n, s, level))
    # words as a tensor, nbits the exact bit count of a budget cut
    e2 = pt.encode_image_device(_image(33, SHAPE), s, level, 2999,
                                device=CPU)
    words, _ = decoder.words_tensor(e2.encoded_bytes, CPU)
    got = tt.decode_pipeline_fn(s, *SHAPE[1:], level, SHAPE[0])(
        words, 2999, e2.max_n)
    want = tt.decode_pipeline_eager(s, *SHAPE[1:], level, SHAPE[0])(
        words, 2999, e2.max_n)
    assert torch.equal(got, want)


def test_returned_image_stays_as_it_was():
    s, _, level = _case("A")
    er = pt.encode_image_device(_image(34, SHAPE), s, level, 4000,
                                device=CPU)
    first = pt.decode_image_device(er, s, device=CPU)
    kept = first.clone()
    data = er.encoded_bytes
    cut = pt.EncodingResult(data[: len(data) * 3 // 4], *SHAPE[1:],
                            SHAPE[0], er.max_n, level)
    p = tt.decode_batch_program(s, *SHAPE[1:], level, SHAPE[0], 1,
                                device=CPU, nbits=len(data) * 8)
    assert tt.decode_batch_program(s, *SHAPE[1:], level, SHAPE[0], 1,
                                   device=CPU,
                                   nbits=len(cut.encoded_bytes) * 8) is p
    second = pt.decode_image_device(cut, s, device=CPU)
    assert not torch.equal(second, kept)
    assert torch.equal(first, kept)


def test_machine_error_raises_after_the_run(monkeypatch):
    """A machine error (here the LSP's capacity, narrowed to 1) raises at
    the stat read after the run, as ``check_stat`` does, and no image
    comes back."""
    s, _, level = _case("A")
    er = pt.encode_image_device(_image(35, SHAPE), s, level, 4000,
                                device=CPU)
    real = decoder.machine_caps
    monkeypatch.setattr(decoder, "machine_caps",
                        lambda *a: real(*a)[:2] + (1,))
    tt.clear_programs()
    try:
        with pytest.raises(RuntimeError, match="LSP outgrew its capacity"):
            pt.decode_image_device(er, s, device=CPU)
    finally:
        tt.clear_programs()


def test_eviction_at_the_count_bound(monkeypatch):
    monkeypatch.setattr(tt, "PROGRAM_LIMIT", 3)
    s = pt.SpihtSettings(quantization_scale=33.0)
    progs = [tt.encode_batch_program(s, (1, 3, 32, 32 + 8 * i), 2,
                                     device=CPU)
             for i in range(4)]
    held = tt.programs()
    assert len(held) == 3 and held == progs[1:]
    assert progs[0] not in held
    again = tt.encode_batch_program(s, (1, 3, 32, 32), 2, device=CPU)
    assert again is not progs[0] and tt.programs() == progs[2:] + [again]
    tt.clear_programs()
    assert tt.programs() == []


def test_eviction_at_the_memory_share(monkeypatch):
    """Programs on a device go, least recently used first, while they hold
    the memory share or more: after a capture (called here as a capture
    calls it: the CPU captures nothing), never the program just captured,
    and before a new program is made."""
    tt.clear_programs()
    monkeypatch.setattr(tt, "_memory_limit", lambda dev: 2500)
    s = pt.SpihtSettings(quantization_scale=35.0)

    def make(i):
        p = tt.encode_batch_program(s, (1, 3, 32, 32 + 8 * i), 2,
                                    device=CPU)
        p.pool_bytes = 1000 - p.static_bytes  # 1000 bytes a program
        return p

    p0, p1, p2 = make(0), make(1), make(2)
    assert tt.programs() == [p0, p1, p2]  # 2000 held before p2 was made
    with tt._LOCK:
        tt._evict(CPU, keep=p2)  # p2's capture took them to 3000
    assert tt.programs() == [p1, p2]
    p2.pool_bytes += 2000  # p2 alone past the share
    with tt._LOCK:
        tt._evict(CPU, keep=p2)
    assert tt.programs() == [p2]
    p3 = make(3)
    assert tt.programs() == [p3]
    tt.clear_programs()


def test_threads_through_one_key_take_turns(monkeypatch):
    """Threads that encode and decode different images through one key
    each get their own image's stream and image: a call holds its
    program from the copy into the static buffers to its read (each copy
    is followed by a pause here, in which another thread's call would
    overwrite the buffer if it could)."""
    put = tt._Program._put

    def slow_put(self, name, value):
        put(self, name, value)
        time.sleep(0.002)

    monkeypatch.setattr(tt._Program, "_put", slow_put)
    tt.clear_programs()
    s, _, level = _case("A")
    ims = [_image(40 + i, SHAPE) for i in range(4)]
    wants = [_eager_encode(im, s, level, 3000) for im in ims]
    got, errors = {}, []

    def work(i):
        try:
            for _ in range(3):
                er = pt.encode_image_device(ims[i], s, level, 3000,
                                            device=CPU)
                img = pt.decode_image_device(er, s, device=CPU)
                got[i] = (er.encoded_bytes, er.max_n), img
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len([p for p in tt.programs()
                if p.key[0] == "encode_batch"]) == 1
    for i, want in enumerate(wants):
        assert got[i][0] == want
        assert torch.equal(got[i][1], _eager_decode(*want, s, level))
    tt.clear_programs()


# the pipeline's modules before (encode) and after (decode) the machines
PIPELINE_MODULES = {m.__name__ for m in (tt, dwt, torch_models, maps, maxn,
                                         geom)}
CONSTANTS = (dwt._ext_index, dwt._ext_sign, dwt._ramp,
             dwt._antireflect_index, torch_models._const_vec,
             tt._const_mults, maps._ll_child_index, maxn._thresholds_on,
             geom._machine_tables)


@pytest.mark.parametrize("case", sorted(CASES))
def test_second_call_makes_no_tensor_from_numpy(case, monkeypatch):
    """The constants of the pipeline (index maps, scales, thresholds,
    tables) are made on the first call of a key and read from their
    caches after: a second call calls ``torch.as_tensor`` or
    ``torch.tensor`` nowhere in the transform, colour, maps, max_n or
    geometry modules."""
    s, _, level = _case(case)
    im = _image(36, SHAPE)
    calls = []
    for name in ("as_tensor", "tensor"):
        real = getattr(torch, name)

        def spy(*a, _real=real, **kw):
            mod = sys._getframe(1).f_globals.get("__name__")
            if mod in PIPELINE_MODULES:
                calls.append(mod)
            return _real(*a, **kw)

        monkeypatch.setattr(torch, name, spy)
    tt.clear_programs()
    for f in CONSTANTS:
        f.cache_clear()

    def round_trip():
        er = pt.encode_image_device(im, s, level, 3000, device=CPU)
        return er, pt.decode_image_device(er, s, device=CPU)

    er, img = round_trip()
    assert calls  # the first call made the constants
    calls.clear()
    er2, img2 = round_trip()
    assert calls == []
    assert er2.encoded_bytes == er.encoded_bytes and torch.equal(img2, img)


# reads of a value back to the host: on the card each is a sync, which a
# CUDA graph cannot capture
READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
         "aten::equal", "aten::allclose"}
# the plain versions of the kernels, which stand in for them on the CPU
PLAIN = {"_encode_machine_plain", "_decode_machine_plain"}


def _reads_of_round_trip(s, level, shape, dtype=torch.float64):
    """The reads back that a warm encode and decode program of ``shape``
    make in ``start`` (the run, up to the stat read)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name in READS:
                f, plain = sys._getframe(1), False
                while f is not None and not plain:
                    plain = f.f_code.co_name in PLAIN
                    f = f.f_back
                if not plain:
                    self.seen.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    im = _image(37, shape)
    ep = tt.encode_batch_program(s, (1,) + shape, level, dtype, device=CPU,
                                 max_bits=3000)
    ((data, max_n),) = ep([im], [3000])
    dp = tt.decode_batch_program(s, *shape[1:], level, shape[0], 1, dtype,
                                 device=CPU, nbits=len(data) * 8)
    dp([data], [len(data) * 8], [max_n])
    with Reads() as reads:
        ep.start([im], [3000])
        dp.start([data], [len(data) * 8], [max_n])
    assert ep.finish() == [(data, max_n)]
    return reads.seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_bodies_read_no_value_back(case):
    """The programs' bodies, around the machines, read nothing back: no
    ``.item()``, no 0-d tensor used as an index, no data-dependent shape
    (on the CPU the plain machines, which stand in for the kernels, read
    their scalars)."""
    s, _, level = _case(case)
    assert _reads_of_round_trip(s, level, SHAPE) == []


@pytest.mark.parametrize("model", sorted(torch_models.REFERENCE_MODELS))
def test_colour_models_read_no_value_back(model):
    """Every colour model, both ways, in float64 and float32, as
    ``chip_smoke.py`` phase 19 runs them through the programs."""
    s = pt.SpihtSettings(color_model=model)
    for dtype in (torch.float64, torch.float32):
        assert _reads_of_round_trip(s, None, (3, 32, 32), dtype) == []


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_single_call_is_the_batch_of_one(case, direction):
    """A single-image call and a batch call of the same one image run one
    program, a batch program of B = 1, and give the same stream or
    image."""
    s, _, level = _case(case)
    im = _image(38, SHAPE)
    er = pt.encode_image_device(im, s, level, 3000, device=CPU)
    tt.clear_programs()
    if direction == "encode":
        one = pt.encode_image_device(im, s, level, 3000, device=CPU)
        progs = tt.programs()
        (batch,) = pt.encode_images_device([im], s, level, 3000, device=CPU)
        assert (one.encoded_bytes, one.max_n) == (batch.encoded_bytes,
                                                  batch.max_n)
        kind = tt.EncodeBatchProgram
    else:
        one = pt.decode_image_device(er, s, device=CPU)
        progs = tt.programs()
        (batch,) = pt.decode_images_device([er], s, device=CPU)
        assert torch.equal(one, batch)
        kind = tt.DecodeBatchProgram
    (prog,) = progs
    assert tt.programs() == progs
    assert type(prog) is kind and prog.key[2] == 1
    tt.clear_programs()
