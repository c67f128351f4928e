"""The batch programs of ``torch_transform`` on the CPU: one program a key
(``encode_batch_program`` / ``decode_batch_program``), which
``encode_images_device`` and ``decode_images_device`` run, in programs of
at most ``batch_bound`` images. On the CPU a program runs its body
eagerly on its static buffers (on the card it replays a CUDA graph of the
same body; ``chip_smoke.py`` phase 26 holds that to the eager body).

Held here, at 3x64x80 (A-like: even LL 12x14, B5; B-like: odd LL 15x17,
batched B3), B = 2-5, and at a camera sweep of six 3x45x80 frames at
level 2 (A's settings, odd LL 15x23 as a 1600x900 frame's 11x17): streams byte for byte and max_n exactly equal to
the JAX package's ``encode_images_device`` and to the port's eager
bodies, images within 1e-8 of the JAX package's jitted batch decode (its
fused multiply-adds; ``tests/test_torch_program.py`` holds the same) and
equal to the eager body's; mixed per-stream budgets; shorter streams
through a longer key's bucket; a longer then a shorter batch through one
key; the ``map`` route (single launches, where a launch would take
fewer than two streams); a batch split past the image bound, in input
order, through one program a direction; the keys, the eviction,
threads that take turns, and no value read back inside a body."""

import sys
import threading

import numpy as np
import pytest
import torch

import spiht_tpu
import spiht_tpu_torch as pt
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch.codec import decoder, encoder

from test_golden import _image

torch.set_num_threads(1)

CPU = torch.device("cpu")
FULL = 2**31 - 2
SHAPE = (3, 64, 80)
A = dict(wavelet="bior2.2", mode="reflect", color_model="ipt",
         per_channel_quant_scales=[100, 20, 20], quantization_scale=1.0)
B = dict(wavelet="bior4.4", mode="symmetric")
BUDGETS = [FULL, 3000, 777]
# a camera sweep: six frames of a 16:9 rig at level 2, LL 15x23 (odd in
# both dimensions, as a 1600x900 frame's 11x17), at 0.1-2 bits a pixel
SWEEP_SHAPE = (3, 45, 80)
SWEEP_BUDGETS = [360, 896, 1800, 3600, 5400, 7200]
# settings, level, image shape, a budget a stream, odd LL (batched B3)
CASES = {"A": (A, None, SHAPE, BUDGETS, False),
         "B": (B, 3, SHAPE, BUDGETS, True),
         "sweep": (A, 2, SWEEP_SHAPE, SWEEP_BUDGETS, True)}
# the JAX package's jitted inverse fuses multiply-adds (ROADMAP "Not
# faults"): images within this of it, equal to the port's eager body
TOL = 1e-8


def _case(name):
    kw, level = CASES[name][:2]
    return pt.SpihtSettings(**kw), spiht_tpu.SpihtSettings(**kw), level


def _ims(n, seed=40, shape=SHAPE):
    return [_image(seed + k, shape) for k in range(n)]


def _eager_encode(ims, s, level, mbs):
    words, stat, max_n = tt.encode_pipeline_batch_eager(s, level)(
        torch.as_tensor(np.stack(ims)), mbs)
    totals = [r[0] for r in encoder.check_stat(stat, "spiht_encode_batch")]
    return list(zip(encoder.batch_stream_bytes(words, totals),
                    max_n.tolist()))


def _eager_decode(ers, s, level, shape=SHAPE):
    words, nbits = decoder.words_batch([e.encoded_bytes for e in ers], CPU)
    c, h, w = shape
    return tt.decode_pipeline_batch_eager(s, h, w, level, c)(
        words, nbits, [e.max_n for e in ers])


@pytest.fixture(autouse=True)
def _fresh_programs():
    tt.clear_programs()
    yield
    tt.clear_programs()


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_programs_equal_the_reference_and_the_eager_body(case):
    """The sweep case is a batch of six frames of a camera rig, its LL odd
    as a 1600x900 frame's: one launch of the six streams through batched
    B3."""
    s, js, level = _case(case)
    _, _, shape, mbs, odd = CASES[case]
    n = len(mbs)
    ims = _ims(n, 40, shape)
    ers = pt.encode_images_device(ims, s, level, mbs, device=CPU)
    jers = spiht_tpu.encode_images_device(ims, js, level, mbs)
    got = [(e.encoded_bytes, e.max_n) for e in ers]
    assert got == [(e.encoded_bytes, e.max_n) for e in jers]
    assert got == _eager_encode(ims, s, level, mbs)
    imgs = pt.decode_images_device(ers, s, device=CPU)
    eager = _eager_decode(ers, s, level, shape)
    for b, (img, jimg) in enumerate(zip(
            imgs, spiht_tpu.decode_images_device(jers, js))):
        assert torch.equal(img, eager[b])
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                                   atol=TOL)
    (prog,) = [p for p in tt.programs() if p.key[0] == "decode_batch"]
    assert prog.key[9:12] == ("b3" if odd else "b5", "ilv", n)
    assert prog.kernel == f"spiht_decode_{'seq' if odd else 'lsp'}_batch"
    assert prog.launch == {"streams": n, "seq": int(odd)}


def test_budgets_and_stream_lengths_through_one_key():
    """One encode key takes every budget list whose largest fits its
    bucket, a longer then a shorter batch of budgets; one decode key takes
    streams shorter than its bucket (each row zeroed past its stream)."""
    s, _, level = _case("A")
    ims = _ims(3, 50)
    prog = tt.encode_batch_program(s, (3,) + SHAPE, level, device=CPU,
                                   max_bits=6000)
    for mbs in ([6000, 5000, 4000], [1, 2, 3], [0, 6000, 64]):
        assert prog(ims, mbs) == _eager_encode(ims, s, level, mbs)
    assert len(tt.programs()) == 1
    full = pt.encode_images_device(ims, s, level, 6000, device=CPU)
    dprog = tt.decode_batch_program(s, *SHAPE[1:], level, SHAPE[0], 3,
                                    device=CPU, nbits=6000)
    for cut in (6000 // 8, 300, 17, 1):
        ers = [pt.EncodingResult(e.encoded_bytes[:cut], e.h, e.w, e.c,
                                 e.max_n, e.level) for e in full]
        want = _eager_decode(ers, s, level)
        got = pt.decode_images_device(ers, s, device=CPU)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
        out = dprog([e.encoded_bytes for e in ers], [cut * 8] * 3,
                    [e.max_n for e in ers])
        assert torch.equal(out, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_route_equals_the_batch_kernels(case, monkeypatch):
    """Where a launch would take fewer than two streams
    (``SPIHT_TPU_PALLAS_ILV_B=1``), the programs run B1, and B2 and its
    scatter or B3, a stream each (``batch_route``), every launch reading
    its scalars from row b of the static buffers: the same streams and
    images as the batch kernels, and the eager bodies take the same
    route."""
    s, _, level = _case(case)
    _, _, shape, mbs, odd = CASES[case]
    n = len(mbs)
    ims = _ims(n, 60, shape)
    want = tt.encode_batch(s, ims, mbs, level, device=CPU)
    c, h, w = shape
    args = (s, h, w, level, c, [d for d, _ in want],
            [len(d) * 8 for d, _ in want], [m for _, m in want])
    want_imgs = tt.decode_batch(*args, device=CPU)
    monkeypatch.setenv("SPIHT_TPU_PALLAS_ILV_B", "1")
    assert tt.batch_route(n) == ("map", None)
    counts = {}
    for name, mod in (("encode_machine", encoder),
                      ("encode_machine_batch", encoder),
                      ("decode_lsp", decoder), ("decode_seq", decoder),
                      ("decode_lsp_batch", decoder),
                      ("decode_seq_batch", decoder)):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    got = tt.encode_batch(s, ims, mbs, level, device=CPU)
    assert got == want == _eager_encode(ims, s, level, mbs)
    assert counts == {"encode_machine": 2 * n}  # the program, the eager body
    counts.clear()
    imgs = tt.decode_batch(*args, device=CPU)
    single = "decode_seq" if odd else "decode_lsp"
    assert counts == {single: n}
    assert torch.equal(imgs, want_imgs)
    assert [p.key[10:12] for p in tt.programs()][-2:] == [("map", None)] * 2


def test_batch_split_past_the_image_bound(monkeypatch):
    """A batch larger than ``batch_bound`` runs as equal parts through one
    program a direction, the last part padded; results come back in input
    order and equal one program's; a second call makes no new program."""
    s, _, level = _case("A")
    ims = _ims(5, 70)
    mbs = [FULL, 3000, 777, 5, 0]
    whole = pt.encode_images_device(ims, s, level, mbs, device=CPU)
    imgs = pt.decode_images_device(whole, s, device=CPU)
    cells = int(np.prod(SHAPE))
    monkeypatch.setattr(tt, "_memory_limit",
                        lambda dev: 2 * tt.BATCH_BYTES_PER_CELL * cells)
    assert tt.batch_bound(SHAPE, CPU) == 2
    tt.clear_programs()
    split = pt.encode_images_device(ims, s, level, mbs, device=CPU)
    assert [(e.encoded_bytes, e.max_n) for e in split] == [
        (e.encoded_bytes, e.max_n) for e in whole]
    got = pt.decode_images_device(split, s, device=CPU)
    for g, w_ in zip(got, imgs):
        assert torch.equal(g, w_)
    # 5 images at a bound of 2: parts of 2, 2 and 1 (padded), one key a
    # direction, whose bucket is the whole batch's largest budget
    progs = tt.programs()
    assert sorted((p.key[0], p.key[2]) for p in progs) == [
        ("decode_batch", 2), ("encode_batch", 2)]
    again = pt.encode_images_device(ims, s, level, mbs, device=CPU)
    assert [(e.encoded_bytes, e.max_n) for e in again] == [
        (e.encoded_bytes, e.max_n) for e in whole]
    assert all(torch.equal(g, w_) for g, w_ in zip(
        pt.decode_images_device(again, s, device=CPU), imgs))
    assert tt.programs() == progs
    # the pipeline functions split the same way
    words, stat, max_n = tt.encode_pipeline_batch_fn(s, level, device=CPU)(
        np.stack(ims), mbs)
    ew, es, em = tt.encode_pipeline_batch_eager(s, level)(
        torch.as_tensor(np.stack(ims)), mbs)
    assert torch.equal(words, ew) and torch.equal(stat, es)
    assert torch.equal(max_n, em)


@pytest.mark.parametrize("n, bound, m, parts", [
    (5, 2, 2, 3), (800, 135, 134, 6), (128, 135, 128, 1), (136, 135, 68, 2),
    (1, 1, 1, 1), (7, None, 7, 1)])
def test_batch_parts(n, bound, m, parts, monkeypatch):
    """The fewest equal parts of at most the bound, the last no longer."""
    cells = int(np.prod(SHAPE))
    monkeypatch.setattr(tt, "_memory_limit", lambda dev: None if bound is None
                        else bound * tt.BATCH_BYTES_PER_CELL * cells)
    assert tt.batch_bound(SHAPE, CPU) == bound
    got, ranges = tt._batch_parts(n, SHAPE, CPU)
    assert got == m and len(ranges) == parts
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(e - s == m for s, e in ranges[:-1])
    assert 1 <= ranges[-1][1] - ranges[-1][0] <= m


def test_pipeline_batch_fns_return_the_programs_outputs():
    s, _, level = _case("B")
    ims = torch.as_tensor(np.stack(_ims(2, 80)))
    mbs = [4000, 100]
    got = tt.encode_pipeline_batch_fn(s, level)(ims, mbs)
    want = tt.encode_pipeline_batch_eager(s, level)(ims, mbs)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    words, stat, max_n = got
    nbits = [int(v) for v in stat[:, 0]]
    c, h, w = SHAPE
    out = tt.decode_pipeline_batch_fn(s, h, w, level, c)(words, nbits,
                                                         max_n.tolist())
    eager = tt.decode_pipeline_batch_eager(s, h, w, level, c)(
        words, nbits, max_n.tolist())
    assert torch.equal(out, eager)


BATCH_FIELDS = {  # field -> encode_batch_program arguments that change it
    "B": dict(shape=(3,) + SHAPE),
    "settings": dict(settings=pt.SpihtSettings(quantization_scale=40.0)),
    "h": dict(shape=(2, 3, 72, 80)),
    "level": dict(level=2),
    "dtype": dict(dtype=torch.float32),
    "in_dtype": dict(in_dtype=torch.float32),
    "bucket": dict(max_bits=3000),
}


@pytest.mark.parametrize("field", sorted(BATCH_FIELDS))
def test_batch_keys(field, monkeypatch):
    base = dict(settings=pt.SpihtSettings(), shape=(2,) + SHAPE, level=None,
                device=CPU)
    p0 = tt.encode_batch_program(**base)
    assert tt.encode_batch_program(**base) is p0
    p1 = tt.encode_batch_program(**{**base, **BATCH_FIELDS[field]})
    assert p1 is not p0
    if field == "B":  # the chunk of B4 launches is in the key too
        monkeypatch.setenv("SPIHT_TPU_PALLAS_ILV_B", "1")
        assert tt.encode_batch_program(**base) is not p0
    d0 = tt.decode_batch_program(pt.SpihtSettings(), 64, 80, None, 3, 2,
                                 device=CPU, nbits=100)
    assert tt.decode_batch_program(pt.SpihtSettings(), 64, 80, None, 3, 2,
                                   device=CPU, nbits=128) is d0
    assert tt.decode_batch_program(pt.SpihtSettings(), 64, 80, None, 3, 2,
                                   device=CPU, nbits=129) is not d0


def test_eviction_counts_the_batch_programs(monkeypatch):
    monkeypatch.setattr(tt, "PROGRAM_LIMIT", 2)
    s = pt.SpihtSettings()
    one = tt.encode_batch_program(s, (1,) + SHAPE, device=CPU)
    batch = tt.encode_batch_program(s, (2,) + SHAPE, device=CPU)
    assert tt.programs() == [one, batch]
    dec = tt.decode_batch_program(s, 64, 80, None, 3, 4, device=CPU)
    assert tt.programs() == [batch, dec]
    assert batch.device_bytes == sum(t.numel() * t.element_size()
                                     for t in batch.statics.values())


def test_threads_take_turns_through_one_key():
    s, _, level = _case("A")
    sets = [_ims(2, 90 + 2 * k) for k in range(4)]
    want = [_eager_encode(ims, s, level, [3000, 1500]) for ims in sets]
    prog = tt.encode_batch_program(s, (2,) + SHAPE, level, device=CPU,
                                   max_bits=3000)
    got = [None] * 4

    def work(k):
        for _ in range(2):
            got[k] = prog(sets[k], [3000, 1500])

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want and len(tt.programs()) == 1


def test_mixed_shapes_go_one_by_one_in_input_order():
    s, js, level = _case("A")
    ims = [_image(3, (3, 64, 80)), _image(4, (3, 72, 80)),
           _image(5, (3, 64, 80))]
    ers = pt.encode_images_device(ims, s, level, 3000, device=CPU)
    for im, er in zip(ims, ers):
        one = pt.encode_image_device(im, s, level, 3000, device=CPU)
        assert (er.encoded_bytes, er.max_n, er.h) == (
            one.encoded_bytes, one.max_n, one.h)
    # the images of a shape alone go through the batch program of one
    assert {(p.key[0], p.key[2]) for p in tt.programs()} == {
        ("encode_batch", 1)}


# reads of a value back to the host: on the card each is a sync, which a
# CUDA graph cannot capture
READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
         "aten::equal", "aten::allclose"}
# the plain versions of the kernels, which stand in for them on the CPU
PLAIN = {"_encode_machine_plain", "_encode_machine_batch_plain",
         "_decode_machine_plain", "_decode_machine_batch_plain"}


@pytest.mark.parametrize("route", ["ilv", "map"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_bodies_read_no_value_back(case, route, monkeypatch):
    """The batch programs' bodies, around the machines, read nothing back
    (on the CPU the plain machines, which stand in for the kernels, read
    their scalars), on both routes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    if route == "map":
        monkeypatch.setenv("SPIHT_TPU_PALLAS_ILV_B", "1")
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

    s, _, level = _case(case)
    shape = CASES[case][2]
    ims = _ims(2, 100, shape)
    ep = tt.encode_batch_program(s, (2,) + shape, level, device=CPU,
                                 max_bits=3000)
    assert ep.key[10] == route
    got = ep(ims, [3000, 900])
    c, h, w = shape
    dp = tt.decode_batch_program(s, h, w, level, c, 2, device=CPU,
                                 nbits=3000)
    args = ([d for d, _ in got], [len(d) * 8 for d, _ in got],
            [m for _, m in got])
    dp(*args)
    with Reads() as reads:
        ep.start(ims, [3000, 900])
        dp.start(*args)
    assert ep.finish() == got
    assert reads.seen == []


# a program of 7 rows, its fronts of 3 (FRONT_BYTES set to 3 rows): 0-3,
# 3-6 and 6-7; n of 1, 2, k, k + 1, B - 1 and B
ROWS_B, ROWS_K = 7, 3
ROWS_N = (1, 2, 3, 4, 6, 7)
MIXED = [3000, 0, -7, 1500, 777, 2500, 4000]
FORMS = {"list": list, "array": np.stack,
         "tensor": lambda ims: torch.as_tensor(np.stack(ims))}


@pytest.fixture(scope="module")
def rows_reference():
    """Seven images and the JAX package's (stream, max_n) of each at
    ``MIXED``: each stream is its image's alone, so the first n are the
    answers of any n."""
    _, js, level = _case("A")
    ims = _ims(ROWS_B, 110)
    jers = spiht_tpu.encode_images_device(ims, js, level, MIXED)
    return ims, [(e.encoded_bytes, e.max_n) for e in jers]


def _chunked(monkeypatch, ims):
    s, _, level = _case("A")
    monkeypatch.setattr(tt, "FRONT_BYTES", ROWS_K * ims[0].nbytes)
    prog = tt.encode_batch_program(s, (ROWS_B,) + SHAPE, level, device=CPU,
                                   max_bits=max(MIXED))
    assert prog.rows_a_front == ROWS_K
    assert prog._fronts == [(0, 3), (3, 6), (6, 7)]
    return prog


@pytest.mark.parametrize("route", ["ilv", "map"])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n", ROWS_N)
def test_chunked_batch_encode_equals_the_reference(n, form, route,
                                                   rows_reference,
                                                   monkeypatch):
    """Host rows go up a chunk of ``rows_a_front`` at a time, each chunk's
    front running once it is staged (eagerly here), then the back: the
    streams and max_n equal the JAX package's and the eager body's, for
    every n, input form and route, with budgets 0 and negative, after a
    full call of other images (the rows past n, padded from row n - 1,
    change no answer). ``overlap_rows`` counts the rows of every front
    but the last (none for one image, which runs the whole body as one),
    ``staged_rows`` every row."""
    if route == "map":
        monkeypatch.setenv("SPIHT_TPU_PALLAS_ILV_B", "1")
    s, _, level = _case("A")
    ims, want = rows_reference
    prog = _chunked(monkeypatch, ims)
    assert prog.key[10] == route
    prog(_ims(ROWS_B, 120), [4000] * ROWS_B)
    rows, overlap = prog.staged_rows, prog.overlap_rows
    got = prog(FORMS[form](ims[:n]), MIXED[:n])
    assert got == want[:n]
    assert got == _eager_encode(ims[:n], s, level, MIXED[:n])
    assert prog.staged_rows - rows == n
    assert prog.overlap_rows - overlap == (n - 1) // ROWS_K * ROWS_K
    assert prog.front_replays == prog.replays == 0  # no graph off the card


@pytest.mark.parametrize("form", ["tensor", "rows"])
def test_rows_on_the_card_run_one_graph(form, rows_reference, monkeypatch):
    """Images on the card (mocked: every tensor counts as on it) have no
    copy to hide: the front of all B rows and the back run as one part,
    one replay, and no row overlaps; host images through the same program
    then run a part a front and the back. The streams are the same."""
    ims, want = rows_reference
    prog = _chunked(monkeypatch, ims)
    monkeypatch.setattr(tt, "_on_card",
                        lambda x: isinstance(x, torch.Tensor))
    parts, replay = [], prog._replay
    monkeypatch.setattr(prog, "_replay",
                        lambda part, body, *counts: parts.append(part)
                        or replay(part, body, *counts))
    x = torch.as_tensor(np.stack(ims))
    assert prog(x if form == "tensor" else list(x), MIXED) == want
    assert parts == ["body"]
    assert prog.overlap_rows == 0 and prog.staged_rows == ROWS_B
    del parts[:]
    assert prog(ims, MIXED) == want
    assert parts == [("front", 0), ("front", 3), ("front", 6), "back"]
    assert prog.overlap_rows == ROWS_B - 1
