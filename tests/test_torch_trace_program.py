"""The metadata trace as one program a key (``torch_transform.
trace_program``) on the CPU, where a program runs its body eagerly on its
static buffers (on the card it replays a CUDA graph of the same body;
``chip_smoke.py`` phase 27 holds that to the eager body).

Held here: the program's rec and 8-column trace against the eager body
(``meta_expand.decode_with_metadata_eager``) and the JAX package (its
native route, and the Pallas ``with_log`` kernel in interpret mode at
even LL) row for row, at full streams, a one-bit budget, a cut inside a
symbol, byte prefixes and odd-LL geometries whose nodes carry two
filters; two streams through one bucket's key; the bucket-sized log's
rows past nbits; the odd-LL replay's static pass bound against the
data's writes; a caller's log through the expansion-only form; tables
that outlive their cache; and no read back to the host in the bodies."""

import sys

import numpy as np
import pytest
import torch

import spiht_tpu
from spiht_tpu.codec import api as japi
from spiht_tpu.codec import meta_expand as jme

import spiht_tpu_torch as pt
from spiht_tpu_torch import torch_transform as tt
from spiht_tpu_torch.codec import decoder, meta_expand
from spiht_tpu_torch.device import holding
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w, slices_to_wire

torch.set_num_threads(1)

CPU = torch.device("cpu")
IPT = dict(color_model="ipt", per_channel_quant_scales=[100, 20, 20],
           quantization_scale=1.0)
B44 = dict(wavelet="bior4.4", mode="symmetric")
# the event log's actions that write a node's value: the sign read of a
# commit (A_LIPSIGN, A_OFFSIGN) and a refinement (A_REF)
WRITES = (1, 4, 6)


def _geometry(shape, settings, level):
    c, h, w = shape
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    return ((c, enc_h, enc_w, slices[0][1].stop, slices[0][2].stop),
            slices_to_wire(slices))


def _stream(shape, kw, level, budget, cut):
    """A seeded image's stream (the port's CPU encode, which equals the
    JAX package's: tests/test_torch_program.py), cut to ``cut`` bytes."""
    im = np.random.default_rng(sum(shape) + 7).random(shape)
    er = pt.encode_image_device(im, pt.SpihtSettings(**kw), level, budget,
                                device="cpu")
    geo, wire = _geometry(shape, pt.SpihtSettings(**kw), level)
    return er.encoded_bytes[:cut], er.max_n, geo, wire


def _most_writes(data, max_n, geo):
    """The most value writes (commits and refinements within the stream)
    any node takes in the stream's event log: the count the odd-LL
    replay's passes must cover."""
    _, log, _, nbits = meta_expand.decode_event_log(data, max_n, *geo, CPU)
    lg = log.numpy()[:nbits]
    act = (lg >> 32) & 7
    nodes = (lg & 0xFFFFFFFF)[(lg != 0) & np.isin(act, WRITES)]
    return int(np.bincount(nodes).max()) if nodes.size else 0


CASES = {
    "one bit": ((2, 64, 64), {}, 3, 1, None),
    "cut in a symbol": ((2, 64, 64), {}, 3, 4097, None),
    "full": ((3, 44, 60), IPT, 2, None, None),
    "byte prefix": ((3, 44, 60), IPT, 2, None, 333),
    "odd LL full": ((3, 64, 64), B44, 3, None, None),
    "odd LL prefix": ((3, 64, 64), B44, 3, None, 1111),
    "odd LL cut in a symbol": ((3, 64, 64), B44, 3, 9999, None),
    "odd LL 9x9": ((2, 40, 40), {}, 3, None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_eager_body_and_jax(case):
    """The API's trace (the program, numpy read from its outputs) and
    ``meta_expand.decode_with_metadata`` (fresh tensors) equal the eager
    body and ``spiht_tpu.codec.api.decode_with_metadata`` row for row; at
    odd LL the stream has nodes whose instances differ in filter, and the
    static pass bound covers every node's writes."""
    shape, kw, level, budget, cut = CASES[case]
    data, max_n, geo, wire = _stream(shape, kw, level, budget, cut)
    odd = decoder.has_duplicate_parents(*geo[1:])
    assert odd == case.startswith("odd")
    want_rec, want_meta = japi.decode_with_metadata(data, max_n, *geo, *wire)
    tt.clear_programs()
    rec, meta = pt.decode_with_metadata(data, max_n, *geo, *wire,
                                        device="cpu")
    (prog,) = tt.programs()
    assert prog.key[0] == "trace" and prog.key[-1] == "trace"
    assert prog.key[8] == ("b3log" if odd else "b2log")
    assert meta.shape == (len(data) * 8 + 1, 8) and meta.dtype == np.int32
    np.testing.assert_array_equal(rec, want_rec)
    np.testing.assert_array_equal(meta, want_meta)
    trec, tmeta = meta_expand.decode_with_metadata(data, max_n, *geo, *wire,
                                                   CPU)
    assert tt.programs() == [prog]
    erec, emeta = meta_expand.decode_with_metadata_eager(
        data, max_n, *geo, *wire, CPU)
    for got in (trec, erec):
        np.testing.assert_array_equal(got.numpy(), want_rec)
    for got in (tmeta, emeta):
        np.testing.assert_array_equal(got.numpy(), want_meta)
    if odd:
        assert _two_filter_nodes(data, max_n, geo)
        passes = meta_expand.replay_passes(*geo[1:])
        assert passes >= _most_writes(data, max_n, geo) > 1


def _two_filter_nodes(data, max_n, geo) -> int:
    """The nodes whose events in B3-log's log carry more than one
    filter."""
    _, log, _, nbits = meta_expand.decode_event_log(data, max_n, *geo, CPU)
    lg = log[: nbits + 1].numpy()
    lg = lg[lg != 0]
    pairs = np.unique(np.stack([lg & 0xFFFFFFFF, (lg >> 40) & 3], 1), axis=0)
    _, counts = np.unique(pairs[:, 0], return_counts=True)
    return int((counts > 1).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_odd_ll_random_words_within_the_pass_bound(seed):
    """Random words at odd LL (nodes committed again by a second parent,
    refined by several instances, magnitudes cleared to 0): the trace
    equals the JAX package's, and the pass bound covers the writes."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    geo, wire = _geometry((3, 40, 40), pt.SpihtSettings(), 3)
    max_n = 6 + 4 * seed
    want_rec, want_meta = japi.decode_with_metadata(data, max_n, *geo, *wire)
    rec, meta = pt.decode_with_metadata(data, max_n, *geo, *wire,
                                        device="cpu")
    np.testing.assert_array_equal(rec, want_rec)
    np.testing.assert_array_equal(meta, want_meta)
    assert meta_expand.replay_passes(*geo[1:]) >= _most_writes(data, max_n,
                                                               geo)


def test_replay_passes_from_the_geometry():
    """31 writes an instance, one instance an LL parent: three LL parents
    at most in the odd-LL geometries, one at even LL."""
    for shape, kw, level in (((3, 64, 64), B44, 3), ((2, 40, 40), {}, 3),
                             ((3, 512, 512), B44, 3)):
        geo, _ = _geometry(shape, pt.SpihtSettings(**kw), level)
        assert decoder.has_duplicate_parents(*geo[1:])
        assert meta_expand.replay_passes(*geo[1:]) == 3 * 31
    geo, _ = _geometry((2, 64, 64), pt.SpihtSettings(), 3)
    assert meta_expand.replay_passes(*geo[1:]) == 31


def test_trace_equals_pallas_with_log_interpret():
    """At even LL the program's trace equals the JAX package's Pallas
    route (``pallas_decode_with_metadata`` in interpret mode)."""
    settings = spiht_tpu.SpihtSettings()
    im = np.random.default_rng(3).random((2, 32, 32))
    er = spiht_tpu.encode_image(im, settings, 3, 1500)
    geo, wire = _geometry((2, 32, 32), pt.SpihtSettings(), 3)
    data = er.encoded_bytes[:150]
    want_rec, want_meta = jme.pallas_decode_with_metadata(
        data, er.max_n, *geo, *wire, interpret=True)
    rec, meta = meta_expand.pallas_decode_with_metadata(
        data, er.max_n, *geo, *wire, device="cpu")
    np.testing.assert_array_equal(rec, np.asarray(want_rec))
    np.testing.assert_array_equal(meta, np.asarray(want_meta))


@pytest.mark.parametrize("case", ["full", "odd LL full"])
def test_two_streams_through_one_bucket(case):
    """A longer and a shorter stream of one bucket share one key; the
    shorter's trace is unchanged by the longer's log before it, and the
    bucket-sized log is 0 past nbits."""
    shape, kw, level, _, _ = CASES[case]
    data, max_n, geo, wire = _stream(shape, kw, level, None, None)
    long_, short = data[:2000], data[:1100]  # 16000 and 8800 bits
    tt.clear_programs()
    got = [pt.decode_with_metadata(d, max_n, *geo, *wire, device="cpu")
           for d in (long_, short)]
    (prog,) = tt.programs()
    assert prog.bucket == 512 and prog.rows == 32 * 512 + 1
    for d, (rec, meta) in zip((long_, short), got):
        want = japi.decode_with_metadata(d, max_n, *geo, *wire)
        np.testing.assert_array_equal(rec, want[0])
        np.testing.assert_array_equal(meta, want[1])
    # the raw log of the form "log" at the bucket's length
    lprog = tt.trace_program(*geo, *wire, len(short) * 8, CPU, "log")
    with lprog.lock:
        lprog.start([long_], len(long_) * 8, max_n)
        lprog.start([short], len(short) * 8, max_n)
        log = lprog.outputs[2]
        assert log.shape == (lprog.rows,)
        nbits = len(short) * 8
        assert log[nbits] != 0 and not log[nbits + 1:].any()
        lprog.finish()


def test_expand_event_log_through_the_expansion_form():
    """A caller's log and words (``decode_event_log``) expand through the
    form "expand" of the same geometry and bucket to the trace of
    ``decode_with_metadata``; the log's rows past nbits + 1 are not
    read."""
    data, max_n, geo, wire = _stream(*CASES["odd LL prefix"])
    rec, log, words, nbits = meta_expand.decode_event_log(data, max_n, *geo,
                                                          CPU)
    assert log.shape == (nbits + 1,) and words.shape == ((nbits + 31) // 32,)
    want = japi.decode_with_metadata(data, max_n, *geo, *wire)
    np.testing.assert_array_equal(rec.numpy(), want[0])
    padded = torch.cat([log, torch.full((40,), -1, dtype=torch.int64)])
    meta = meta_expand.expand_event_log(padded, words, nbits, *geo, *wire)
    np.testing.assert_array_equal(meta.numpy(), want[1])
    forms = {p.key[-1] for p in tt.programs() if p.key[0] == "trace"}
    assert {"log", "expand"} <= forms


def test_tables_outlive_their_cache():
    """The program keeps the node and rect tables it was made with: five
    geometries evict the first from the 4-entry node-table cache, and
    the first key's program still reads its own tables and gives the
    same trace; ``holding()`` collects the tables a body looks up."""
    tt.clear_programs()
    meta_expand._node_tables_on.cache_clear()
    shapes = [(1, 32, 32), (1, 32, 48), (1, 48, 32), (2, 32, 32),
              (1, 64, 32)]
    first = None
    rng = np.random.default_rng(5)
    for shape in shapes:
        data, max_n = rng.integers(0, 256, 200, np.uint8).tobytes(), 6
        geo, wire = _geometry(shape, pt.SpihtSettings(), 2)
        got = pt.decode_with_metadata(data, max_n, *geo, *wire, device="cpu")
        if first is None:
            first = (data, max_n, geo, wire, got)
            prog = tt.programs()[-1]
            tables = prog.tables
    assert meta_expand._node_tables_on.cache_info().currsize == 4
    data, max_n, geo, wire, want = first
    level = len(wire[1])
    assert meta_expand._node_tables_on(*geo, level, CPU) is not tables[3]
    again = pt.decode_with_metadata(data, max_n, *geo, *wire, device="cpu")
    assert tt.programs()[-1] is prog and prog.tables is tables
    for a, b in zip(again, want):
        np.testing.assert_array_equal(a, b)
    with holding() as held:
        meta_expand._node_tables(*geo, level, CPU)
    assert len(held) == 1


# reads of a value back to the host: on the card each is a sync, which a
# CUDA graph cannot capture
READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
         "aten::equal", "aten::allclose"}
# the plain versions of the kernels, which stand in for them on the CPU
PLAIN = {"_decode_machine_plain"}


def _reads(run):
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

    with Reads() as reads:
        run()
    return reads.seen


@pytest.mark.parametrize("case", ["cut in a symbol", "odd LL prefix"])
def test_bodies_read_no_value_back(case):
    """The trace body and the expansion-only body read nothing back: no
    ``.item()``, no 0-d index tensor, no data-dependent shape (the old
    in-order replay's ``nonzero`` and ``bincount().tolist()`` included);
    on the CPU the plain machines read their scalars."""
    data, max_n, geo, wire = _stream(*CASES[case])
    nbits = len(data) * 8
    prog = tt.trace_program(*geo, *wire, nbits, CPU, "trace")
    rec, log, words, _ = meta_expand.decode_event_log(data, max_n, *geo, CPU)
    eprog = tt.trace_program(*geo, *wire, nbits, CPU, "expand")
    with prog.lock, eprog.lock:
        assert _reads(lambda: prog.start([data], nbits, max_n)) == []
        assert _reads(lambda: eprog.start(words, nbits, log=log)) == []
        want = japi.decode_with_metadata(data, max_n, *geo, *wire)
        np.testing.assert_array_equal(prog.finish()[1].numpy(), want[1])
        np.testing.assert_array_equal(eprog.finish()[0].numpy(), want[1])


def test_max_n_past_the_plane_field_raises_before_the_run():
    """max_n > 30 is refused on the host in ``start``, before any put."""
    geo, wire = _geometry((1, 32, 32), pt.SpihtSettings(), 2)
    prog = tt.trace_program(*geo, *wire, 64, CPU)
    with pytest.raises(ValueError, match="max_n <= 30"):
        prog.start([b"\xff" * 8], 64, 31)
    assert prog.replays == 0 and prog.outputs is None
