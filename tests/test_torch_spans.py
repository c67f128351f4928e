"""The port's span log (``spiht_tpu_torch.metrics``) through the four
on-device API functions on the CPU (``device="cpu"``, where a program
runs its body eagerly, its ``replay``).

Held here: each API call is one top-level span with its program's
``stage``, ``replay``, ``wait`` and ``read`` spans under it, all of one
request; the counts (``images``; ``bytes`` staged and read back) equal
the images' and streams' sizes; nothing is recorded with no profiler on;
under a profiler the exported Chrome trace holds the same spans, which
after one offset agree with the log's within 50 us; a span left open
closes with its parent; ``stage_s`` is the stage span's interval.

The batch encode of two small images runs as one graph (one front takes
both); with ``FRONT_BYTES`` set to a front an image (the ``fronts``
fixture) its fronts cut its stage, so its ``stage`` and ``replay`` spans
alternate, siblings, a front's replay after each image's stage and the
back's after the budgets', each stage counting its own bytes, and its
``stage_s`` runs from the first stage to the last.

The batch programs' machine route (``launch``), which the machine
graph's ``replay`` span counts: ``streams``, those of the last machine
launch, and ``seq``, 1 in a decode at an odd LL (batched B3) and 0 at an
even LL or in the encode."""

import json
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spiht_tpu_torch as pt
from spiht_tpu_torch import metrics
from spiht_tpu_torch import torch_transform as tt

torch.set_num_threads(1)

SETTINGS = pt.SpihtSettings(
    wavelet="bior2.2", mode="reflect", color_model="ipt",
    per_channel_quant_scales=[100, 20, 20], quantization_scale=1.0)
SHAPE = (3, 40, 48)
BITS = 2000
PHASES = ["stage", "replay", "wait", "read"]
FUNCTIONS = ["encode_image_device", "decode_image_device",
             "encode_images_device", "decode_images_device"]
# a single-image call runs the batch program of one image
KIND = {"encode_image_device": "encode_batch",
        "decode_image_device": "decode_batch",
        "encode_images_device": "encode_batch",
        "decode_images_device": "decode_batch"}
# the batch encode of two images in fronts of one: a front each, the back
FRONTS = ["stage", "replay"] * 3 + ["wait", "read"]
# the counts of a batch program's machine replay at SHAPE (LL 9x10, odd:
# duplicate parents): one launch of both streams, the decode's batched B3;
# a single image's, the one launch of B1 or B3 (the map route)
LAUNCH = {"encode_image_device": {"streams": 1, "seq": 0},
          "decode_image_device": {"streams": 1, "seq": 0},
          "encode_images_device": {"streams": 2, "seq": 0},
          "decode_images_device": {"streams": 2, "seq": 1}}


@pytest.fixture
def fronts(monkeypatch):
    """The batch encode's fronts take one image each (its programs made
    afresh: a program fixes its fronts when it is made)."""
    monkeypatch.setattr(tt, "FRONT_BYTES", 1)
    tt.clear_programs()
    yield
    tt.clear_programs()


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(20)
    return [rng.random(SHAPE) for _ in range(2)]


@pytest.fixture(scope="module")
def results(images):
    return pt.encode_images_device(images, SETTINGS, None, BITS, "cpu")


def _call(fn, images, results):
    """(what ``fn`` returns, its images) for one call of ``fn``."""
    if fn == "encode_image_device":
        return pt.encode_image_device(images[0], SETTINGS, None, BITS,
                                      "cpu"), images[:1]
    if fn == "decode_image_device":
        return pt.decode_image_device(results[0], SETTINGS,
                                      device="cpu"), images[:1]
    if fn == "encode_images_device":
        return pt.encode_images_device(images, SETTINGS, None, BITS,
                                       "cpu"), images
    return pt.decode_images_device(results, SETTINGS, device="cpu"), images


def _profiled(fn, images, results):
    """(``fn``'s result, its images, the log) of one call under a CPU
    profiler, after a warm call (a key's first call, the profiler's first
    event)."""
    _call(fn, images, results)
    with profile(activities=[ProfilerActivity.CPU]):
        _call(fn, images, results)
        metrics.clear_spans()
        out, ims = _call(fn, images, results)
    return out, ims, metrics.spans()


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_an_api_call_is_one_request(fn, images, results):
    _one_request(fn, images, results, PHASES)


def test_the_batch_encode_fronts_are_one_request(images, results, fronts):
    _one_request("encode_images_device", images, results, FRONTS)


def _one_request(fn, images, results, phases):
    """A call of ``fn`` is one top-level span with its program's spans
    ``phases`` under it, in order, disjoint."""
    _, ims, log = _profiled(fn, images, results)
    top = [s for s in log if s.parent is None]
    assert [s.name for s in top] == [f"spiht/api/{fn}"]
    api = top[0]
    assert api.request == api.id and api.counts == {"images": len(ims)}
    under = sorted((s for s in log if s is not api), key=lambda s: s.start_ns)
    assert [s.name for s in under] == [f"spiht/{KIND[fn]}/{p}" for p in phases]
    assert len({s.id for s in log}) == len(log)
    for s in under:
        assert s.parent == api.id and s.request == api.id
        assert api.start_ns <= s.start_ns <= s.end_ns <= api.end_ns
    for a, b in zip(under, under[1:]):
        assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_counts_are_the_images_and_streams(fn, images, results):
    """``stage`` counts the host bytes copied (the images or the streams,
    and the program's scalars: a budget an image, or nbits and max_n a
    stream), ``read`` the stream bytes or image bytes returned, a batch
    program's ``replay`` its machine launch (``LAUNCH``)."""
    out, ims, log = _profiled(fn, images, results)
    count = {s.name.rsplit("/", 1)[1]: s.counts for s in log}
    staged, read = _staged_and_read(fn, out, ims, results)
    assert count["stage"] == {"bytes": staged}
    assert count["read"] == {"bytes": read}
    assert count["replay"] == LAUNCH[fn]
    assert count["wait"] == {}


def test_the_fronts_stages_count_their_images(images, results, fronts):
    """The batch encode's stages in fronts of an image count an image
    each, then the budgets, and sum to what one stage counts."""
    fn = "encode_images_device"
    out, ims, log = _profiled(fn, images, results)
    staged, read = _staged_and_read(fn, out, ims, results)
    by_phase = {}
    for s in sorted(log, key=lambda s: s.start_ns):
        by_phase.setdefault(s.name.rsplit("/", 1)[1], []).append(s.counts)
    assert by_phase["stage"] == [{"bytes": im.nbytes} for im in ims] + [
        {"bytes": 4 * len(ims)}]
    assert sum(c["bytes"] for c in by_phase["stage"]) == staged
    assert by_phase["read"] == [{"bytes": read}]
    assert by_phase["replay"] == [{}] * 2 + [LAUNCH[fn]]
    assert by_phase["wait"] == [{}]


def _staged_and_read(fn, out, ims, results):
    """The host bytes a call of ``fn`` on ``ims`` stages (the images or
    the streams, and the program's scalars: a budget an image, or nbits
    and max_n a stream) and the bytes it returns (``out``'s)."""
    n = len(ims)
    if fn.startswith("encode"):
        ers = out if isinstance(out, list) else [out]
        staged = sum(im.nbytes for im in ims) + 4 * n
        read = sum(len(er.encoded_bytes) for er in ers)
    else:
        streams = [er.encoded_bytes for er in results[:n]]
        staged = sum(len(b) for b in streams) + 8 * n
        outs = out if isinstance(out, list) else [out]
        read = sum(t.numel() * t.element_size() for t in outs)
        assert read == sum(im.size for im in ims) * 8
    return staged, read


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_nothing_is_recorded_with_no_profiler_on(fn, images, results):
    metrics.clear_spans()
    _call(fn, images, results)
    assert metrics.spans() == []
    assert metrics.span("spiht/api/x", images=1) is metrics.span("y")
    assert metrics.open_span("z") is None


def _trace_round(images, results, path, spans):
    """The worst disagreement, in us, of a round of the four calls'
    ``spans`` spans with the Chrome trace's, after one offset (the
    median)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(FUNCTIONS[0], images, results)
        metrics.clear_spans()
        for fn in FUNCTIONS:
            _call(fn, images, results)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("spiht/")]
    log = sorted(metrics.spans(), key=lambda s: s.start_ns)
    events = sorted(events, key=lambda e: e["ts"])[-len(log):]
    assert len(log) == spans
    assert [e["name"] for e in events] == [s.name for s in log]
    offset = statistics.median(e["ts"] - s.start_ns / 1e3
                               for e, s in zip(events, log))
    return max(max(abs(e["ts"] - s.start_ns / 1e3 - offset),
                   abs(e["ts"] + e["dur"] - s.end_ns / 1e3 - offset))
               for e, s in zip(events, log))


def test_the_chrome_trace_holds_the_spans(images, results, tmp_path):
    """The exported trace holds each span of the log under its name, and,
    after one offset, each agrees with the log's within 50 us. A thread
    preempted between the trace's stamp and the log's (a busy test
    machine) misses by more: the best of three rounds is held to it."""
    _trace_holds(images, results, tmp_path, 4 * 5)


def test_the_chrome_trace_holds_the_fronts_spans(images, results, tmp_path,
                                                 fronts):
    """As above, with the batch encode's two fronts' stage and replay."""
    _trace_holds(images, results, tmp_path, 4 * 5 + 4)


def _trace_holds(images, results, tmp_path, spans):
    for fn in FUNCTIONS:
        _call(fn, images, results)
    worst = [_trace_round(images, results, tmp_path / f"trace{k}.json",
                          spans)
             for k in range(3)]
    assert min(worst) < 50, worst


def test_nested_api_calls_share_the_request(images):
    """Images of two shapes go one by one through
    ``encode_image_device``: its spans lie under the outer call's, of its
    request."""
    mixed = [images[0], images[1][:, :32, :40]]
    pt.encode_images_device(mixed, SETTINGS, None, BITS, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        pt.encode_images_device(mixed, SETTINGS, None, BITS, "cpu")
        metrics.clear_spans()
        pt.encode_images_device(mixed, SETTINGS, None, BITS, "cpu")
    log = metrics.spans()
    (outer,) = [s for s in log if s.parent is None]
    assert outer.name == "spiht/api/encode_images_device"
    assert outer.counts == {"images": 2}
    inner = [s for s in log if s.name == "spiht/api/encode_image_device"]
    assert len(inner) == 2
    assert all(s.parent == outer.id and s.counts == {"images": 1}
               for s in inner)
    assert all(s.request == outer.id for s in log)
    assert len([s for s in log if s.parent in {i.id for i in inner}]) == 8


def test_a_span_left_open_closes_with_its_parent():
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("spiht/api/outer", images=1):
            metrics.open_span("spiht/encode/stage")  # a start that raised
        left = metrics.open_span("spiht/api/next")
        metrics.close_span(left)
        metrics.close_span(left)  # closed already: nothing more
    stage, outer, nxt = metrics.spans()
    assert (stage.name, outer.name, nxt.name) == (
        "spiht/encode/stage", "spiht/api/outer", "spiht/api/next")
    assert stage.parent == outer.id and stage.end_ns <= outer.end_ns
    assert stage.counts == {} and outer.counts == {"images": 1}
    assert nxt.parent is None and nxt.request == nxt.id


def test_the_log_is_bounded():
    assert metrics._SPANS.maxlen == metrics.SPAN_LIMIT > 1000


def test_stage_s_is_the_stage_span(images):
    """Every program measures its stage, traced or not; traced, its
    ``stage_s`` is the stage span's interval."""
    pt.encode_image_device(images[0], SETTINGS, None, BITS, "cpu")
    (prog,) = [p for p in tt.programs() if p.key[0] == "encode_batch"
               and p.key[2:6] == (1,) + SHAPE]
    prog.stage_s = 0.0
    pt.encode_image_device(images[0], SETTINGS, None, BITS, "cpu")
    assert prog.stage_s > 0
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.clear_spans()
        pt.encode_image_device(images[0], SETTINGS, None, BITS, "cpu")
    (stage,) = [s for s in metrics.spans() if s.name.endswith("/stage")]
    assert prog.stage_s == (stage.end_ns - stage.start_ns) / 1e9


def test_threads_keep_their_own_nesting():
    """Threads, more than the cores and switched often, each nest their
    spans in their own stack; the log loses none and repeats no id."""
    import sys
    import threading

    n, depth, rounds = 16, 3, 50
    metrics.clear_spans()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work(t):
                for _ in range(rounds):
                    opened = [metrics.open_span(f"spiht/t{t}/{d}")
                              for d in range(depth)]
                    for s in reversed(opened):
                        metrics.close_span(s)
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    log = metrics.spans()
    assert len(log) == n * depth * rounds
    assert len({s.id for s in log}) == len(log)
    by_id = {s.id: s for s in log}
    for s in log:
        thread, d = s.name.split("/")[1:]
        if d == "0":
            assert s.parent is None and s.request == s.id
        else:
            parent = by_id[s.parent]
            assert parent.name == f"spiht/{thread}/{int(d) - 1}"
            assert s.request == parent.request


def test_stage_s_spans_the_batch_encodes_fronts(images, fronts):
    """The batch encode's ``stage_s`` runs from its first stage span's
    start to its last one's end: the images' copies and the fronts'
    replays between them."""
    pt.encode_images_device(images, SETTINGS, None, BITS, "cpu")
    (prog,) = [p for p in tt.programs() if p.key[0] == "encode_batch"]
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.clear_spans()
        pt.encode_images_device(images, SETTINGS, None, BITS, "cpu")
    stages = [s for s in metrics.spans() if s.name.endswith("/stage")]
    assert len(stages) == 3
    assert prog.stage_s == (stages[-1].end_ns - stages[0].start_ns) / 1e9


def _batch_programs():
    return {k: p for p in tt.programs()
            for k in ("encode_batch", "decode_batch") if p.key[0] == k}


@pytest.mark.parametrize("shape, seq", [(SHAPE, 1), ((3, 48, 64), 0)],
                         ids=["odd-ll", "even-ll"])
def test_the_decode_replays_count_batched_b3(shape, seq):
    """At an odd LL (duplicate parents) each decode call sends its B
    streams through batched B3, its replay span counting ``seq`` 1; at an
    even LL (B5) and in the encode ``seq`` is 0."""
    rng = np.random.default_rng(23)
    ims = [rng.random(shape) for _ in range(3)]
    tt.clear_programs()
    ers = pt.encode_images_device(ims, SETTINGS, None, BITS, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.clear_spans()
        for _ in range(2):
            pt.decode_images_device(ers, SETTINGS, device="cpu")
    progs = _batch_programs()
    assert progs["decode_batch"].key[9] == ("b3" if seq else "b5")
    assert progs["decode_batch"].launch == {"streams": 3, "seq": seq}
    assert progs["encode_batch"].launch == {"streams": 3, "seq": 0}
    assert [s.counts for s in metrics.spans()
            if s.name.endswith("/replay")] == [{"streams": 3, "seq": seq}] * 2
    tt.clear_programs()


@pytest.mark.parametrize("ilv_b, launch", [
    (None, {"streams": 5, "seq": 1}),  # one launch of 5
    ("2", {"streams": 1, "seq": 1}),  # launches of 2, 2 and 1
    ("3", {"streams": 2, "seq": 1}),  # 3 and 2
    ("1", {"streams": 1, "seq": 0}),  # the map route: B3 a stream
])
def test_launch_counts_the_last_machine_launch(ilv_b, launch, monkeypatch):
    """``launch`` counts the streams of a call's last machine launch, in
    the decode and the encode alike, and the machine graph's replay span
    carries it; the fronts' replays carry nothing."""
    if ilv_b is not None:
        monkeypatch.setenv("SPIHT_TPU_PALLAS_ILV_B", ilv_b)
    monkeypatch.setattr(tt, "FRONT_BYTES", 1)
    rng = np.random.default_rng(24)
    ims = [rng.random(SHAPE) for _ in range(5)]
    tt.clear_programs()
    ers = pt.encode_images_device(ims, SETTINGS, None, BITS, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.clear_spans()
        pt.encode_images_device(ims, SETTINGS, None, BITS, "cpu")
        pt.decode_images_device(ers, SETTINGS, device="cpu")
    progs = _batch_programs()
    enc = dict(launch, seq=0)
    assert progs["encode_batch"].launch == enc
    assert progs["decode_batch"].launch == launch
    replays = [s.counts for s in metrics.spans()
               if s.name.endswith("/replay")]
    assert replays == [{}] * 5 + [enc, launch]
    tt.clear_programs()
