"""The port's hybrid and sequential decode machines (spiht_tpu_torch.codec.
device_decoder) against the JAX package's (spiht_tpu.codec.device_decoder,
which routes to its XLA machines ``_build_hybrid`` and ``_build_decoder``
on the CPU): int32 rec and int32 traces equal, byte prefixes, budget cuts
and odd LL included, the lockstep batch, and the routing flags on the
CPU. The JAX programs take the stream's word count as a static argument
and its bit count as a dynamic one, so each stream's prefixes run through
one JAX program compiled at the full stream's word count."""

import functools

import numpy as np
import pytest
import torch

from spiht_tpu.codec import device_decoder as jdd

from spiht_tpu_torch.codec import device_decoder as tdd

from helpers.reference_native import load as reference_native

torch.set_num_threads(1)

# tests/test_device_decoder.py's five geometries, odd LL included
GEOMS = [
    ((1, 16, 16), (4, 4)),
    ((3, 24, 32), (6, 8)),
    ((2, 34, 18), (4, 2)),
    ((1, 19, 19), (5, 5)),
    ((2, 21, 13), (3, 2)),
]


def _encode(arr, ll, max_bits=10**9):
    return reference_native().encode(arr, *ll, max_bits)


def _cw(data) -> int:
    return max((len(data) * 8 + 31) // 32, 1)


def _jax_prefix(fn, data, cut, cw, mn):
    """The JAX machine ``fn`` (compiled for ``cw`` words) on a byte
    prefix: the prefix's words zero-padded and its bit count."""
    return fn(jdd._words_of(data[:cut], cw), cut * 8, mn)


def _cuts(n):
    return sorted({0, 1, 7, n // 3, n // 2, n - 1, n})


@pytest.mark.parametrize("shape,ll", GEOMS)
def test_hybrid_equals_jax_with_prefixes(shape, ll):
    rng = np.random.default_rng(sum(shape))
    arr = (rng.standard_normal(shape) * rng.choice([7, 400, 3000])).astype(
        np.int32)
    data, mn = _encode(arr, ll)
    want = jdd.decode_device(data, mn, *shape, *ll)
    np.testing.assert_array_equal(
        tdd.decode_device(data, mn, *shape, *ll, device="cpu"), want)
    cw = _cw(data)
    fn = jdd.decode_device_fn(*shape, *ll, cw)
    for cut in _cuts(len(data)):
        got = tdd.decode_device(data[:cut], mn, *shape, *ll, device="cpu")
        np.testing.assert_array_equal(
            got, np.asarray(_jax_prefix(fn, data, cut, cw, mn)),
            err_msg=f"cut={cut}")


def test_budget_cut_and_zero_stream():
    """Streams cut by the encoder's budget, and the empty stream."""
    rng = np.random.default_rng(21)
    arr = (rng.standard_normal((1, 32, 32)) * 900).astype(np.int32)
    full, mn = _encode(arr, (4, 4))
    cw = _cw(full)
    fn = jdd.decode_device_fn(1, 32, 32, 4, 4, cw)
    for mb in (64, 333, 1000):
        data, _ = _encode(arr, (4, 4), mb)
        got = tdd.decode_device(data, mn, 1, 32, 32, 4, 4, device="cpu")
        np.testing.assert_array_equal(
            got, np.asarray(_jax_prefix(fn, data, len(data), cw, mn)))
    got = tdd.decode_device(b"", 5, 1, 8, 8, 2, 2, device="cpu")
    np.testing.assert_array_equal(
        got, jdd.decode_device(b"", 5, 1, 8, 8, 2, 2))
    assert not got.any()


def _wire_level2():
    from spiht_tpu import SpihtSettings, get_slices_and_h_w

    slices, ph, pw = get_slices_and_h_w(24, 24, SpihtSettings(), 2)
    ll = (slices[0][1].stop, slices[0][2].stop)
    top = ((0, ll[0]), (0, ll[1]))
    other = tuple(
        tuple(((s[k][1].start, s[k][1].stop), (s[k][2].start, s[k][2].stop))
              for k in ("da", "ad", "dd"))
        for s in slices[1:])
    return (2, ph, pw), ll, top, other, 2000


def _wire_odd_clamp():
    """tests/test_device_decoder.py:196: overlap chains longer than the
    nominal level, the child depth clamped at 0."""
    top = ((0, 3), (0, 3))
    other = (
        (((3, 6), (0, 3)), ((0, 3), (3, 6)), ((3, 6), (3, 6))),
        (((6, 12), (0, 6)), ((0, 6), (6, 12)), ((6, 12), (6, 12))),
    )
    return (1, 12, 12), (3, 3), top, other, 10**9


@pytest.mark.parametrize("wire", [_wire_level2, _wire_odd_clamp],
                         ids=["level2", "odd_ll_depth_clamp"])
def test_sequential_trace_equals_jax(wire):
    """rec and the (nbits+1, 8) trace of the full stream and of byte
    prefixes, exactly. The JAX program is compiled for the full stream's
    rows; a prefix's trace is its first nbits+1 rows, the rest zero."""
    shape, ll, top, other, mb = wire()
    arr = (np.random.default_rng(22).standard_normal(shape) * 5000).astype(
        np.int32)
    data, mn = _encode(arr, ll, mb)
    level = len(other)
    rect = tuple(map(tuple, jdd._rect_table(
        level, *ll, (top, other)).reshape(-1, 4)))
    cw = _cw(data)
    fn = jdd.decode_device_fn(*shape, *ll, cw, level=level, rect_tab=rect,
                              meta_rows=len(data) * 8 + 1)
    for cut in (3, 17, 60, len(data)):
        jrec, jmeta = map(np.asarray, _jax_prefix(fn, data, cut, cw, mn))
        rec, meta = tdd.decode_device_with_metadata(
            data[:cut], mn, *shape, *ll, top, other, device="cpu")
        np.testing.assert_array_equal(rec, jrec, err_msg=f"cut={cut}")
        assert meta.shape == (cut * 8 + 1, 8) and meta.dtype == np.int32
        np.testing.assert_array_equal(meta, jmeta[: cut * 8 + 1],
                                      err_msg=f"cut={cut}")
        assert not jmeta[cut * 8 + 1:].any()
    # once through the JAX package's own entry point
    wr, wm = jdd.decode_device_with_metadata(data, mn, *shape, *ll, top,
                                             other)
    np.testing.assert_array_equal(rec, wr)
    np.testing.assert_array_equal(meta, wm)


def test_batch_equals_jax_stream_by_stream():
    """Mixed budgets and a prefix: streams of different lengths in one
    lockstep batch, each equal to the JAX batch's and to the
    single-stream machine's."""
    rng = np.random.default_rng(24)
    arrs = (rng.standard_normal((4, 1, 16, 16)) * 400).astype(np.int32)
    datas, ns = [], []
    for b, mb in enumerate([150, 10**6, 64, 500]):
        d, mn = _encode(arrs[b], (4, 4), mb)
        datas.append(d)
        ns.append(mn)
    datas[1] = datas[1][:41]
    got = tdd.decode_device_batch(datas, ns, 1, 16, 16, 4, 4, device="cpu")
    np.testing.assert_array_equal(
        got, jdd.decode_device_batch(datas, ns, 1, 16, 16, 4, 4))
    for b in range(4):
        np.testing.assert_array_equal(got[b], tdd.decode_device(
            datas[b], ns[b], 1, 16, 16, 4, 4, device="cpu"))
    # odd LL, one max_n for every stream
    arr = (rng.standard_normal((1, 19, 19)) * 900).astype(np.int32)
    d, mn = _encode(arr, (5, 5))
    odd = [d, d[:9], d[: len(d) // 2]]
    got = tdd.decode_device_batch(odd, mn, 1, 19, 19, 5, 5, device="cpu")
    for b, x in enumerate(odd):
        np.testing.assert_array_equal(got[b], tdd.decode_device(
            x, mn, 1, 19, 19, 5, 5, device="cpu"))


def _count_calls(monkeypatch, module, names):
    calls = []
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name, functools.partial(
            lambda real, name, *a, **k: calls.append(name) or real(*a, **k),
            real, name))
    return calls


@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_routing_flags_on_cpu(flag, monkeypatch):
    """SPIHT_TPU_PALLAS_DECODER=1 runs the kernels' plain versions on the
    CPU (B3 here, odd LL; batched B3), 0 or unset the hybrid machine;
    SPIHT_TPU_PALLAS_META follows the decoder's flag when unset (B3-log
    and the expansion, or the sequential machine). All equal."""
    from spiht_tpu_torch.codec import decoder, meta_expand

    shape, ll, top, other, mb = _wire_odd_clamp()
    arr = (np.random.default_rng(25).standard_normal(shape) * 900).astype(
        np.int32)
    data, mn = _encode(arr, ll, mb)
    cut = data[: len(data) // 2]
    want = tdd.decode_device(cut, mn, *shape, *ll, device="cpu")
    want_meta = tdd.decode_device_with_metadata(cut, mn, *shape, *ll, top,
                                                other, device="cpu")
    calls = _count_calls(monkeypatch, decoder, ["decode", "decode_batch"])
    calls_m = _count_calls(monkeypatch, meta_expand, ["decode_with_metadata"])
    monkeypatch.delenv("SPIHT_TPU_PALLAS_META", raising=False)
    if flag is None:
        monkeypatch.delenv("SPIHT_TPU_PALLAS_DECODER", raising=False)
    else:
        monkeypatch.setenv("SPIHT_TPU_PALLAS_DECODER", flag)
    np.testing.assert_array_equal(
        tdd.decode_device(cut, mn, *shape, *ll, device="cpu"), want)
    got = tdd.decode_device_batch([cut, data], mn, *shape, *ll,
                                  device="cpu")
    np.testing.assert_array_equal(got[0], want)
    rec, meta = tdd.decode_device_with_metadata(cut, mn, *shape, *ll, top,
                                                other, device="cpu")
    np.testing.assert_array_equal(rec, want_meta[0])
    np.testing.assert_array_equal(meta, want_meta[1])
    kernel = flag == "1"
    assert calls == (["decode", "decode_batch"] if kernel else [])
    assert calls_m == (["decode_with_metadata"] if kernel else [])
    # the trace's own flag overrides the decoder's
    monkeypatch.setenv("SPIHT_TPU_PALLAS_META", "0" if kernel else "1")
    rec, meta = tdd.decode_device_with_metadata(cut, mn, *shape, *ll, top,
                                                other, device="cpu")
    np.testing.assert_array_equal(meta, want_meta[1])
    assert calls_m == ["decode_with_metadata"]


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: tdd.decode_device(b"\x01", 3, 1, 8, 8, 2, 2),
        lambda: tdd.decode_device_batch([b"\x01"], 3, 1, 8, 8, 2, 2),
        lambda: tdd.decode_device_with_metadata(
            b"\x01", 3, 1, 8, 8, 2, 2, ((0, 2), (0, 2)), ()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_ladder_table_equals_the_bit_ladder():
    """Every (window, bits left) entry of the offspring-ladder table
    against the reference ladder run on the same bits, in torch."""
    tab = tdd._ladder_table()
    assert tab.shape == (256 * 9,)
    x = torch.arange(256).repeat_interleave(9)
    left = torch.arange(9).repeat(256)
    consumed = torch.zeros_like(x)
    dead = torch.zeros_like(x, dtype=torch.bool)
    want = torch.zeros_like(x)
    for k in range(4):
        uset = ~dead
        okt = uset & (consumed < left)
        bt = (((x >> consumed) & 1) == 1) & okt
        dt = uset & ~okt
        consumed = consumed + okt.long()
        oks = bt & (consumed < left) & ~dt
        bs = (((x >> consumed) & 1) == 1) & oks
        ds = bt & ~oks & ~dt
        consumed = consumed + oks.long()
        dead = dead | dt | ds
        for j, f in enumerate((okt, bt, oks, bs, uset)):
            want |= f.long() << (4 * j + k)
    want |= (consumed << 20) | (dead.long() << 24)
    np.testing.assert_array_equal(tab, want.numpy())
