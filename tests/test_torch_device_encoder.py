"""The port's sorted-space encode machine (spiht_tpu_torch.codec.
device_encoder) against the JAX package's (spiht_tpu.codec.device_encoder,
which routes to its XLA machine ``_build`` on the CPU): bytes and max_n
equal, the lockstep batch stream by stream, the packed-lane sort, the
odd-LL and capacity errors where the JAX package raises them, and the
routing flags on the CPU. The order prototype copy is held to its
original's predictions."""

import functools

import numpy as np
import pytest
import torch

from spiht_tpu.codec import device_encoder as jde
from spiht_tpu.codec import order_prototype as jop

from spiht_tpu_torch.codec import device_encoder as tde
from spiht_tpu_torch.codec import order_prototype as top

from helpers.reference_native import load as reference_native

torch.set_num_threads(1)

# tests/test_device_encoder.py's four geometries and budgets
GEOMS = [
    ((1, 16, 16), (4, 4), 10**9),
    ((3, 24, 32), (6, 8), 3000),
    ((2, 34, 18), (4, 2), 555),
    ((1, 64, 64), (8, 8), 8192),
]


def _random_geoms(n, seed):
    """Seeded even-LL geometries, one to three levels with odd growth."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = int(rng.integers(1, 3))
        ll_h = 2 * int(rng.integers(1, 4))
        ll_w = 2 * int(rng.integers(1, 4))
        h, w = ll_h, ll_w
        for _ in range(int(rng.integers(1, 4))):
            h = 2 * h + int(rng.integers(0, 2))
            w = 2 * w + int(rng.integers(0, 2))
        mb = int(rng.integers(50, 4 * c * h * w))
        out.append(((c, h, w), (ll_h, ll_w), mb))
    return out


@functools.lru_cache(maxsize=None)
def _jax_fn(c, h, w, ll_h, ll_w):
    """The JAX package's jitted machine for one geometry: its
    ``encode_device`` builds a new jit each call, so the tests keep one."""
    return jde.encode_device_fn(c, h, w, ll_h, ll_w)


def _jax_encode(arr, ll, mb):
    """``jde.encode_device`` on the CPU (its XLA machine), with one
    compiled program per geometry."""
    from spiht_tpu.codec.oracle import compute_max_n

    max_n = compute_max_n(arr)
    words, total, overflow = _jax_fn(*arr.shape, *ll)(
        arr, max_n, min(int(mb), 2**31 - 2))
    assert not bool(overflow)
    data = np.asarray(words).view(np.uint8)[: (int(total) + 7) // 8]
    return data.tobytes(), max_n


def _check(arr, ll, mb):
    want = _jax_encode(arr, ll, mb)
    got = tde.encode_device(arr, *ll, mb, device="cpu")
    assert got == want
    return got


@pytest.mark.parametrize("shape,ll,mb", GEOMS + _random_geoms(3, 2024))
def test_encoder_equals_jax(shape, ll, mb):
    rng = np.random.default_rng(sum(shape) + mb)
    arr = (rng.standard_normal(shape) * 300).astype(np.int32)
    # once through the JAX package's own entry point
    assert tde.encode_device(arr, *ll, mb, device="cpu") == (
        jde.encode_device(arr, *ll, mb))
    for scale in (5, 300, 4000):
        arr = (rng.standard_normal(shape) * scale).astype(np.int32)
        data, _ = _check(arr, ll, mb)
        # the unbounded stream, and a budget cut inside it
        full, _ = _check(arr, ll, 10**9)
        assert full[: len(data) - 1] == data[: len(data) - 1]


def test_zero_and_sparse():
    arr = np.zeros((1, 16, 16), dtype=np.int32)
    assert _check(arr, (4, 4), 10**9)[1] == 0
    arr[0, 9, 3] = -777
    arr[0, 0, 1] = 12
    _check(arr, (4, 4), 10**9)


def test_odd_ll_raises_as_jax():
    arr = (np.random.default_rng(5).standard_normal((1, 12, 12)) * 100
           ).astype(np.int32)
    with pytest.raises(ValueError, match="even ll"):
        jde.encode_device(arr, 3, 3, 1000)
    with pytest.raises(ValueError, match="even ll"):
        tde.encode_device(arr, 3, 3, 1000, device="cpu")


def test_adversarial_stream_exact():
    """One huge magnitude per 2x2 sibling group keeps everything in the
    lists for every plane: bit-exact at the full stream, within the
    machine's 48 bits a cell."""
    arr = np.random.default_rng(8).choice([-1, 1], size=(1, 32, 32)).astype(
        np.int32)
    arr[0, ::2, ::2] = 2**31 - 1
    data, max_n = _check(arr, (4, 4), 10**9)
    assert max_n == 31 and len(data) > 3000


def test_capacity_overflow_where_jax_raises(monkeypatch):
    """With a capacity of one bit a cell, both machines flag the overflow
    with the same true length, and both wrappers raise CapacityOverflow
    with the same numbers."""
    arr = (np.random.default_rng(7).standard_normal((1, 16, 16)) * 1000
           ).astype(np.int32)
    from spiht_tpu.codec.oracle import compute_max_n

    max_n = compute_max_n(arr)
    jw, jt, jo = jde.encode_device_fn(1, 16, 16, 4, 4, bits_per_cell=1)(
        arr, max_n, 10**9)
    tw, tt, to = tde.encode_device_fn(1, 16, 16, 4, 4, bits_per_cell=1)(
        torch.as_tensor(arr), max_n, 10**9)
    assert bool(jo) and bool(to) and int(jt) == int(tt)
    np.testing.assert_array_equal(
        np.asarray(jw).view(np.int32), tw.numpy())
    errs = []
    for mod in (jde, tde):
        monkeypatch.setattr(mod, "_CAP_BITS_PER_CELL", 1)
        monkeypatch.setattr(mod, "encode_device_fn", functools.partial(
            mod.encode_device_fn, bits_per_cell=1))
        kw = {"device": "cpu"} if mod is tde else {}
        with pytest.raises(mod.CapacityOverflow) as e:
            mod.encode_device(arr, 4, 4, 10**9, **kw)
        errs.append((e.value.needed, e.value.cap))
    assert errs[0] == errs[1]
    # under the capacity the stream needs, no error
    assert tde.encode_device(arr, 4, 4, 1024, device="cpu")


def test_pack_lanes_and_sort_payload_equal_jax():
    """The lanes, placements and widths of one field list, and the sorted
    payloads of a three-key sort whose fields split across lane
    boundaries, equal the JAX package's."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n = 257
    k0 = rng.integers(0, 1 << 7, n).astype(np.int32)
    k1 = rng.integers(0, 1 << 19, n).astype(np.int32)
    k2 = rng.permutation(n).astype(np.int32)
    p0 = rng.integers(0, 1 << 9, n).astype(np.int32)
    p1 = rng.integers(0, 1 << 4, n).astype(np.int32)
    present = rng.random(n) < 0.7
    fields = [(k0, 7, "a"), (k1, 19, "b"), (k2, 11, "c"), (p0, 9, "d"),
              (p1, 4, "e")]
    jl, jp, jw = jde._pack_lanes(
        [(jnp.asarray(a), nb, t) for a, nb, t in fields], n)
    tl, tp, tw = tde._pack_lanes(
        [(torch.as_tensor(a), nb, t) for a, nb, t in fields], n)
    assert (tp, tw) == (jp, jw) and len(tl) == 2
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    keys = [(k0, 7), (k1, 19), (k2, 11)]
    pays = [(p0, 9), (p1, 4)]
    (j0, j1), jc = jde._sort_payload(
        [(jnp.asarray(a), nb) for a, nb in keys],
        [(jnp.asarray(a), nb) for a, nb in pays], jnp.asarray(present))
    (t0, t1), tc = tde._sort_payload(
        [(torch.as_tensor(a), nb) for a, nb in keys],
        [(torch.as_tensor(a), nb) for a, nb in pays],
        torch.as_tensor(present))
    assert int(tc) == int(jc) == int(present.sum())
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    # five lanes (more than two pairs) sort as the key tuple does
    lanes = [torch.as_tensor(rng.integers(0, 3, n).astype(np.int32))
             for _ in range(4)] + [torch.as_tensor(k2)]
    got = tde._lex_sort(lanes)
    order = np.lexsort([lane.numpy() for lane in lanes[::-1]])
    for lane, g in zip(lanes, got):
        np.testing.assert_array_equal(g.numpy(), lane.numpy()[order])


def test_lane_counts():
    """The lanes of the machine's three sorts: at the test geometries LIP
    1, LIS 2, refinement 1 (one torch.sort each); at configuration A
    (3x537x537, LL 12x12) 2, 3 and 2 (one, two and one torch.sort)."""
    for (c, h, w), ll, _ in GEOMS:
        assert tde._build(c, h, w, *ll, 64).lanes == dict(lip=1, lis=2,
                                                          ref=1)
    m = tde._build(3, 537, 537, 12, 12, 64)
    assert m.lanes == dict(lip=2, lis=3, ref=2)


def test_batch_equals_jax_stream_by_stream():
    rng = np.random.default_rng(12)
    arrs = (rng.standard_normal((4, 2, 16, 16)) * 300).astype(np.int32)
    arrs[2] = 0
    mbs = [200, 10**6, 64, 999]
    got = tde.encode_device_batch(arrs, 4, 4, mbs, device="cpu")
    assert got == jde.encode_device_batch(arrs, 4, 4, mbs)
    for b in range(4):
        assert got[b] == tde.encode_device(arrs[b], 4, 4, mbs[b],
                                           device="cpu")
    assert tde.encode_device_batch(arrs[:2], 4, 4, 333, device="cpu") == [
        tde.encode_device(a, 4, 4, 333, device="cpu") for a in arrs[:2]]


@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_routing_flag_on_cpu(flag, monkeypatch):
    """SPIHT_TPU_PALLAS_ENCODER=1 runs kernel B1's (B4's) plain version on
    the CPU, 0 or unset the machine: all three equal."""
    from spiht_tpu_torch.codec import encoder

    rng = np.random.default_rng(13)
    arrs = (rng.standard_normal((2, 3, 24, 32)) * 900).astype(np.int32)
    want = [_jax_encode(a, (6, 8), 3000) for a in arrs]
    calls = []
    for name in ("encode", "encode_batch"):
        real = getattr(encoder, name)
        monkeypatch.setattr(encoder, name, functools.partial(
            lambda real, name, *a, **k: calls.append(name) or real(*a, **k),
            real, name))
    if flag is None:
        monkeypatch.delenv("SPIHT_TPU_PALLAS_ENCODER", raising=False)
    else:
        monkeypatch.setenv("SPIHT_TPU_PALLAS_ENCODER", flag)
    assert tde.encode_device(arrs[0], 6, 8, 3000, device="cpu") == want[0]
    assert tde.encode_device_batch(arrs, 6, 8, 3000, device="cpu") == want
    assert calls == (["encode", "encode_batch"] if flag == "1" else [])


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = np.zeros((1, 16, 16), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tde.encode_device(arr, 4, 4, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tde.encode_device_batch(arr[None], 4, 4, 100)


def test_order_prototype_copy_predicts_as_original():
    reference_native()  # the original needs the reference's native kernel
    rng = np.random.default_rng(14)
    arr = (rng.standard_normal((2, 24, 32)) * 300).astype(np.int32)
    from spiht_tpu.codec.oracle import compute_max_n

    mn = compute_max_n(arr)
    assert top.predict_events(arr, 6, 8, mn) == jop.predict_events(
        arr, 6, 8, mn)
    np.testing.assert_array_equal(top.predict_bits(arr, 6, 8, mn),
                                  jop.predict_bits(arr, 6, 8, mn))
