"""The port's encode machine (the plain version of kernel B1, which is what
runs on the CPU) against the JAX package's Pallas hybrid machine in
interpret mode and against its native encoder: bytes and max_n equal,
full streams and budget cuts, odd-LL geometries included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spiht_tpu.codec import api as japi
from spiht_tpu.codec.oracle import compute_max_n
from spiht_tpu.codec.pallas_encoder import _cap_words_for, pallas_encode_fn

from spiht_tpu_torch.codec import encoder

torch.set_num_threads(1)

CUTS = (1, 2, 3, 64, 333, 1000, 2897)


@pytest.mark.parametrize(
    "shape,ll,seed",
    [
        ((3, 24, 32), (6, 8), 1),
        ((2, 21, 13), (3, 2), 2),
        ((3, 19, 19), (5, 5), 3),  # odd LL: duplicate parents
    ],
)
def test_plain_encoder_matches_pallas_hybrid(shape, ll, seed):
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal(shape) * 400).astype(np.int32)
    # one interpret-mode compile at full capacity; budgets are runtime
    fn = pallas_encode_fn(
        *shape, *ll, _cap_words_for(*shape, 2**31 - 2), interpret=True,
        machine="hybrid",
    )
    mn = compute_max_n(arr)
    for mb in (2**31 - 2,) + CUTS:
        words, total, overflow = fn(jnp.asarray(arr), mn, mb)
        assert not bool(overflow)
        want = np.asarray(words).view(np.uint8)[: (int(total) + 7) // 8]
        got, got_mn = encoder.encode(arr, *ll, mb, device="cpu")
        assert got_mn == mn
        assert got == want.tobytes(), f"max_bits={mb}"


@pytest.mark.parametrize(
    "shape,ll",
    [
        ((1, 16, 16), (4, 4)),
        ((2, 34, 18), (4, 2)),
        ((3, 40, 40), (5, 5)),
        ((3, 70, 70), (12, 12)),
        ((2, 33, 47), (9, 6)),
        ((1, 89, 89), (5, 5)),
    ],
)
def test_plain_encoder_matches_native(shape, ll):
    rng = np.random.default_rng(sum(shape))
    for scale in (3, 400, 30000):
        arr = (rng.standard_normal(shape) * scale).astype(np.int32)
        for mb in (2**31 - 2,) + CUTS:
            want = japi.encode(arr, *ll, mb)
            got = encoder.encode(arr, *ll, mb, device="cpu")
            assert got == want, (scale, mb)


def test_extreme_magnitudes_and_zeros():
    for v in (0, 1, 2**22, 2**25 - 2, -(2**30)):
        arr = np.zeros((1, 16, 16), np.int32)
        arr[0, 3, 5] = v
        arr[0, 9, 1] = -7
        assert encoder.encode(arr, 4, 4, device="cpu") == japi.encode(
            arr, 4, 4, 2**31 - 2
        )


def test_encode_tables_layout():
    arr = torch.tensor(
        np.random.default_rng(0).standard_normal((2, 16, 16)) * 100,
        dtype=torch.float64,
    ).to(torch.int32)
    t1, t3s = encoder.encode_tables(arr, 4, 4)
    flat = arr.reshape(-1)
    assert torch.equal(t3s & 0x7FFFFFFF, flat.abs())
    assert torch.equal((t3s < 0), flat >= 0)
    assert torch.equal(((t1 >> 18) & 1).bool(), flat >= 0)
    m = (t1 & 63) - 1
    want_m = torch.where(
        flat == 0, -1, torch.floor(torch.log2(flat.abs().double())).long()
    )
    assert torch.equal(m.long(), want_m)


def test_stream_capacity_error_raises():
    """The buffer is sized from the budget, so the capacity error cannot
    occur through encode(); a machine told its budget was clamped to the
    buffer reports it when it runs out, and check_stat raises."""
    arr = torch.tensor(
        (np.random.default_rng(1).standard_normal((1, 16, 16)) * 300)
    ).to(torch.int32)
    args = list(encoder.machine_args(arr, 4, 4, 128))
    assert args[7:9] == [128, False]
    args[8] = True
    words, stat = encoder.encode_machine(*args)
    assert stat.tolist()[:2] == [128, 1]
    with pytest.raises(RuntimeError, match="word buffer"):
        encoder.check_stat(stat, "spiht_encode")


def test_wrapper_checks_inputs():
    t = torch.zeros(16, dtype=torch.int32)
    caps = (16, 16, 16)
    with pytest.raises(ValueError, match="int32"):
        encoder.encode_machine(
            t.long(), t, t, t[:1], t[:1], 4, 0, 8, False, caps, 1
        )
    with pytest.raises(ValueError, match="max_bits"):
        encoder.encode_machine(t, t, t, t[:1], t[:1], 4, 0, 64, False, caps, 1)
    with pytest.raises(ValueError, match="2\\^29"):
        encoder.check_geometry(3, 16384, 16384, 64, 64)
