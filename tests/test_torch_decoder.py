"""The port's decode machines (the plain versions of kernels B2 and B3,
which are what runs on the CPU) against the JAX package's Pallas decoders
in interpret mode and its native decoder: int32 rec equal, byte-prefix
truncation included, and odd-LL geometries routed to the seq machine."""

import numpy as np
import pytest
import torch

from spiht_tpu.codec import api as japi
from spiht_tpu.codec import pallas_decoder as jpd
from spiht_tpu.codec.device_decoder import _words_of

from spiht_tpu_torch.codec import decoder, encoder

torch.set_num_threads(1)


def _prefixes(n):
    return sorted({0, 1, 7, n // 3, n // 2, n - 1, n})


@pytest.mark.parametrize(
    "shape,ll,seed",
    [
        ((3, 24, 32), (6, 8), 1),
        ((2, 21, 13), (3, 2), 2),  # odd LL rows: the seq machine
        ((3, 19, 19), (5, 5), 3),  # odd LL: the seq machine
    ],
)
def test_plain_decoders_match_pallas(shape, ll, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal(shape) * 400).astype(np.int32)
    data, mn = japi.encode(arr, *ll, 2**31 - 2)
    seq = ll[0] % 2 == 1 or ll[1] % 2 == 1
    assert decoder.has_duplicate_parents(*shape[1:], *ll) == seq
    assert jpd._has_duplicate_parents(*shape[1:], *ll) == seq
    called = []
    for name in ("decode_lsp", "decode_seq"):
        real = getattr(decoder, name)
        monkeypatch.setattr(
            decoder, name,
            lambda *a, _r=real, _n=name: called.append(_n) or _r(*a),
        )
    # one interpret-mode compile; the prefix length is a runtime argument
    cap = max((len(data) * 8 + 31) // 32, 1)
    fn = jpd.pallas_decode_fn(*shape, *ll, cap, True)
    words = _words_of(data, cap)
    for nbytes in _prefixes(len(data)):
        want = np.asarray(fn(words, nbytes * 8, mn))
        got = decoder.decode(data[:nbytes], mn, *shape, *ll, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, f"{nbytes} bytes")
    assert set(called) == {"decode_seq" if seq else "decode_lsp"}


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
def test_plain_decoders_match_native(shape, ll):
    rng = np.random.default_rng(sum(shape))
    for scale in (3, 400, 30000):
        arr = (rng.standard_normal(shape) * scale).astype(np.int32)
        data, mn = japi.encode(arr, *ll, 2**31 - 2)
        for nbytes in _prefixes(len(data)):
            want = japi.decode(data[:nbytes], mn, *shape, *ll)
            got = decoder.decode(data[:nbytes], mn, *shape, *ll, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)


def test_round_trip_with_plain_encoder():
    arr = (np.random.default_rng(5).standard_normal((2, 16, 16)) * 500)
    arr = arr.astype(np.int32)
    data, mn = encoder.encode(arr, 4, 4, device="cpu")
    rec = decoder.decode(data, mn, 2, 16, 16, 4, 4, device="cpu")
    np.testing.assert_array_equal(rec.numpy(), japi.decode(data, mn, 2, 16, 16,
                                                           4, 4))


def test_int16_rec_option():
    arr = (np.random.default_rng(6).standard_normal((3, 24, 32)) * 900)
    arr = arr.astype(np.int32)
    data, mn = encoder.encode(arr, 6, 8, device="cpu")
    assert mn <= 13
    words, nbits = decoder.words_tensor(data, "cpu")
    r32 = decoder.decode_coeffs(words, nbits, mn, 3, 24, 32, 6, 8)
    r16 = decoder.decode_coeffs(words, nbits, mn, 3, 24, 32, 6, 8,
                                out_dtype=torch.int16)
    assert r16.dtype == torch.int16
    assert torch.equal(r16.to(torch.int32), r32)
    with pytest.raises(ValueError, match="max_n <= 13"):
        decoder.decode_coeffs(words, nbits, 14, 3, 24, 32, 6, 8,
                              out_dtype=torch.int16)


def test_scatter_rec_ignores_entries_past_the_count():
    lsp = torch.tensor([3, 0, 5, 7], dtype=torch.int32)
    val = torch.tensor([-(2**31) | 6, 4, 9, 11], dtype=torch.int32)
    stat = torch.tensor([2, 0, 0, 0, 2, 0], dtype=torch.int32)
    rec = decoder.scatter_rec(lsp, val, stat, 6)
    assert rec.tolist() == [-4, 0, 0, 6, 0, 0]
