"""The port's batched machines (the plain versions of kernels B4, B5 and
batched B3, which are what runs on the CPU) against the JAX package: the
interleaved Pallas kernels in interpret mode (one case each, as they cost
seconds a case here) and the native host codec stream by stream."""

import numpy as np
import pytest
import torch

from spiht_tpu.codec import api as japi
from spiht_tpu.codec import pallas_decoder as jpd
from spiht_tpu.codec import pallas_encoder as jpe
from spiht_tpu.codec.oracle import compute_max_n

from spiht_tpu_torch.codec import decoder, encoder
from spiht_tpu_torch.codec.maxn import device_max_n

torch.set_num_threads(1)

FULL = 2**31 - 2


def _batch(seed, shape, scales):
    rng = np.random.default_rng(seed)
    return np.stack([
        (rng.standard_normal(shape) * s).astype(np.int32) for s in scales
    ])


def test_batch_encoder_matches_interleaved_pallas(monkeypatch):
    """Chains with different max_n and budgets that cut mid-symbol, and a
    zero image with a 1-bit budget beside full streams."""
    monkeypatch.setenv("SPIHT_TPU_PALLAS_ENC_BATCH", "ilv")
    arrs = _batch(1, (3, 24, 24), [1, 60, 12000, 3])
    arrs[3] = 0
    mbs = [1, 333, 2897, 500]
    want = jpe.pallas_encode_batch(arrs, 6, 6, mbs, interpret=True)
    got = encoder.encode_batch(arrs, 6, 6, mbs, device="cpu")
    assert got == want


def test_batch_decoder_matches_interleaved_pallas(monkeypatch):
    """Streams of different lengths in one batch, zero-padded to the
    longest: each stops at its own byte prefix."""
    monkeypatch.setenv("SPIHT_TPU_PALLAS_DEC_BATCH", "ilv")
    arrs = _batch(2, (3, 24, 24), [2000, 5, 60000])
    streams = [japi.encode(a, 6, 6, FULL) for a in arrs]
    datas = [streams[0][0][:7], streams[1][0][:1], streams[2][0][:100]]
    mns = [s[1] for s in streams]
    want = jpd.pallas_decode_batch(datas, mns, 3, 24, 24, 6, 6,
                                   interpret=True)
    got = decoder.decode_batch(datas, mns, 3, 24, 24, 6, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _route_spy(monkeypatch):
    called = []
    for name in ("decode_lsp_batch", "decode_seq_batch"):
        real = getattr(decoder, name)
        monkeypatch.setattr(
            decoder, name,
            lambda *a, _r=real, _n=name: called.append(_n) or _r(*a),
        )
    return called


@pytest.mark.parametrize(
    "shape,ll,scales",
    [
        ((1, 19, 19), (5, 5), [3000, 7, 900]),  # odd LL: batched B3
        ((3, 19, 19), (5, 5), [3000, 7, 900]),
        ((2, 21, 13), (3, 2), [400, 30000, 2]),  # odd LL rows
        ((2, 34, 18), (4, 2), [400, 30000, 2]),  # duplicate-free: B5
    ],
)
def test_batch_machines_match_native(shape, ll, scales, monkeypatch):
    arrs = _batch(sum(shape), shape, scales)
    seq = decoder.has_duplicate_parents(*shape[1:], *ll)
    for mbs in ([13, 222, FULL], [FULL] * 3, 1001):
        per = mbs if isinstance(mbs, list) else [mbs] * 3
        want = [japi.encode(arrs[b], *ll, per[b]) for b in range(3)]
        assert encoder.encode_batch(arrs, *ll, mbs, device="cpu") == want
    full = want
    called = _route_spy(monkeypatch)
    for cut in (1, 7, None):
        datas = [d[:cut] if cut else d for d, _ in full]
        datas[1] = full[1][0]  # one whole stream beside the prefixes
        mns = [mn for _, mn in full]
        got = decoder.decode_batch(datas, mns, *shape, *ll, device="cpu")
        for b in range(3):
            np.testing.assert_array_equal(
                got[b].numpy(), japi.decode(datas[b], mns[b], *shape, *ll))
    assert set(called) == {"decode_seq_batch" if seq else "decode_lsp_batch"}


def test_batch_encoder_beyond_compact_range():
    """max_n > 15 (the TPU's compact batch layout refused it): every
    stream is still encoded by the batched machine, as the host encodes
    it."""
    arrs = _batch(4, (1, 16, 16), [300, 5])
    arrs[0, 0, 3, 5] = 2**22
    arrs[1, 0, 9, 1] = -(2**17)
    got = encoder.encode_batch(arrs, 4, 4, [FULL, 700], device="cpu")
    assert [mn for _, mn in got] == [22, 17]
    assert got == [japi.encode(arrs[0], 4, 4, FULL),
                   japi.encode(arrs[1], 4, 4, 700)]


def test_batch_int16_rec_option():
    arrs = _batch(5, (3, 24, 32), [900, 40])
    full = encoder.encode_batch(arrs, 6, 8, device="cpu")
    assert max(mn for _, mn in full) <= 13
    words, nbits = decoder.words_batch([d for d, _ in full], "cpu")
    mns = [mn for _, mn in full]
    r32 = decoder.decode_coeffs_batch(words, nbits, mns, 3, 24, 32, 6, 8)
    r16 = decoder.decode_coeffs_batch(words, nbits, mns, 3, 24, 32, 6, 8,
                                      out_dtype=torch.int16)
    assert r16.dtype == torch.int16 and r32.shape == (2, 3, 24, 32)
    assert torch.equal(r16.to(torch.int32), r32)
    with pytest.raises(ValueError, match="max_n <= 13"):
        decoder.decode_coeffs_batch(words, nbits, [3, 14], 3, 24, 32, 6, 8,
                                    out_dtype=torch.int16)


def test_batch_tables_and_max_n_equal_per_image():
    arrs = _batch(6, (3, 24, 24), [1, 700, 40000])
    arrs[0] = 0
    t = torch.as_tensor(arrs)
    t1, t3s = encoder.encode_tables(t, 6, 6)
    mn = device_max_n(t)
    assert t1.shape == (3, 3 * 24 * 24) and mn.shape == (3,)
    for b in range(3):
        s1, s3 = encoder.encode_tables(t[b], 6, 6)
        assert torch.equal(t1[b], s1) and torch.equal(t3s[b], s3)
        assert int(mn[b]) == int(device_max_n(t[b])) == compute_max_n(arrs[b])


def test_scatter_rec_over_a_batch():
    lsp = torch.tensor([[3, 0, 5, 7], [1, 2, 0, 0]], dtype=torch.int32)
    val = torch.tensor([[-(2**31) | 6, 4, 9, 11], [5, -(2**31) | 3, 8, 8]],
                       dtype=torch.int32)
    stat = torch.tensor([[2, 0, 0, 0, 2, 0], [1, 0, 0, 0, 1, 0]],
                        dtype=torch.int32)
    rec = decoder.scatter_rec(lsp, val, stat, 6)
    assert rec.tolist() == [[-4, 0, 0, 6, 0, 0], [0, -5, 0, 0, 0, 0]]


def test_batch_budgets_and_capacity_rule():
    """One word buffer for the batch, sized from the largest budget; a
    stream whose budget the buffer cuts reports the capacity error; a
    negative budget is 0, as the JAX package's device machines read it."""
    arrs = torch.as_tensor(_batch(7, (1, 16, 16), [300, 300]))
    args = list(encoder.batch_machine_args(arrs, 4, 4, [100, 64]))
    assert args[9] == encoder.cap_words_for(1, 16, 16, 100) == 4
    assert args[7].tolist() == [100, 64]
    args[7] = torch.tensor([200, 64], dtype=torch.int32)  # 200 > 4 * 32
    words, stat = encoder.encode_machine_batch(*args)
    assert stat[:, :2].tolist() == [[128, 1], [64, 0]]
    with pytest.raises(RuntimeError, match="stream 0: the stream outgrew"):
        encoder.check_stat(stat, "spiht_encode_batch")
    with pytest.raises(ValueError, match="budgets"):
        encoder.batch_machine_args(arrs, 4, 4, [100])
    args = encoder.batch_machine_args(arrs, 4, 4, [100, -1])
    assert args[7].tolist() == [100, 0]


def test_batch_wrappers_check_inputs():
    t = torch.zeros(2, 16, dtype=torch.int32)
    one = torch.zeros(16, dtype=torch.int32)
    b2 = torch.zeros(2, dtype=torch.int32)
    caps = (16, 16, 16)
    with pytest.raises(ValueError, match="int32, 2-D"):
        encoder.encode_machine_batch(one, one, one, one[:1], one[:1], 4, b2,
                                     b2, caps, 1)
    with pytest.raises(ValueError, match="one entry per stream"):
        encoder.encode_machine_batch(t, t, one, one[:1], one[:1], 4, b2[:1],
                                     b2, caps, 1)
    # LL 2x2, the smallest the machines take (LL 1x1 is refused first)
    with pytest.raises(ValueError, match="nbits"):
        decoder.decode_coeffs_batch(t, [0, 33 * 16], [0, 0], 1, 4, 4, 2, 2)
    with pytest.raises(ValueError, match="need 2 nbits"):
        decoder.decode_coeffs_batch(t, [0], [0], 1, 4, 4, 2, 2)
