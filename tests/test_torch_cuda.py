"""Kernels on the card against their plain versions, at small shapes.

These need a CUDA device and nvcc; they skip without them. On a machine
with the card run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from spiht_tpu_torch.codec import decoder, encoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((3, 19, 19), (5, 5))])
def test_kernels_equal_plain_versions(cuda, shape, ll):
    arr = (np.random.default_rng(0).standard_normal(shape) * 400).astype(
        np.int32)
    for mb in (2**31 - 2, 1, 333, 1000):
        got = encoder.encode(arr, *ll, mb, device=cuda)
        assert got == encoder.encode(arr, *ll, mb, device="cpu")
    data, mn = got
    for cut in (len(data), len(data) // 2, 1):
        k = decoder.decode(data[:cut], mn, *shape, *ll, device=cuda)
        p = decoder.decode(data[:cut], mn, *shape, *ll, device="cpu")
        assert torch.equal(k.cpu(), p)


def test_wrappers_count_launches(cuda):
    arr = np.zeros((1, 16, 16), np.int32)
    arr[0, 2, 3] = 77
    n0 = encoder.encode_machine.launches
    data, mn = encoder.encode(arr, 4, 4, device=cuda)
    assert encoder.encode_machine.launches == n0 + 1
    n0 = decoder.decode_lsp.launches
    decoder.decode(data, mn, 1, 16, 16, 4, 4, device=cuda)
    assert decoder.decode_lsp.launches == n0 + 1


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((3, 19, 19), (5, 5))])
def test_batched_kernels_equal_plain_versions(cuda, shape, ll):
    """B4, then B5 (or batched B3 for the odd LL) on streams of different
    budgets and lengths: equal to the plain versions and, stream by
    stream, to the single-stream kernels."""
    rng = np.random.default_rng(1)
    arrs = np.stack([(rng.standard_normal(shape) * s).astype(np.int32)
                     for s in (400, 3, 9000, 60)])
    arrs[1] = 0
    mbs = [2**31 - 2, 1, 333, 2897]
    got = encoder.encode_batch(arrs, *ll, mbs, device=cuda)
    assert got == encoder.encode_batch(arrs, *ll, mbs, device="cpu")
    assert got == [encoder.encode(a, *ll, mb, device=cuda)
                   for a, mb in zip(arrs, mbs)]
    datas = [got[0][0], got[1][0], got[2][0][:7], got[3][0][:1]]
    mns = [mn for _, mn in got]
    k = decoder.decode_batch(datas, mns, *shape, *ll, device=cuda)
    p = decoder.decode_batch(datas, mns, *shape, *ll, device="cpu")
    assert torch.equal(k.cpu(), p)
    for b in range(4):
        one = decoder.decode(datas[b], mns[b], *shape, *ll, device=cuda)
        assert torch.equal(k[b], one)


def test_batched_wrappers_count_launches(cuda):
    arrs = np.zeros((3, 1, 16, 16), np.int32)
    arrs[:, 0, 2, 3] = [77, 5, 900]
    n0 = encoder.encode_machine_batch.launches
    got = encoder.encode_batch(arrs, 4, 4, device=cuda)
    assert encoder.encode_machine_batch.launches == n0 + 1
    n0 = decoder.decode_lsp_batch.launches
    decoder.decode_batch([d for d, _ in got], [m for _, m in got], 1, 16, 16,
                         4, 4, device=cuda)
    assert decoder.decode_lsp_batch.launches == n0 + 1
