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
