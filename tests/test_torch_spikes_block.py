"""The port of the two block TPU spikes (``spiht_tpu_torch/tools/
spike_pallas_block.py``, ``spike_token_matmul.py``) against the JAX spikes
in ``tools/`` on the CPU, at small sizes: each plain version equals the
spike's Pallas kernel run in interpret mode (``build(..., interpret=True)``),
loaded by path with nothing in ``tools/`` edited, int32 throughout (x64
off, as on the TPU). S5's plain version is the spike's own numpy model,
copied; the kernel equals it in every output, the words buffer, LSP and
LIP whole (they wrap at 24 iterations of 8 rows). S6's plain version is
the sequential token parse; each of the spike's four kinds equals it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiht_tpu_torch.tools import spike_pallas_block as tblock
from spiht_tpu_torch.tools import spike_token_matmul as ttok

from test_torch_spikes import _load_tool

ROWS = 8  # S5's state rows in the tests: 1024 entries an array


@pytest.fixture(scope="module")
def jblock():
    return _load_tool("spike_pallas_block")


@pytest.fixture(scope="module")
def jtok():
    return _load_tool("spike_token_matmul")


@pytest.mark.parametrize("niter", [0, 1, 24])
def test_block_equals_pallas_interpret(jblock, niter):
    mag = tblock.mag_of(ROWS)
    tri = np.triu(np.ones((tblock.LANES, tblock.LANES), np.float32), 1)
    with jax.enable_x64(False):
        fn = jblock.build(ROWS, True)
        want = [np.asarray(o) for o in fn(
            jnp.asarray(mag), jnp.asarray(tri),
            jnp.asarray([niter], jnp.int32))]
    got = tblock.block(torch.as_tensor(mag), niter)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if niter == 24:  # the LSP has wrapped: more commits than entries
        assert int(got[0][0, 1]) > ROWS * tblock.LANES


@pytest.mark.parametrize("k", [0, 16, 64])
@pytest.mark.parametrize("kind", ["vpu", "mxu", "mxu_bf16", "both"])
def test_token_heads_equal_pallas_interpret(jtok, kind, k):
    """The spike's kinds vpu, mxu, mxu_bf16 and both are the port's scan,
    mma_tf32, mma_bf16 and both; every one equals the sequential parse."""
    x = ttok.x_of()
    with jax.enable_x64(False):
        fn = jtok.build(kind, k, True)
        want = np.asarray(fn(jnp.asarray(x)))
    port = dict(vpu="scan", mxu="mma_tf32", mxu_bf16="mma_bf16")
    got = ttok.token_heads(torch.as_tensor(x), k, port.get(kind, kind))
    np.testing.assert_array_equal(got.numpy(), want)
    if k == 16:
        assert int(want[0, 0]) == 1361


def test_block_wrappers_refuse_what_the_kernels_do_not_take():
    mag = torch.as_tensor(tblock.mag_of(ROWS))
    with pytest.raises(ValueError, match="int32"):
        tblock.block(mag.long(), 1)
    with pytest.raises(ValueError, match="int32"):
        tblock.block(mag[:, :64], 1)
    with pytest.raises(ValueError, match="one row"):
        tblock.block(mag[:0], 1)
    with pytest.raises(ValueError, match="niter"):
        tblock.block(mag, tblock.MAX_ITER + 1)
    x = torch.as_tensor(ttok.x_of())
    with pytest.raises(ValueError, match="kind"):
        ttok.token_heads(x, 4, "mxu")
    with pytest.raises(ValueError, match="int32"):
        ttok.token_heads(x[:32], 4)
    with pytest.raises(ValueError, match="int32"):
        ttok.token_heads(x.float(), 4)
    with pytest.raises(ValueError, match="k must"):
        ttok.token_heads(x, -1)
