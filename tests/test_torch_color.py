"""The port's colour models against the JAX package's, in float64 on the
CPU: every one of the 32 names both ways against ``jax_models.convert``
and against the numpy ``models.convert``, the round trip, a conversion
between two non-RGB models, and the quantized analysis through six models
against ``jax_transform.analysis_fn``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spiht_tpu import jax_transform
from spiht_tpu.color import jax_models
from spiht_tpu.color import models as nm
from spiht_tpu.settings import SpihtSettings as JSettings

from spiht_tpu_torch.color import torch_models
from spiht_tpu_torch.settings import SpihtSettings
from spiht_tpu_torch.torch_transform import _scaled_coeffs, forward

torch.set_num_threads(1)

MODELS = sorted(torch_models.REFERENCE_MODELS)

# The JAX package holds its jax models to numpy within 1e-10 (its round-2
# models, tests/test_color.py) and 1e-9 (its round-3 models); the port
# does better against both, so every forward is held to 1e-12 and every
# inverse to 1e-13. The differences are an ulp of pow, exp, log1p, atan2
# or a 3-term sum's order (numpy's matmul), scaled by values up to ~100.
FWD_ATOL = 1e-12
INV_ATOL = 1e-13


def _draw(seed, shape=(3, 12, 20)):
    """tests/test_color.py's draw: uniform in [0.01, 1)."""
    return np.random.default_rng(seed).uniform(0.01, 1.0, size=shape)


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax_and_numpy(name):
    im = _draw(MODELS.index(name))
    got = torch_models.convert(torch.as_tensor(im), "RGB", name).numpy()
    for want in (np.asarray(jax_models.convert(jnp.asarray(im), "RGB", name)),
                 nm.convert(im, "RGB", name)):
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL,
                                   err_msg=name)
    # the inverse on the reference's own model-space values
    fwd = nm.convert(im, "RGB", name)
    back = torch_models.convert(torch.as_tensor(fwd), name, "RGB").numpy()
    for want in (np.asarray(jax_models.convert(jnp.asarray(fwd), name,
                                               "RGB")),
                 nm.convert(fwd, name, "RGB")):
        np.testing.assert_allclose(back, want, rtol=0, atol=INV_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(back, im, rtol=0, atol=1e-6, err_msg=name)


def test_batched_and_between_models():
    """Leading batch dims ride along, and a conversion between two
    non-RGB models (through RGB) matches the JAX package's."""
    im = _draw(40, (2, 3, 6, 7))
    lab = torch_models.convert(torch.as_tensor(im), "RGB", "lab")
    for b in range(2):
        np.testing.assert_array_equal(
            lab[b].numpy(),
            torch_models.convert(torch.as_tensor(im[b]), "RGB", "lab"))
    got = torch_models.convert(lab, "CIE Lab", "OSA UCS").numpy()
    want = np.asarray(jax_models.convert(jnp.asarray(lab.numpy()), "cie lab",
                                         "osa ucs"))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


ANALYSIS = [
    ("lab", 2.0), ("oklab", 60.0), ("ycbcr", 50.0), ("jzazbz", 5000.0),
    ("cam16ucs", 2.0), ("osa ucs", 8.0),
]


def boundary_mismatches(got: np.ndarray, want: np.ndarray,
                        ref_float: np.ndarray) -> int:
    """The boundary rule: two int32 coefficient arrays may differ only
    where the reference float lies within 1e-9 * max(1, |v|) of an
    integer (an ulp of pow, exp, log1p or sqrt moving a truncation).
    Returns the count of such entries; raises on any other difference."""
    diff = got != want
    near = np.abs(ref_float - np.round(ref_float)) <= 1e-9 * np.maximum(
        1.0, np.abs(ref_float))
    bad = diff & ~near
    assert not bad.any(), f"{int(bad.sum())} coefficients differ off a boundary"
    return int(diff.sum())


@pytest.mark.parametrize("name,q", ANALYSIS, ids=[a[0] for a in ANALYSIS])
def test_quantized_analysis_matches_jax(name, q):
    kw = dict(color_model=name, quantization_scale=q)
    x = np.random.default_rng(len(name)).random((3, 40, 44))
    fn = jax_transform.analysis_fn(JSettings(**kw), 3, False, "float64")
    want = np.asarray(fn(jnp.asarray(x)))
    got, _, _ = forward(torch.as_tensor(x), SpihtSettings(**kw), 3)
    ref, _, _ = _scaled_coeffs(torch.as_tensor(x), SpihtSettings(**kw), 3,
                               torch.float64)
    assert np.abs(want).max() > 20, "the scale leaves too few planes"
    boundary_mismatches(got.numpy(), want, ref.numpy() * q)
