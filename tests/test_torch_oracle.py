"""The port's copy of the pure-Python oracle (``spiht_tpu_torch.codec.oracle``)
and of the bit packing (``spiht_tpu_torch.ops.bitpack``) against the JAX
package's originals, on seeded arrays: every output equal exactly, at
geometries up to 3x32x32 with even and odd LL and budgets from one bit to
the full stream. (``tests/test_torch_copies.py`` holds their code equal.)"""

import numpy as np
import pytest

from spiht_tpu.codec import oracle as jor
from spiht_tpu.ops import bitpack as jbp

from spiht_tpu_torch.codec import oracle as tor
from spiht_tpu_torch.ops import bitpack as tbp

# (c, h, w, ll_h, ll_w, level): even LL, odd LL (duplicate parents), and
# a non-square one; level is the dyadic pyramid's for the trace's slices
GEOMS = [
    (1, 16, 16, 4, 4, 2),
    (2, 24, 40, 3, 5, 3),
    (3, 32, 32, 8, 8, 2),
    (3, 28, 20, 7, 5, 2),
]
GEOM_IDS = ["1x16x16_ll4", "2x24x40_ll3x5", "3x32x32_ll8", "3x28x20_ll7x5"]
BUDGETS = [1, 17, 500, 2**40]


def _arr(geo, seed):
    c, h, w = geo[:3]
    rng = np.random.default_rng(seed)
    # a decaying spectrum, as coefficients are, with a few large values
    scale = 600.0 / (1.0 + np.add.outer(np.arange(h), np.arange(w)))
    arr = rng.normal(0, 1, (c, h, w)) * scale
    arr[:, 0, 0] += rng.integers(-3000, 3000, c)
    return arr.astype(np.int32)


def _wire(level, ll_h, ll_w):
    """The dyadic trace slices (top_slice, other_slices) of the pyramid."""
    other, hs, ws = [], ll_h, ll_w
    for _ in range(level):
        other.append([[(hs, hs * 2), (0, ws)], [(0, hs), (ws, ws * 2)],
                      [(hs, hs * 2), (ws, ws * 2)]])
        hs, ws = hs * 2, ws * 2
    return ([(0, ll_h), (0, ll_w)], other)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("geo", GEOMS, ids=GEOM_IDS)
def test_oracle_codec_equals_reference(geo, budget):
    """encode_bits, decode_bits and decode_bits_with_metadata (the rec and
    the 8-column trace) of the copy equal the original's, int for int."""
    c, h, w, ll_h, ll_w, level = geo
    arr = _arr(geo, sum(geo) + budget % 97)
    bits, mn = tor.encode_bits(arr, ll_h, ll_w, budget)
    jbits, jmn = jor.encode_bits(arr, ll_h, ll_w, budget)
    assert mn == jmn
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(jbits))
    stream = tbp.bytes_to_bits(tbp.bits_to_bytes(bits))
    rec = tor.decode_bits(stream, mn, c, h, w, ll_h, ll_w)
    np.testing.assert_array_equal(
        rec, jor.decode_bits(stream, mn, c, h, w, ll_h, ll_w))
    wire = _wire(level, ll_h, ll_w)
    mrec, meta = tor.decode_bits_with_metadata(stream, mn, c, h, w, ll_h,
                                               ll_w, wire)
    jrec, jmeta = jor.decode_bits_with_metadata(stream, mn, c, h, w, ll_h,
                                                ll_w, wire)
    np.testing.assert_array_equal(mrec, jrec)
    np.testing.assert_array_equal(meta, jmeta)
    np.testing.assert_array_equal(mrec, rec)


@pytest.mark.parametrize("geo", GEOMS, ids=GEOM_IDS)
def test_oracle_helpers_equal_reference(geo):
    """compute_max_n and coverage_mask of the copy equal the original's."""
    c, h, w, ll_h, ll_w, _ = geo
    for seed in range(3):
        arr = _arr(geo, seed) * (seed + 1)
        assert tor.compute_max_n(arr) == jor.compute_max_n(arr)
    assert tor.compute_max_n(np.zeros((c, h, w), np.int32)) == \
        jor.compute_max_n(np.zeros((c, h, w), np.int32))
    np.testing.assert_array_equal(tor.coverage_mask(h, w, ll_h, ll_w),
                                  jor.coverage_mask(h, w, ll_h, ll_w))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000])
def test_bitpack_round_trips_equal_reference(n):
    """bits_to_bytes and bytes_to_bits of the copy equal the original's,
    LSB first with the last byte zero padded, and round trip."""
    bits = np.random.default_rng(n).integers(0, 2, n).astype(np.uint8)
    data = tbp.bits_to_bytes(bits)
    assert data == jbp.bits_to_bytes(bits)
    assert data == tbp.bits_to_bytes([bool(b) for b in bits])
    back = tbp.bytes_to_bits(data)
    np.testing.assert_array_equal(back, jbp.bytes_to_bits(data))
    np.testing.assert_array_equal(back[:n], bits)
    assert len(back) == 8 * ((n + 7) // 8) and not back[n:].any()
