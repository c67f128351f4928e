"""The plain reference against the port's plain versions on the CPU, and
the reference's own independence."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import images
from benchmark.reference import spiht
from benchmark.reference import transform as ref

REF_DIR = Path(ref.__file__).resolve().parent
SETTINGS = {"wavelet": "bior2.2", "quantization_scale": 1.0,
            "mode": "reflect", "color_model": "ipt",
            "per_channel_quant_scales": [100.0, 20.0, 20.0]}


@pytest.mark.parametrize("trial", range(24))
def test_coder_equals_the_oracle(trial):
    """Streams, max_n and the decoder's coefficients at every cut equal
    the port's pure-Python oracle, at even and odd LL."""
    from spiht_tpu_torch.codec import oracle

    rng = np.random.default_rng(trial)
    c = int(rng.integers(1, 4))
    h, w = (int(v) for v in rng.integers(6, 34, 2))
    ll_h = int(rng.integers(2, max(3, h // 2)))
    ll_w = int(rng.integers(2, max(3, w // 2)))
    scale = float(rng.choice([3, 50, 1000]))
    arr = (rng.standard_normal((c, h, w)) * scale
           * rng.random((c, h, w)) ** 3).astype(np.int32)
    full, _ = oracle.encode_bits(arr, ll_h, ll_w, 10**9)
    for mb in (8, len(full) // 3 // 8 * 8, len(full) // 2 // 8 * 8,
               len(full), len(full) + 9):
        bits, max_n = oracle.encode_bits(arr, ll_h, ll_w, mb)
        data, nb, mn, rec = spiht.encode(torch.from_numpy(arr), ll_h, ll_w,
                                         mb)
        assert data == np.packbits(np.array(bits, np.uint8),
                                   bitorder="little").tobytes()
        assert (nb, mn) == (len(bits), max_n)
        np.testing.assert_array_equal(
            rec.numpy(), oracle.decode_bits(bits, max_n, c, h, w, ll_h, ll_w))


def test_unaligned_cut_is_refused():
    arr = np.arange(3 * 16 * 16, dtype=np.int32).reshape(3, 16, 16) - 300
    with pytest.raises(ValueError, match="byte aligned"):
        spiht.encode(torch.from_numpy(arr), 4, 4, 101)


@pytest.mark.parametrize("shape,level", [((3, 44, 60), 2), ((3, 48, 64), 2),
                                         ((3, 64, 96), None),
                                         ((3, 37, 53), None)])
def test_chain_equals_the_port(shape, level):
    """The whole reference (IPT, bior2.2, scales, SPIHT, decoder) against
    the port's on-device entry points run on the CPU, in float64."""
    import spiht_tpu_torch as pt

    st = pt.SpihtSettings(**SETTINGS)
    cfg = dict(SETTINGS, level=level)
    c, h, w = shape
    im = images.make(1, h, w, 5, "cpu")[0]
    mb = h * w // 8 * 8
    er = pt.encode_image_device(im, st, level, mb, device="cpu")
    arr = ref.forward(torch.from_numpy(im), cfg)
    ll_h, ll_w = ref.ll_size(h, w, level)
    data, nbits, max_n, rec = spiht.encode(arr, ll_h, ll_w, mb)
    assert (data, max_n) == (er.encoded_bytes, er.max_n) and nbits == mb
    got = pt.decode_image_device(er, st, device="cpu")
    want = ref.inverse(rec, cfg, h, w)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12


def test_transform_against_the_port_transform():
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.torch_transform import forward

    im = torch.from_numpy(images.make(1, 64, 96, 9, "cpu")[0])
    arr, ll_h, ll_w = forward(im, SpihtSettings(**SETTINGS), None)
    torch.testing.assert_close(ref.forward(im, dict(SETTINGS, level=None)),
                               arr, rtol=0, atol=0)
    assert (ll_h, ll_w) == ref.ll_size(64, 96)


def test_reference_imports_nothing_of_the_program():
    """The reference's files import only torch, numpy and the standard
    library: no jax, no spiht_tpu, no spiht_tpu_torch."""
    allowed = {"torch", "numpy", "math", "typing", "__future__"}
    for path in sorted(REF_DIR.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path, names)


def test_reference_loads_no_forbidden_module():
    code = ("import sys; import benchmark.reference.spiht, "
            "benchmark.reference.transform; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'spiht_tpu', 'spiht_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=REF_DIR.parent.parent).stdout
    assert out.strip() == "[]"
