"""The port stands alone: no file of spiht_tpu_torch, nor chip_smoke.py
or the scripts beside it, imports jax or the JAX package (static AST
scan)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "spiht_tpu_torch").rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "decode_clocks.py",
                             "encode_clocks.py", "roundtrip_pairs.py")
]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_scan_covers_the_package():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"chip_smoke.py", "decode_clocks.py", "encode_clocks.py",
            "roundtrip_pairs.py",
            "spiht_tpu_torch/__init__.py",
            "spiht_tpu_torch/codec/encoder.py",
            "spiht_tpu_torch/codec/decoder.py",
            "spiht_tpu_torch/codec/meta_expand.py",
            "spiht_tpu_torch/codec/planning.py",
            "spiht_tpu_torch/native/__init__.py",
            "spiht_tpu_torch/native/runtime.py",
            "spiht_tpu_torch/ops/quantize_kernels.py",
            "spiht_tpu_torch/wavelets/dwt.py",
            "spiht_tpu_torch/torch_transform.py"} <= names


def test_no_path_to_the_reference_packages_library():
    """No file of the port names the JAX package's built library
    (spiht_tpu/native/libspiht_kernel.so): the port builds its own, under
    a name that covers its sources (tests/test_torch_copies.py)."""
    for path in FILES:
        assert "libspiht_kernel.so" not in path.read_text(), path


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top != "jax" and top != "jaxlib", f"{path}: imports {mod}"
        assert top != "spiht_tpu", f"{path}: imports {mod}"
