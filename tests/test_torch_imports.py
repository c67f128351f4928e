"""The port stands alone: no file of spiht_tpu_torch, nor chip_smoke.py,
imports jax or the JAX package (static AST scan)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "spiht_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
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
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "__init__.py", "encoder.py", "decoder.py",
            "dwt.py", "torch_transform.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top != "jax" and top != "jaxlib", f"{path}: imports {mod}"
        assert top != "spiht_tpu", f"{path}: imports {mod}"
