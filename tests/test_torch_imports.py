"""The port stands alone: no file of spiht_tpu_torch (its tools included),
nor chip_smoke.py or the scripts beside it, imports jax or the JAX package
(static AST scan). And its public surface covers the JAX package's: every
module's ``__all__``, compared by AST with its port counterpart's, lacks
exactly the names the README lists as left out."""

import ast
import re
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
            "spiht_tpu_torch/codec/device_encoder.py",
            "spiht_tpu_torch/codec/device_decoder.py",
            "spiht_tpu_torch/codec/order_prototype.py",
            "spiht_tpu_torch/codec/planning.py",
            "spiht_tpu_torch/native/__init__.py",
            "spiht_tpu_torch/native/runtime.py",
            "spiht_tpu_torch/ops/quantize_kernels.py",
            "spiht_tpu_torch/tools/__init__.py",
            "spiht_tpu_torch/tools/spike_hbm_table.py",
            "spiht_tpu_torch/tools/spike_pallas_seq.py",
            "spiht_tpu_torch/tools/spike_pallas_machine.py",
            "spiht_tpu_torch/tools/spike_pallas_ilp.py",
            "spiht_tpu_torch/tools/spike_pallas_block.py",
            "spiht_tpu_torch/tools/spike_token_matmul.py",
            "spiht_tpu_torch/wavelets/dwt.py",
            "spiht_tpu_torch/torch_transform.py",
            "spiht_tpu_torch/transform.py",
            "spiht_tpu_torch/cli.py",
            "spiht_tpu_torch/metrics.py",
            "spiht_tpu_torch/utils.py",
            "spiht_tpu_torch/color/models.py",
            "spiht_tpu_torch/color/torch_models.py",
            "spiht_tpu_torch/ops/quantize.py",
            "spiht_tpu_torch/parallel/spatial.py",
            "spiht_tpu_torch/parallel/health.py",
            "spiht_tpu_torch/examples/metadata_ml_consumer.py"} <= names


def test_console_script_names_the_ports_cli():
    """pyproject.toml installs the port's command line beside the JAX
    package's, and the module it names has ``main``."""
    text = (ROOT / "pyproject.toml").read_text()
    assert 'spiht-tpu-torch = "spiht_tpu_torch.cli:main"' in text
    assert 'spiht-tpu = "spiht_tpu.cli:main"' in text
    from spiht_tpu_torch import cli

    assert callable(cli.main)


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


@pytest.mark.parametrize(
    "h,w,kw,level",
    [(512, 512, {}, None), (512, 512, dict(wavelet="bior4.4",
                                           mode="symmetric"), 3),
     (37, 61, dict(wavelet="db2", mode="periodization"), 2),
     (4243, 4243, {}, None)],
)
def test_public_surface_covers_the_reference(h, w, kw, level):
    """Every name of ``spiht_tpu.__all__`` is in ``spiht_tpu_torch.__all__``,
    and both ``get_slices_and_h_w`` give the same slices and dims."""
    import spiht_tpu
    import spiht_tpu_torch

    assert set(spiht_tpu.__all__) <= set(spiht_tpu_torch.__all__)
    assert all(hasattr(spiht_tpu_torch, n) for n in spiht_tpu_torch.__all__)
    want = spiht_tpu.get_slices_and_h_w(h, w, spiht_tpu.SpihtSettings(**kw),
                                        level)
    got = spiht_tpu_torch.get_slices_and_h_w(
        h, w, spiht_tpu_torch.SpihtSettings(**kw), level)
    assert got == want


# spiht_tpu module -> its port counterpart, where the names differ
COUNTERPART = {
    "jax_transform.py": "torch_transform.py",
    "codec/pallas_encoder.py": "codec/encoder.py",
    "codec/pallas_decoder.py": "codec/decoder.py",
    "ops/pallas_kernels.py": "ops/quantize_kernels.py",
    "color/jax_models.py": "color/torch_models.py",
}


def _all(path):
    """A module's ``__all__`` by AST (None where it has none)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _missing():
    """{(reference module, name)} of every name in a ``spiht_tpu``
    module's ``__all__`` that its port counterpart does not export."""
    gap = set()
    for path in sorted((ROOT / "spiht_tpu").rglob("*.py")):
        rel = str(path.relative_to(ROOT / "spiht_tpu"))
        names = _all(path)
        if not names:
            continue
        port = ROOT / "spiht_tpu_torch" / COUNTERPART.get(rel, rel)
        have = (_all(port) or set()) if port.exists() else set()
        gap |= {(rel, n) for n in names - have}
    return gap


def _readme_left_out():
    """The README's table of names left out: {(module, name)}, a name
    ``*`` standing for the module's whole ``__all__``."""
    text = (ROOT / "README.md").read_text()
    table = text.split("| left out | reason |", 1)[1].split("\n\n", 1)[0]
    rows = re.findall(r"^ *\| `([^`:]+):([^`]+)` \| (.+) \|$", table, re.M)
    assert rows and all(reason.strip() for _, _, reason in rows)
    out = set()
    for mod, name, _ in rows:
        names = _all(ROOT / "spiht_tpu" / mod) if name == "*" else {name}
        out |= {(mod, n) for n in names}
    return out


def test_every_reference_name_is_exported_or_left_out_in_the_readme():
    gap = _missing()
    assert gap == _readme_left_out(), sorted(gap ^ _readme_left_out())


def test_exported_names_exist():
    """Each port module's ``__all__`` names attributes it has."""
    import importlib

    for path in sorted((ROOT / "spiht_tpu_torch").rglob("*.py")):
        names = _all(path)
        if not names or "tools" in path.parts:
            continue
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        m = importlib.import_module(mod.removesuffix(".__init__"))
        assert all(hasattr(m, n) for n in names), (mod, names)
