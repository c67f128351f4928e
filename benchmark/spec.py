"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), each a configuration and a traffic mix, and the metrics.
A configuration is ``benchmark/configs/<name>.json`` (the file that
``BENCHMARK.json`` gives), a traffic mix ``benchmark/traffic/<name>.json``,
the entry point a mix drives ``benchmark/entries/<entry>.py``, the way it
offers its requests ``benchmark/loops/<loop>.py``, an end-to-end metric a
reader ``benchmark/e2e/<name>.py`` and a per-layer
metric a reader ``benchmark/metrics/<family>.py``, where the family is the
metric's name up to its first dot and the rest names the direction the
reader reads (``idle_pct.enc_batch``: the ``idle_pct`` reader, for the
batch encode calls). A new cell, configuration, mix, entry point, loop
or metric is a new file and new entries, never an edit.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str) -> dict:
    """The cell ``name`` with its configuration, its traffic mix and the
    metrics it reports: {"workload", "config", "traffic", "end_to_end",
    "per_layer", "chips"}."""
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    return {
        "workload": w,
        "chips": int(w["chips"]),
        "config": config,
        "traffic": traffic(w["traffic"]),
        "end_to_end": [m for m in bench["end_to_end"] if _reports(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _reports(m, name)],
    }


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def e2e_reader(name: str):
    """``read(window) -> value or None`` of an end-to-end metric."""
    return importlib.import_module(f"benchmark.e2e.{name}").read


def layer_reader(name: str):
    """(``read(records, direction) -> value or None``, direction) of a
    per-layer metric."""
    family, _, direction = name.partition(".")
    return importlib.import_module(f"benchmark.metrics.{family}").read, \
        direction or None


def entry(name: str):
    """The module of the entry point ``name`` (``entries/__init__.py``)."""
    return importlib.import_module(f"benchmark.entries.{name}")


def loop(name: str):
    """The module of the loop ``name`` (``loops/__init__.py``)."""
    return importlib.import_module(f"benchmark.loops.{name}")
