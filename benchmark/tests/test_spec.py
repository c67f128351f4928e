"""Every configuration, traffic mix and metric of BENCHMARK.json loads by
name, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from benchmark import spec
from benchmark.reference import transform as ref

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = spec.cell(name)
    assert c["config"]["name"] == c["workload"]["config"]
    mix = c["traffic"]
    assert {"entry", "bpp", "pool", "loop", "clients", "check_sample",
            "trace_rounds"} <= set(mix)
    # the entry point and the loop, found by name
    entry = spec.entry(mix["entry"])
    assert callable(entry.Entry) and len(entry.DIRECTIONS) == 2
    assert set(entry.API) == set(entry.DIRECTIONS)
    assert callable(spec.loop(mix["loop"]).drive)
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["end_to_end"]:
        if m["name"] != "setup_s":
            assert callable(spec.e2e_reader(m["name"]))
    for m in c["per_layer"]:
        read, direction = spec.layer_reader(m["name"])
        assert callable(read) and direction in entry.DIRECTIONS
        # every per-layer metric of a cell moves a metric the cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    with open(spec.ROOT / conf["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    c, h, w = cfg["shape"]
    geo = ref.geometry(h, w, cfg["level"])
    assert cfg["geometry"]["encoded"] == [c, geo["enc_h"], geo["enc_w"]]
    assert cfg["geometry"]["ll"] == [geo["ll_h"], geo["ll_w"]]
    assert cfg["geometry"]["levels"] == geo["level"]
    assert cfg["limits"]["dec_max_err"] > 0
    # a deployment's thread count comes with its source under "assumed"
    if "host_threads" in cfg:
        assert any("host_threads" in a for a in cfg["assumed"])


def test_geometries_match_the_port():
    from spiht_tpu_torch import SpihtSettings, get_slices_and_h_w

    for conf in BENCH["configs"]:
        with open(spec.ROOT / conf["file"]) as f:
            cfg = json.load(f)
        _, h, w = cfg["shape"]
        slices, enc_h, enc_w = get_slices_and_h_w(
            h, w, SpihtSettings(**cfg["settings"]), cfg["level"])
        geo = ref.geometry(h, w, cfg["level"])
        assert (enc_h, enc_w) == (geo["enc_h"], geo["enc_w"])
        assert (slices[0][1].stop, slices[0][2].stop) == (geo["ll_h"],
                                                          geo["ll_w"])


@pytest.mark.parametrize("bpp, want", [
    (1.0, [[480, 480]] * 3),
    ([0.5, 1.0, 2.0], [[240, 480], [960, 240], [480, 960]]),
])
def test_requests_take_a_budget_an_image(bpp, want):
    from benchmark import cell

    reqs = cell.requests({"bpp": bpp, "pool": 3, "batch": 2}, 16, 30)
    assert [i for i, _ in reqs] == [[0, 1], [2, 3], [4, 5]]
    assert [b for _, b in reqs] == want


@pytest.mark.parametrize("mix", [{"loop": "closed", "clients": 2},
                                 {"loop": "no-such-loop", "clients": 1}])
def test_a_loop_it_does_not_implement_is_refused(mix):
    with pytest.raises((ValueError, ModuleNotFoundError)):
        spec.loop(mix["loop"]).drive(lambda r: None, mix, 0.0)
