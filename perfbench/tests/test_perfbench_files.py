"""Every file the benchmark names is there and is found by name; the
file keeps to the contract's shape."""
import json
import re

import pytest

from perfbench import harness
from perfbench.tests.cells import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("perfbench/")
    body = harness.load_json(ROOT / cfg["file"])
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert body["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    ctx = harness.context(ROOT, cell["name"], 1, 1.0, False, "cpu", 0.0)
    assert ctx.traffic["driver"] in ("train", "serve")
    assert "setup_s" in ctx.e2e and len(ctx.e2e) >= 2 and ctx.per_layer
    assert all(isinstance(v, (int, float)) for v in ctx.limits.values())


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert callable(harness.reader(metric["name"]))
        names = [m["name"] for m in BENCH["end_to_end"]]
        assert metric["moves"] in names
        for w in metric["workloads"]:
            assert w in {x["name"] for x in BENCH["workloads"]}
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_readers_return_none_on_an_empty_run():
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"])({}) is None, m["name"]
