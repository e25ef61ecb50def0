"""BENCHMARK.json and the files it names: every configuration, cell and
metric has its file, found by name, and the entries keep the contract's
shapes."""

import json
import os
import re

import pytest

from benchmark import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("conf", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_file(conf):
    assert NAME.match(conf["name"])
    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        data = json.load(f)
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    for key in conf["reduced"]:
        assert key in data
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = harness.load_cell(name)
    assert NAME.match(name) and cell.chips == 1
    assert cell.semantics.argv()
    reported = [m for m in METRICS if cell.reports(m)]
    assert "setup_s" in {m["name"] for m in reported}
    assert len([m for m in SPEC["end_to_end"] if cell.reports(m)]) >= 2
    assert [m for m in SPEC["per_layer"] if cell.reports(m)]


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_reader(metric):
    assert NAME.match(metric["name"])
    assert callable(harness.metric_reader(metric["name"]))
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric["name"].endswith("_roofline"):
        kernel = metric["name"][: -len("_roofline")]
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "counts",
                                           f"{kernel}.py"))
        assert metric["unit"] == "%"
    if metric in SPEC["per_layer"]:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    else:
        assert 0.01 <= metric["bound"] <= 0.25
