"""decode.inflate_share_max: the reader takes the program's two block
counters, gives None where the program counts no blocks (a parent without
the counters, or a job that decoded no region plan), and reads a CPU traced
run of the souporcell-dense cell at a tiny size."""

import math

import pytest

from benchmark import harness
from benchmark.tests.test_bench_correct import tiny_cell
from vartrix_tpu_torch.utils import trace as recorder

NAME = "decode.inflate_share_max"


def _readings():
    r = harness.Readings(setup_s=1.0, records_per_job=10)
    r.jobs = [harness.Job("plain", 0.1, None, phases={"decode": 0.1})]
    return r


def test_reads_the_two_counters():
    recorder.reset(record=True)
    recorder.count("decode.blocks", 219 * 8)
    recorder.count("decode.blocks_thread_max", 219)
    assert harness.metric_reader(NAME)(_readings()) == pytest.approx(0.125)
    recorder.reset(record=False)


def test_none_without_the_counters(monkeypatch):
    # a job that counted no blocks: the parent's, or a whole-file decode
    recorder.reset(record=True)
    recorder.count("decode.records", 100)
    assert harness.metric_reader(NAME)(_readings()) is None
    recorder.reset(record=False)
    # a program without the recorder's record of its jobs
    monkeypatch.delattr(recorder, "runs")
    assert harness.metric_reader(NAME)(_readings()) is None


def test_traced_run_reads_the_share():
    cell = tiny_cell("souporcell-dense")
    res = harness.run(cell, 2 ** 31 + 41, 0.2, True, device="cpu")
    assert res["correct"] is True
    share = res["metrics"][NAME]
    assert share["unit"] == "share"
    runs = [x for x in recorder.runs() if not x["profiled"]]
    blocks = runs[-1]["counters"]["decode.blocks"]
    threads = cell.config["threads"]
    assert 1 / blocks <= share["value"] <= math.ceil(
        blocks / threads) / blocks + 1e-9
