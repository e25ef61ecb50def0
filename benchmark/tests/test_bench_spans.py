"""The readings of the program's spans and counters: spans.idle_spans on
hand-made events and on a CPU whole-job profile, and the per-layer
metrics that read the program's recorder, numbers on a CPU traced run of
a small cell and None where the program keeps no record."""

import pytest

from benchmark import harness, spans, trace
from benchmark.tests.test_bench_correct import tiny_cell
from vartrix_tpu_torch import driver
from vartrix_tpu_torch.utils import trace as recorder

NEW = ("span_ms.fasta", "span_ms.invalid_index", "fasta_mib",
       "span_ms.plan", "decode.useful_share", "span_ms.score.wait",
       "h2d_bytes_per_read")


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": {}}


def test_idle_spans_on_hand_made_events():
    events = [
        _x("bench::job", "user_annotation", 0, 1000),
        _x("vartrix::job", "user_annotation", 10, 980),
        _x("vartrix::haplotypes", "user_annotation", 100, 300),
        # nested: haplotypes' child from 150 to 250
        _x("vartrix::haplotypes.fasta", "user_annotation", 150, 100),
        _x("vartrix::score", "user_annotation", 500, 400),
        # another thread's span covers nothing of the job's thread
        _x("vartrix::score.gather", "user_annotation", 0, 1000, tid=2),
        # the device busy 450-550: a gap 0-450 and one 550-1000
        _x("void kernel()", "kernel", 450, 100, tid=7),
    ]
    got = spans.idle_spans(events, trace.JOB_SPAN)
    want = {
        "none": (10 + 10) * 1e-6,               # 0-10 and 990-1000
        "vartrix::job": (90 + 50 + 90) * 1e-6,  # 10-100, 400-450, 900-990
        "vartrix::haplotypes": (50 + 150) * 1e-6,  # 100-150, 250-400
        "vartrix::haplotypes.fasta": 100 * 1e-6,
        "vartrix::score": 350 * 1e-6,            # 550-900, cut at the edge
    }
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    idle = 1000 - 100
    assert sum(got.values()) == pytest.approx(idle * 1e-6)


def _plain_readings():
    r = harness.Readings(setup_s=1.0, records_per_job=10)
    r.jobs = [harness.Job("plain", 0.1, None, phases={"score": 0.1})]
    return r


def test_readers_without_a_program_record(monkeypatch):
    # a program without the recorder's record of its jobs (the parent's)
    monkeypatch.delattr(recorder, "runs")
    for name in NEW:
        assert harness.metric_reader(name)(_plain_readings()) is None, name


def test_readers_without_unprofiled_traced_jobs():
    recorder.reset(record=True)
    recorder.count("fasta.bytes_read", 5)
    r = _plain_readings()
    assert spans.counter(r, "fasta.bytes_read") == 5.0
    r.jobs = [harness.Job("job_profile", 0.1, None, phases={"score": 0.1}),
              harness.Job("plain", 0.1, None)]
    for name in NEW:
        assert harness.metric_reader(name)(r) is None, name
    recorder.reset(record=False)


def test_readers_take_the_last_unprofiled_jobs():
    for k in (1, 2, 3):
        recorder.reset(record=True)
        recorder.count("k", k)
        if k == 3:
            with recorder.profiling():
                pass
    recorder.reset(record=False)
    recorder.count("k", 100)  # not recording: no job of the record
    r = _plain_readings()
    r.jobs = r.jobs * 2
    # jobs 1 and 2; job 3 ran under a profiler
    assert spans.counter(r, "k") == 1.5
    assert spans.counter(r, "other") == 0.0


def test_traced_run_reads_the_new_metrics(monkeypatch):
    # the tiny BAM plans its regions (AUTO_REGION_BYTES 0), so the plan's
    # span runs
    monkeypatch.setattr(driver, "AUTO_REGION_BYTES", 0)
    res = harness.run(tiny_cell("readme-sparse"), 2 ** 31 + 11, 0.2, True,
                      device="cpu")
    assert res["correct"] is True
    m = res["metrics"]
    for name in NEW:
        assert isinstance(m[name]["value"], float), name
    assert m["span_ms.fasta"]["value"] > 0
    assert m["span_ms.plan"]["value"] > 0
    assert 0 < m["decode.useful_share"]["value"] <= 1
    assert m["h2d_bytes_per_read"]["value"] >= 96 + 8
    # the two chromosomes of 20,000 bases, each read once with its line ends
    assert m["fasta_mib"]["value"] * 2 ** 20 >= 2 * 20_000


def test_idle_spans_of_a_whole_job_profile(tmp_path):
    cell = tiny_cell("readme-sparse")
    paths, _ = harness.dataset(cell, 2 ** 31 + 13, 2, str(tmp_path / "in"))
    work = tmp_path / "work"
    work.mkdir()
    job = harness.Runner(cell, paths, "cpu", str(work)).run(
        "job_profile", metrics=True)
    assert job.error is None
    idle = spans.idle_spans(job.trace, trace.JOB_SPAN)
    w0, w1 = trace.span_window(job.trace, trace.JOB_SPAN)
    # no device on the CPU: the whole job is idle, named by the spans
    assert sum(idle.values()) == pytest.approx((w1 - w0) * 1e-6)
    assert "vartrix::haplotypes.fasta" in idle
    assert idle.get("none", 0.0) < 0.05 * sum(idle.values())
