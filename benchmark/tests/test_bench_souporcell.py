"""The souporcell-dense cell on the CPU at a tiny size: a traced run of the
harness comes out correct and reads the cell's UMI spans and every other
per-layer metric that lists the cell, but the roofline, which no run
without a card reads; the span readers give None where the program
opened no such span (a program without them)."""

from benchmark import harness
from benchmark.tests.test_bench_correct import tiny_cell
from vartrix_tpu_torch.utils import trace as recorder

CELL = "souporcell-dense"
SPANS = ("span_ms.aggregate.umi", "span_ms.collect.ub")


def test_traced_run_reads_the_umi_spans():
    res = harness.run(tiny_cell(CELL), 2 ** 31 + 29, 0.2, True,
                      device="cpu")
    assert res["correct"] is True
    assert res["failed"] == 0
    m = res["metrics"]
    for name in SPANS:
        assert isinstance(m[name]["value"], float), name
        assert m[name]["value"] > 0, name
        assert m[name]["unit"] == "ms"
    listed = {x["name"] for x in harness.load_cell(CELL).per_layer
              if CELL in x.get("workloads", [CELL])}
    assert set(SPANS) < listed
    assert set(m) == listed - {"sw_pair_roofline"}
    # a CPU run traces no card: no roofline is read, none reads 0
    assert "sw_pair_roofline" not in m
    assert "sw_banded_roofline" not in m


def test_span_readers_without_the_spans():
    recorder.reset(record=True)
    with recorder.span("vartrix::aggregate"):
        pass
    r = harness.Readings(setup_s=1.0, records_per_job=10)
    r.jobs = [harness.Job("plain", 0.1, None, phases={"aggregate": 0.1})]
    for name in SPANS:
        assert harness.metric_reader(name)(r) is None, name
    recorder.reset(record=False)
