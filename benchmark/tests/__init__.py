"""Cells whose files the benchmark keeps but BENCHMARK.json does not list
(PERF.md, Open questions: no end-to-end metric of theirs is steady enough
yet), with the configuration each runs under. The tests hold the
reference and the harness to them as to a listed cell."""

import json
import os

from benchmark import harness

HELD = {"souporcell-dense": "souporcell_coverage_full",
        "readme-dense": "readme_consensus_banded"}


def load_any_cell(name: str) -> harness.Cell:
    """harness.load_cell, or a held cell from its files, on one chip, with
    BENCHMARK.json's metrics."""
    if name not in HELD:
        return harness.load_cell(name)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           f"{HELD[name]}.json")) as f:
        config = json.load(f)
    with open(os.path.join(harness.BENCH_DIR, "workloads",
                           f"{name}.json")) as f:
        workload = json.load(f)
    return harness.Cell(name, 1, config, workload, spec["end_to_end"],
                        spec["per_layer"])
