"""`correct` on the CPU at a tiny size: the plain reference equals the port
(`--device cpu --backend torch`) in all three cells' flag sets; a run of
the harness, with its look for a card skipped, comes out correct on the
sound program and not correct with the timed path broken underneath
(an answer altered where it is produced, half of the reads left out, the
aggregation's state left unchanged); the control (int4 cells) fails the
comparison the program passes."""

import numpy as np
import pytest

from benchmark import control, harness
from benchmark.inputs import bam, synth
from benchmark.reference import mtx
from benchmark.reference import vartrix as reference
from benchmark.tests import load_any_cell
from vartrix_tpu_torch import driver
from vartrix_tpu_torch.core import agg_numpy
from vartrix_tpu_torch.ops import sw_cuda

CELLS = ["souporcell-dense", "readme-dense", "readme-sparse"]
TINY = dict(n_chroms=2, chrom_len=20_000, n_variants=12, n_cells=30,
            reads_per_variant=20, background_reads=200, spliced_frac=0.5,
            multimap_frac=0.3, n_read_frac=0.05)


def tiny_cell(name):
    cell = load_any_cell(name)
    cell.workload["generator"] = {**cell.workload["generator"], **TINY}
    cell.workload.pop("min_bam_bytes", None)
    cell.config["threads"] = 2
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_port(name, tmp_path):
    cell = tiny_cell(name)
    ds = synth.generate({**cell.generator, "reads_per_variant": 40}, 23)
    paths = bam.write(ds, str(tmp_path / "in"), 2)
    sem = cell.semantics
    out = tmp_path / "out"
    out.mkdir()
    driver._main(["-v", paths["vcf"], "-b", paths["bam"], "-f",
                  paths["fasta"], "-c", paths["barcodes"],
                  "-o", str(out / "matrix.mtx"),
                  "--ref-matrix", str(out / "ref_matrix.mtx"),
                  "--threads", "2", "--device", "cpu", "--backend", "torch",
                  *sem.argv(), *cell.workload["flags"]])
    want, shape, work = reference.expected(ds, sem)
    assert work["cells"] > 0
    for k, w in want.items():
        assert len(w[0]) > 50
        assert mtx.compare(str(out / f"{k}.mtx"), w, shape) == 0, k


def _flip_first_call(orig):
    def broken(self, *args, **kwargs):
        codes = np.array(orig(self, *args, **kwargs), dtype=np.int8)
        if len(codes):
            codes[0] = 2 if codes[0] != 2 else 1
        return codes
    return broken


def _half_the_reads(orig):
    def broken(*args, **kwargs):
        read_idx, cells, umis = orig(*args, **kwargs)
        return ([r[::2] for r in read_idx], [c[::2] for c in cells],
                [u[::2] for u in umis])
    return broken


def _unchanged_state(orig):
    def broken(cells_l, umis_l, scores_l, use_umi):
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    return broken


FAULTS = {
    "answer_altered": lambda mp: [
        mp.setattr(cls, "pair_calls_chained",
                   _flip_first_call(cls.pair_calls_chained))
        for cls in (sw_cuda.SwBackend, sw_cuda.BandedSwBackend)],
    "half_the_batch": lambda mp: mp.setattr(
        driver, "collect_reads_fast",
        _half_the_reads(driver.collect_reads_fast)),
    "state_unchanged": lambda mp: mp.setattr(
        agg_numpy, "aggregate_flat",
        _unchanged_state(agg_numpy.aggregate_flat)),
}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = harness.run(tiny_cell(name), 2 ** 31 + 7, 0.2, False,
                      device="cpu")
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {
        m["name"] for m in load_any_cell(name).end_to_end
        if name in m.get("workloads", [name])}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = harness.run(tiny_cell(name), 2 ** 31 + 7, 0.2, False,
                      device="cpu")
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]
    assert (res["checks"]["mismatched_entries"]["value"]
            > res["checks"]["mismatched_entries"]["limit"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    got = control.control_mismatches(tiny_cell(name), 31, "cpu")
    assert got["mismatched_entries"] > 0
    assert got["entries"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size_on_card(name):
    """The control at the cell's own size (the chip run of control.py)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = load_any_cell(name)
    for seed in (1, 2, 3):
        got = control.control_mismatches(cell, seed, "cuda")
        assert got["mismatched_entries"] > 0


def test_traced_run_reads_its_per_layer_metrics():
    res = harness.run(tiny_cell("readme-sparse"), 5, 0.2, True,
                      device="cpu")
    assert res["correct"] is True
    kinds_needed = {"phase_ms.decode", "phase_ms.collect", "phase_ms.score",
                    "phase_ms.haplotypes", "phase_ms.aggregate"}
    assert kinds_needed <= set(res["metrics"])
    # a CPU run traces no card: no roofline is read, none reads 0
    assert "sw_banded_roofline" not in res["metrics"]
    assert "breakdown" in res and res["device"]["window_s"] > 0
