"""souporcell's VarTrix step (`-s coverage --umi --mapq 30`, full SW, the
benchmark's `souporcell_coverage_full` configuration under its
`dense_channel` traffic) through `driver._main` on a tiny seeded dataset:
both coverage matrices byte-equal to the JAX package's run of the same
command and entry by entry equal to the benchmark's plain reference, the
reads the run reports dropped (`--metrics-json`'s "metrics") against the
reference's own counts, and the UMI spans nested in their phases, absent
without --umi. The tiny dataset adds background reads (some start near a
variant and end before it: candidates of the join that the fetch overlap
drops before the mapq filter sees them), more multi-mapped reads, and
UMIs drawn from a pool of three, so that reads of one (variant, cell)
share a UMI and the vote groups them."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs import bam, synth
from benchmark.reference import mtx
from benchmark.reference import vartrix as reference
from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu_torch import driver

CELL = "souporcell-dense"
TINY = dict(n_chroms=2, chrom_len=20_000, n_variants=40, n_cells=12,
            reads_per_variant=30, background_reads=2_000, multimap_frac=0.3)
UMI_POOL = 3
SEED = 2 ** 31 + 2001
UMI_SPANS = {"vartrix::collect.ub": "vartrix::collect",
             "vartrix::aggregate.umi": "vartrix::aggregate"}
CPU = ["--device", "cpu", "--backend", "torch"]


@pytest.fixture(scope="module")
def cell():
    return harness.load_cell(CELL)


def _dataset(cell, tmp_path_factory, **over):
    ds = synth.generate({**cell.generator, **TINY, **over}, SEED)
    if ds.umi.shape[1]:
        pick = np.random.default_rng(SEED).integers(0, UMI_POOL, ds.n)
        ds.umi = ds.umi[:UMI_POOL][pick]
    paths = bam.write(ds, str(tmp_path_factory.mktemp("souporcell")), 2)
    return ds, paths


@pytest.fixture(scope="module")
def data(cell, tmp_path_factory):
    return _dataset(cell, tmp_path_factory)


def run(cell, paths, out, *extra, umi=True):
    """driver._main under the configuration's flags (less --umi where umi
    is False); returns the --metrics-json payload."""
    argv = (["-v", paths["vcf"], "-b", paths["bam"], "-f", paths["fasta"],
             "-c", paths["barcodes"], "-o", str(out / "matrix.mtx"),
             "--ref-matrix", str(out / "ref_matrix.mtx"), "--threads", "2",
             "--metrics-json", str(out / "metrics.json")]
            + [a for a in cell.semantics.argv() if umi or a != "--umi"]
            + list(cell.workload["flags"]) + list(extra))
    driver._main(argv)
    with open(out / "metrics.json") as f:
        return json.load(f)


def reference_counts(ds, sem):
    """The reference's own counts, as upstream's filter chain drops and
    groups: (variant, record) pairs of live variants in the fetch overlap
    whose mapq is under --mapq (num_low_mapq); pairs past the CB filter
    dropped for a missing UB (num_non_umi); and, for the dataset's own
    check, the called reads and their (variant, cell, UMI) groups."""
    refs, alts, skipped = reference.haplotypes(ds, sem)
    v_end = ds.v_pos + np.array([len(r) for r in ds.v_ref], np.int64)
    overlap = ((ds.tid[None, :] == ds.v_tid[:, None])
               & (ds.pos[None, :] < v_end[:, None])
               & (ds.ref_end()[None, :] > ds.v_pos[:, None])
               & ~skipped[:, None])
    low_mapq = int((overlap & (ds.mapq[None, :] < sem.mapq)).sum())
    var, rec = reference.read_pairs(ds, sem, skipped)
    cell = reference.cell_index(ds)[rec]
    var, rec, cell = var[cell >= 0], rec[cell >= 0], cell[cell >= 0]
    has_ub = np.full(len(rec), ds.umi.shape[1] > 0)
    non_umi = int((~has_ub).sum())
    var, rec, cell = var[has_ub], rec[has_ub], cell[has_ub]
    ref_s, alt_s, _ = reference.score_pairs(ds, var, rec, refs, alts,
                                            sem.sw_mode, "cpu")
    called = reference.call_codes(ref_s, alt_s) != 0
    umi_key = reference._umi_keys(ds.umi[rec])
    umi_groups = len(np.unique(np.stack(
        [var[called], cell[called], umi_key[called]], 1), axis=0))
    return {"num_low_mapq": low_mapq, "num_non_umi": non_umi,
            "called": int(called.sum()), "umi_groups": umi_groups}


def check_dropped(got, counts):
    m = got["metrics"]
    assert m["num_low_mapq"] == counts["num_low_mapq"]
    assert m["num_non_umi"] == counts["num_non_umi"]


def check_matrices(ds, sem, out):
    want, shape, _ = reference.expected(ds, sem)
    for name, w in want.items():
        assert mtx.compare(str(out / f"{name}.mtx"), w, shape) == 0, name
    return want


def test_matrices_counters_and_spans(cell, data, tmp_path):
    ds, paths = data
    sem = cell.semantics
    got = run(cell, paths, tmp_path, *CPU)
    want = check_matrices(ds, sem, tmp_path)
    assert len(want["matrix"][0]) > 100
    counts = reference_counts(ds, sem)
    check_dropped(got, counts)
    assert counts["num_low_mapq"] > 0
    # the dataset's UMIs merge reads: the vote has groups of several
    assert 0 < counts["umi_groups"] < counts["called"]
    assert got["counters"]["collect.reads_scored"] >= counts["called"]
    spans = got["spans"]
    for name, parent in UMI_SPANS.items():
        assert spans[name]["parent"] == parent, name
        assert spans[name]["n"] == 1
        assert spans[name]["s"] <= spans[parent]["s"]


def test_matrices_byte_equal_to_jax(cell, data, tmp_path):
    """The same command through the JAX package (native host, its exact
    CPU aligner): both matrices byte for byte."""
    from vartrix_tpu.driver import _main as jax_main

    _, paths = data
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    run(cell, paths, port, *CPU)
    jax_main(["-v", paths["vcf"], "-b", paths["bam"], "-f", paths["fasta"],
              "-c", paths["barcodes"], "-o", str(jax / "matrix.mtx"),
              "--ref-matrix", str(jax / "ref_matrix.mtx"), "--threads", "2",
              "--host", "native", "--backend", "cpu"]
             + cell.semantics.argv() + list(cell.workload["flags"]))
    for name in ("matrix.mtx", "ref_matrix.mtx"):
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name


def test_without_umi_no_umi_spans(cell, data, tmp_path):
    ds, paths = data
    got = run(cell, paths, tmp_path, *CPU, umi=False)
    assert not set(UMI_SPANS) & set(got["spans"])
    assert {"vartrix::collect", "vartrix::aggregate"} <= set(got["spans"])
    # every read carries a UB: the mapq filter drops as with --umi
    counts = reference_counts(ds, cell.semantics)
    check_dropped(got, counts)


def test_reads_without_ub_are_dropped(cell, tmp_path_factory, tmp_path):
    """A BAM without UB tags under --umi: every read past the CB filter is
    dropped for its missing UB, and the matrices are empty."""
    ds, paths = _dataset(cell, tmp_path_factory, umi=False)
    sem = cell.semantics
    got = run(cell, paths, tmp_path, *CPU)
    check_matrices(ds, sem, tmp_path)
    counts = reference_counts(ds, sem)
    assert counts["num_non_umi"] > 0
    check_dropped(got, counts)
    assert got["counters"].get("collect.reads_scored", 0) == 0


@pytest.mark.cuda
def test_matrices_and_counters_on_card(cell, data, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    ds, paths = data
    sem = cell.semantics
    got = run(cell, paths, tmp_path, "--backend", "cuda")
    check_matrices(ds, sem, tmp_path)
    check_dropped(got, reference_counts(ds, sem))
    assert got["kernel_launches"]["sw_pair"] > 0
