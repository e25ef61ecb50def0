"""The port's aggregation on a device (--device-agg) against the JAX
package: each function of core/device_agg.py on the same numpy inputs
(codes 0-3, explicit zeros, UMI groups at the 0.75 edge, empty input),
aggregate_on_device against the JAX package's and against
agg_numpy.aggregate_flat, and whole --device-agg runs' `.mtx` byte for byte
against the JAX package's --device-agg runs in the six mode x --umi cases.
Inputs are seeded; the tolerance is exact (alt_frac NaN-aware)."""

import numpy as np
import pytest
import torch

from vartrix_tpu.core import agg_device_driver as jdriver
from vartrix_tpu.core import device_agg as jagg
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch import driver as port_driver
from vartrix_tpu_torch.core import agg_device_driver as pdriver
from vartrix_tpu_torch.core import agg_numpy
from vartrix_tpu_torch.core import device_agg as pagg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, jax):
    a, b = port.numpy(), np.asarray(jax)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)  # NaN equal to NaN


def _reads(rng, n, n_rows=5, n_cells=7):
    calls = rng.integers(0, 4, n).astype(np.int32)
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    cells = rng.integers(0, n_cells, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return calls, rows, cells, valid


@pytest.mark.parametrize("n", [0, 1, 300])
def test_calls_from_scores_equal_to_jax(n):
    rng = np.random.default_rng(n)
    ref = rng.integers(0, 60, n).astype(np.int32)
    alt = np.where(rng.random(n) < 0.3, ref,
                   rng.integers(0, 60, n)).astype(np.int32)
    got = pagg.calls_from_scores(_t(ref), _t(alt))
    _eq(got, jagg.calls_from_scores(ref, alt))
    if n > 1:
        assert set(got.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("n", [0, 1, 400])
def test_count_block_and_grouped_counts_equal_to_jax(n):
    rng = np.random.default_rng(100 + n)
    calls, rows, cells, valid = _reads(rng, n)
    got = pagg.count_block(_t(calls), _t(rows), _t(cells), _t(valid), 5, 7)
    _eq(got, jagg.count_block(calls, rows, cells, valid, 5, 7))
    gid = (rows * 7 + cells).astype(np.int32)
    got = pagg.grouped_counts(_t(calls), _t(gid), _t(valid), 35)
    _eq(got, jagg.grouped_counts(calls, gid, valid, 35))


def _umi_case():
    """UMI groups of 1-8 reads, some at exactly 3 of 4 (the 0.75 edge),
    some at 2 of 3, some all dropped; then random ones."""
    groups = [  # codes of one (cell group, umi) group's reads
        [2, 2, 2, 1], [1, 1, 1, 2], [2, 2, 2, 3], [1, 1, 1, 3],
        [2, 2, 1], [1, 1, 2], [2, 1], [3], [0, 0], [0, 2, 2, 2, 1],
        [1, 1, 1, 1, 1, 1, 2, 2], [2, 2, 2, 2, 2, 2, 1, 3], [2, 2, 3, 3]]
    rng = np.random.default_rng(7)
    groups += [list(rng.integers(0, 4, int(rng.integers(1, 9))))
               for _ in range(40)]
    calls, umi_group, cell_of_group = [], [], []
    for g, codes in enumerate(groups):
        calls += codes
        umi_group += [g] * len(codes)
        cell_of_group.append(g // 3)
    perm = rng.permutation(len(calls))
    return (np.array(calls, np.int32)[perm],
            np.array(umi_group, np.int32)[perm],
            np.array(cell_of_group, np.int32), len(groups),
            len(groups) // 3 + 1)


@pytest.mark.parametrize("masked", [False, True])
def test_umi_consensus_counts_equal_to_jax(masked):
    calls, ug, cog, n_ug, n_cg = _umi_case()
    valid = np.ones(len(calls), bool)
    valid[::17] = not masked
    got = pagg.umi_consensus_counts(_t(calls), _t(ug), _t(cog), _t(valid),
                                    n_ug, n_cg).numpy()
    want = jagg.umi_consensus_counts(calls, ug, cog, valid, n_ug, n_cg)
    np.testing.assert_array_equal(got, np.asarray(want))
    if not masked:
        # 3 of 4 reads call a UMI; 2 of 3 leave it UNKNOWN; a UMI whose
        # reads were all dropped makes no call (cell groups 0-2)
        np.testing.assert_array_equal(got[:3], [[1, 2, 0], [1, 0, 2],
                                                [0, 0, 2]])


def test_umi_consensus_counts_empty():
    z = np.zeros(0, np.int32)
    got = pagg.umi_consensus_counts(_t(z), _t(z), _t(z),
                                    _t(np.zeros(0, bool)), 0, 0)
    _eq(got, jagg.umi_consensus_counts(z, z, z, np.zeros(0, bool), 0, 0))


def test_value_functions_equal_to_jax():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, (6, 5, 4)).astype(np.int32)
    counts[0, 0] = [2, 0, 0, 0]  # seen, every read dropped: NaN
    counts[0, 1] = [0, 0, 0, 0]  # never seen
    c = _t(counts.astype(np.int64))
    _eq(pagg.consensus_values(c), jagg.consensus_values(counts))
    for got, want in zip(pagg.coverage_values(c),
                         jagg.coverage_values(counts)):
        _eq(got, want)
    for got, want in zip(pagg.alt_frac_values(c),
                         jagg.alt_frac_values(counts)):
        _eq(got, want)
    assert torch.isnan(pagg.alt_frac_values(c)[0][0, 0])


def _per_variant(rng, n_vars, codes):
    cells_l, umis_l, scores_l = [], [], []
    for v in range(n_vars):
        n = int(rng.integers(0, 40))
        cells_l.append(rng.integers(0, 12, n).astype(np.int32))
        umis_l.append(rng.integers(0, 4, n).astype(np.int64))
        if codes:
            scores_l.append(rng.integers(0, 4, n).astype(np.int8))
        else:
            scores_l.append(rng.integers(10, 40, (n, 2)).astype(np.int32))
    return cells_l, umis_l, scores_l


@pytest.mark.parametrize("use_umi", [False, True])
@pytest.mark.parametrize("codes", [True, False], ids=["codes", "scores"])
def test_aggregate_on_device_equal_to_jax_and_host(use_umi, codes):
    rng = np.random.default_rng(20 + 2 * use_umi + codes)
    cells_l, umis_l, scores_l = _per_variant(rng, 9, codes)
    got = pdriver.aggregate_on_device(cells_l, umis_l, scores_l, use_umi,
                                      "cpu")
    want = jdriver.aggregate_on_device(cells_l, umis_l, scores_l, use_umi)
    host = agg_numpy.aggregate_flat(cells_l, umis_l, scores_l, use_umi)
    for a, b, c in zip(got, want, host):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(got[0]) > 20


def test_aggregate_on_device_empty():
    e = [np.zeros(0, np.int32)] * 3
    got = pdriver.aggregate_on_device(e, e, [np.zeros(0, np.int8)] * 3,
                                      True, "cpu")
    assert all(len(a) == 0 and a.dtype == np.int64 for a in got)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    # the JAX package's own --device-agg set (tests/test_differential.py)
    return generate_dataset(str(tmp_path_factory.mktemp("dagg")), SynthConfig(
        n_variants=14, n_cells=35, reads_per_variant=35, indel_frac=0.25,
        seed=61))


def _run(main, ds, out, extra):
    main(["-v", ds["vcf"], "-b", ds["bam"], "-f", ds["fasta"],
          "-c", ds["barcodes"], "-o", str(out), "--ref-matrix",
          str(out) + ".ref", "--host", "native", "--device-agg", *extra])
    got = out.read_bytes()
    if "coverage" in extra:
        got += (out.parent / (out.name + ".ref")).read_bytes()
    return got


@pytest.mark.parametrize("extra", [
    [], ["--umi"], ["-s", "alt_frac"], ["-s", "alt_frac", "--umi"],
    ["-s", "coverage"], ["-s", "coverage", "--umi"],
], ids=lambda a: "_".join(a).replace("-", "") or "consensus")
def test_device_agg_run_byte_equal_to_jax(ds, tmp_path, extra):
    got = _run(port_driver._main, ds, tmp_path / "p.mtx",
               extra + ["--device", "cpu", "--backend", "torch"])
    want = _run(jax_main, ds, tmp_path / "j.mtx", extra + ["--backend", "cpu"])
    assert got == want
