"""The port's whole run (vartrix_tpu_torch.driver._main on the CPU with the
plain PyTorch scorer) against the JAX package's native-host run with its
Pallas kernels in interpret mode: the .mtx files must be byte-equal in
every scoring mode."""

import json

import pytest

from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.driver import _main as port_main

MODES = {
    "consensus": ["-s", "consensus"],
    "coverage_umi": ["-s", "coverage", "--umi"],
    "alt_frac": ["-s", "alt_frac"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("synth")), SynthConfig(
        n_variants=8, n_cells=25, reads_per_variant=25, seed=77,
        spliced_frac=0.3, indel_frac=0.2))


def _run(main, data, out_dir, tag, extra):
    base = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
            "-c", data["barcodes"]]
    out = str(out_dir / f"{tag}.mtx")
    ref = str(out_dir / f"{tag}_ref.mtx")
    main(base + ["-o", out, "--ref-matrix", ref] + extra)
    return out, ref


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", list(MODES))
def test_matrices_byte_equal_to_jax(tmp_path, data, mode):
    mj = tmp_path / "metrics.json"
    out, ref = _run(port_main, data, tmp_path, "port", MODES[mode] + [
        "--device", "cpu", "--backend", "torch", "--metrics-json", str(mj)])
    exp, exp_ref = _run(jax_main, data, tmp_path, "jax", MODES[mode] + [
        "--host", "native", "--backend", "tpu"])
    assert _read(out) == _read(exp)
    if mode == "coverage_umi":
        assert _read(ref) == _read(exp_ref)
    payload = json.loads(mj.read_text())
    assert payload["config"]["device"] == "cpu"
    assert payload["kernel_launches"] == {"sw_pair": 0, "sw_banded": 0,
                                          "band_build": 0, "band_index": 0}
    assert payload["metrics"]["num_reads"] > 0


def test_large_padding_has_no_size_guard(tmp_path, data):
    # haplotypes ~4 kb wide: scored like any other bucket, equal to the
    # JAX package's exact CPU aligner
    out, _ = _run(port_main, data, tmp_path, "port", [
        "--padding", "2000", "--device", "cpu", "--backend", "torch"])
    exp, _ = _run(jax_main, data, tmp_path, "jax", [
        "--padding", "2000", "--host", "native", "--backend", "cpu"])
    assert _read(out) == _read(exp)


def test_row_shard_matches_jax(tmp_path, data):
    # --num-shards/--shard-index: this process scores only its variant rows
    shard = ["--num-shards", "3", "--shard-index", "1"]
    out, _ = _run(port_main, data, tmp_path, "port", shard + [
        "--device", "cpu", "--backend", "torch"])
    exp, _ = _run(jax_main, data, tmp_path, "jax", shard + [
        "--host", "native", "--backend", "tpu"])
    assert _read(out) == _read(exp)


@pytest.mark.parametrize("sw_mode", ["full", "banded"])
def test_hap_matrix_rows_two_per_variant(tmp_path, data, monkeypatch,
                                         sw_mode):
    # each shape bucket's haplotype matrix reaches the backend unpadded:
    # a ref and an alt row per variant of the bucket, every row indexed,
    # and the matrix byte-equal to the JAX package's
    import numpy as np

    from vartrix_tpu_torch.ops import sw_cuda

    cls = sw_cuda.SwBackend if sw_mode == "full" else sw_cuda.BandedSwBackend
    pair_calls = cls.pair_calls_chained
    seen = []

    def recorded(self, x, hap_mat, idx_ref, idx_alt):
        seen.append((hap_mat.shape[0], np.unique(idx_ref), np.unique(idx_alt)))
        return pair_calls(self, x, hap_mat, idx_ref, idx_alt)

    monkeypatch.setattr(cls, "pair_calls_chained", recorded)
    out, _ = _run(port_main, data, tmp_path, "port", [
        "--sw-mode", sw_mode, "--device", "cpu", "--backend", "torch"])
    assert seen
    for rows, ref_rows, alt_rows in seen:
        n_variants = len(ref_rows)
        assert rows == 2 * n_variants
        assert ref_rows.tolist() == list(range(0, rows, 2))
        assert alt_rows.tolist() == list(range(1, rows, 2))
    exp, _ = _run(jax_main, data, tmp_path, "jax", [
        "--sw-mode", sw_mode, "--host", "native", "--backend", "cpu"])
    assert _read(out) == _read(exp)
