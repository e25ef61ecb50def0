"""--checkpoint-dir in the port: the first run scores and saves every
variant, a rerun loads them and scores nothing, a changed filter flag
invalidates the directory, and the manifest key is the JAX package's, so
a directory the JAX package wrote resumes in the port. Every matrix is
byte-equal to the run without a checkpoint and to the JAX package's."""

import os

import pytest
import torch

from vartrix_tpu.core.checkpoint import manifest_key as jax_manifest_key
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.core.checkpoint import ScoreCheckpoint, manifest_key
from vartrix_tpu_torch.driver import _main as port_main
from vartrix_tpu_torch.ops import sw_cuda

N_VARIANTS = 9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scorer's many small ops on one thread: with the suite's
    workers sharing the cores, spinning intra-op threads slow it 50x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("ck")), SynthConfig(
        n_variants=N_VARIANTS, n_cells=25, reads_per_variant=15, seed=53))


@pytest.fixture
def scored(monkeypatch):
    """Counts the reads the port's scorer is handed."""
    n = [0]
    call = sw_cuda.SwBackend.pair_calls_chained

    def counted(self, x, hap_mat, idx_ref, idx_alt):
        n[0] += len(idx_ref)
        return call(self, x, hap_mat, idx_ref, idx_alt)

    monkeypatch.setattr(sw_cuda.SwBackend, "pair_calls_chained", counted)
    return n


def _run(main, data, out, extra):
    main(["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
          "-c", data["barcodes"], "-o", str(out), "--log-level", "info",
          *extra])
    return out.read_bytes()


def _checkpoint_lines(caplog):
    lines = [r.getMessage() for r in caplog.records
             if "Checkpoint" in r.getMessage()]
    caplog.clear()
    return lines


def test_resume_and_invalidation(data, tmp_path, caplog, scored):
    port = ["--device", "cpu", "--backend", "torch"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    plain = _run(port_main, data, tmp_path / "plain.mtx", port)
    caplog.clear()
    scored[0] = 0

    first = _run(port_main, data, tmp_path / "first.mtx", port + ck)
    assert first == plain
    assert _checkpoint_lines(caplog) == [
        f"Checkpoint: 0 variants loaded, {N_VARIANTS} scored"]
    n_first = scored[0]
    assert n_first > 0
    assert len([f for f in os.listdir(tmp_path / "ck")
                if f.endswith(".npy")]) == N_VARIANTS

    second = _run(port_main, data, tmp_path / "second.mtx", port + ck)
    assert second == plain
    assert _checkpoint_lines(caplog) == [
        f"Checkpoint: {N_VARIANTS} variants loaded, 0 scored"]
    assert scored[0] == n_first  # the rerun scored nothing

    # a changed filter flag invalidates the directory
    third = _run(port_main, data, tmp_path / "third.mtx",
                 port + ck + ["--mapq", "30"])
    lines = _checkpoint_lines(caplog)
    assert any("was created for different inputs/flags" in m for m in lines)
    assert f"Checkpoint: 0 variants loaded, {N_VARIANTS} scored" in lines
    assert third == _run(jax_main, data, tmp_path / "jax30.mtx",
                         ["--mapq", "30", "--backend", "cpu", "--host",
                          "native"])


def test_directory_written_by_jax_resumes(data, tmp_path, caplog, scored):
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    want = _run(jax_main, data, tmp_path / "jax.mtx",
                ck + ["--backend", "cpu", "--host", "native"])
    caplog.clear()
    got = _run(port_main, data, tmp_path / "port.mtx",
               ck + ["--device", "cpu", "--backend", "torch"])
    assert got == want
    assert _checkpoint_lines(caplog) == [
        f"Checkpoint: {N_VARIANTS} variants loaded, 0 scored"]
    assert scored[0] == 0


def test_manifest_key_equal_to_jax(data):
    paths = [data["vcf"], data["bam"], data["fasta"], data["barcodes"]]
    flags = {"padding": 100, "mapq": 0, "primary": False,
             "duplicates": False, "umi": True, "bam_tag": "CB",
             "valid_chars": "ATGCatgc"}
    assert manifest_key(paths, flags) == jax_manifest_key(paths, flags)
    assert manifest_key(paths, dict(flags, mapq=1)) != manifest_key(paths,
                                                                     flags)


def test_unreadable_block_is_rescored(tmp_path):
    ck = ScoreCheckpoint(str(tmp_path), "k")
    with open(tmp_path / "scores_3.npy", "wb") as f:
        f.write(b"torn write")
    assert ck.load(3) is None
    assert ck.load(4) is None
