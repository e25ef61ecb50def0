"""--stream N in the port: windowed decode->collect->score byte-equal to
the port's monolithic run and to the JAX package's --stream, in the three
scoring modes, in full and banded mode, with windows that split
chromosomes; the metrics match; with --checkpoint-dir, or without a usable
index, the run is monolithic."""

import json
import shutil

import pytest

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.driver import _main as port_main

MODES = {
    "consensus": [],
    "coverage_umi": ["--umi", "-s", "coverage"],
    "alt_frac": ["-s", "alt_frac", "--mapq", "20"],
}
PORT = ["--device", "cpu", "--backend", "torch"]
JAX = ["--backend", "cpu", "--host", "native"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    # 100 variants on 3 chromosomes: windows of 17 and of 64 both split
    # chromosomes, and 64 leaves a short last window
    d = tmp_path_factory.mktemp("stream")
    return generate_dataset(str(d / "s"), SynthConfig(
        n_chroms=3, chrom_len=80_000, n_variants=100, n_cells=40,
        reads_per_variant=6, seed=23, spliced_frac=0.4))


def _run(main, data, out, extra):
    main(["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
          "-c", data["barcodes"], "-o", str(out), "--ref-matrix",
          str(out) + ".ref", "--threads", "2", *extra])
    with open(out, "rb") as f:
        mtx = f.read()
    if "coverage" not in extra:
        return mtx, b""
    with open(str(out) + ".ref", "rb") as f:
        return mtx, f.read()


@pytest.mark.parametrize("sw_mode", ["full", "banded"])
@pytest.mark.parametrize("mode", list(MODES))
def test_stream_equals_monolithic_and_jax(dataset, tmp_path, mode, sw_mode):
    args = MODES[mode] + ["--sw-mode", sw_mode]
    mono = _run(port_main, dataset, tmp_path / "mono.mtx", args + PORT)
    assert mono[0].count(b"\n") > 10
    for n in (17, 64):
        got = _run(port_main, dataset, tmp_path / f"p{n}.mtx",
                   args + PORT + ["--stream", str(n)])
        want = _run(jax_main, dataset, tmp_path / f"j{n}.mtx",
                    args + JAX + ["--stream", str(n)])
        assert got == mono
        assert got == want


def test_stream_metrics_match(dataset, tmp_path, caplog):
    m1, m2, m3 = (str(tmp_path / f"m{i}.json") for i in range(3))
    _run(port_main, dataset, tmp_path / "a.mtx", PORT + ["--metrics-json", m1])
    _run(port_main, dataset, tmp_path / "b.mtx",
         PORT + ["--stream", "40", "--metrics-json", m2, "--log-level",
                 "info"])
    assert "Streamed 100 variants over 3 windows of <=40" in caplog.text
    _run(jax_main, dataset, tmp_path / "c.mtx",
         JAX + ["--stream", "40", "--metrics-json", m3])
    a, b, c = (json.load(open(m)) for m in (m1, m2, m3))
    assert a["metrics"] == b["metrics"] == c["metrics"]
    assert a["metrics"]["num_reads"] > 0
    assert "stream" in b["phase_seconds"]
    assert not {"decode", "collect", "score"} & set(b["phase_seconds"])
    assert b["kernel_launches"] == {"sw_pair": 0, "sw_banded": 0,
                                    "band_build": 0, "band_index": 0}
    assert b["config"]["fetch"] == c["config"]["fetch"] == "auto"


def test_stream_with_checkpoint_runs_monolithic(dataset, tmp_path, caplog):
    mono = _run(port_main, dataset, tmp_path / "mono.mtx", PORT)
    got = _run(port_main, dataset, tmp_path / "ck.mtx",
               PORT + ["--stream", "17", "--checkpoint-dir",
                       str(tmp_path / "ck"), "--log-level", "info"])
    assert got == mono
    assert ("--stream is incompatible with --checkpoint-dir; running "
            "monolithic") in caplog.text
    assert "Checkpoint: 0 variants loaded, 100 scored" in caplog.text
    assert "Streamed" not in caplog.text


def test_stream_without_index_runs_monolithic(dataset, tmp_path, caplog):
    mono = _run(port_main, dataset, tmp_path / "mono.mtx", PORT)
    d = tmp_path / "stub"
    d.mkdir()
    bam = str(d / "reads.bam")
    shutil.copy(dataset["bam"], bam)
    with open(bam + ".bai", "wb") as f:
        f.write(b"stub")
    got = _run(port_main, dict(dataset, bam=bam), tmp_path / "s.mtx",
               PORT + ["--stream", "17", "--log-level", "info"])
    assert got == mono
    assert ("--stream requested but no usable BAM index; running "
            "monolithic") in caplog.text
    assert "(strategy: whole)" in caplog.text
