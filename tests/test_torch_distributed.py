"""Row shards over processes (--distributed) against single-process runs
and the JAX package: two `python -m vartrix_tpu_torch --device cpu
--backend torch --distributed ADDR:PORT,2,RANK` processes on gloo, whose
rank 0's matrices must be CSR-equal (NaN-aware) to a single-process run of
the port and byte-equal to the JAX package's single-process run, with the
same metrics counters, while rank 1 writes nothing; and gather_triplets in
two processes, bit for bit on NaN payloads, infinities and -0.0. Each
process pair listens on a free port of its own."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.io

from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch import driver as port_driver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one intra-op thread per process: the suite's workers share the cores
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": os.pathsep.join(
           [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_pair(argv_of_rank):
    """Starts ranks 0 and 1 (argv_of_rank(rank, spec)); returns each one's
    output after it exits 0."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, *argv_of_rank(r, f"127.0.0.1:{port},2,{r}")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=ENV, cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    return outs


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("dist")), SynthConfig(
        n_variants=12, n_cells=30, reads_per_variant=30, seed=41,
        indel_frac=0.2))


def _argv(ds, d, tag, mode):
    return ["-v", ds["vcf"], "-b", ds["bam"], "-f", ds["fasta"],
            "-c", ds["barcodes"], "-o", str(d / f"{tag}.mtx"),
            "--ref-matrix", str(d / f"{tag}.ref"),
            "--metrics-json", str(d / f"{tag}.json"), *mode]


def _csr_equal(a, b):
    x, y = scipy.io.mmread(str(a)).tocsr(), scipy.io.mmread(str(b)).tocsr()
    x.sort_indices()
    y.sort_indices()
    return (x.shape == y.shape and np.array_equal(x.indptr, y.indptr)
            and np.array_equal(x.indices, y.indices)
            and np.array_equal(x.data, y.data, equal_nan=True))


PORT = ["--device", "cpu", "--backend", "torch"]


@pytest.mark.parametrize("mode", [["-s", "coverage", "--umi"],
                                  ["-s", "alt_frac"]],
                         ids=["coverage_umi", "alt_frac"])
def test_two_processes_equal_to_single_and_jax(ds, tmp_path, mode):
    port_driver._main(_argv(ds, tmp_path, "single", mode + PORT))
    jax_main(_argv(ds, tmp_path, "jax", mode + ["--backend", "cpu"]))
    _start_pair(lambda r, spec: [
        "-m", "vartrix_tpu_torch", *_argv(ds, tmp_path, f"rank{r}", mode),
        *PORT, "--log-level", "info", "--distributed", spec])
    files = ["mtx", "ref"] if "coverage" in mode else ["mtx"]
    for ext in files:
        got = tmp_path / f"rank0.{ext}"
        assert _csr_equal(got, tmp_path / f"single.{ext}")
        assert got.read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    with open(tmp_path / "rank0.json") as f:
        got = json.load(f)
    with open(tmp_path / "single.json") as f:
        single = json.load(f)
    with open(tmp_path / "jax.json") as f:
        jax = json.load(f)
    assert got["metrics"] == single["metrics"] == jax["metrics"]
    assert got["matrix"] == single["matrix"]
    assert got["metrics"]["num_reads"] > 0
    assert not any(p.name.startswith("rank1") for p in tmp_path.iterdir())


WORKER = """
import sys
import numpy as np
from vartrix_tpu_torch.io.matrix_market import TriMat
from vartrix_tpu_torch.parallel import multihost

rank, spec, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
bits = np.array([0x7FF8000000000000, 0x7FF0000000000001,
                 0xFFF80000DEADBEEF, 0x7FF0000000000000,
                 0x8000000000000000, 0x3FD5555555555555], np.uint64)
m = TriMat((4, 5))
if rank == 0:
    m.add_triplets([0, 1], [2, 3], bits[:2].view(np.float64))
else:
    m.add_triplets([2, 3, 3, 2], [0, 1, 4, 4], bits[2:].view(np.float64))
with multihost.process_group(spec) as (r, n):
    got = multihost.gather_triplets(m, r, n)
if r == 0:
    np.savez(out, rows=got.rows, cols=got.cols,
             bits=np.ascontiguousarray(got.data).view(np.uint64))
else:
    assert got is m
"""


def test_gather_triplets_bit_exact(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    out = tmp_path / "gathered.npz"
    _start_pair(lambda r, spec: [str(worker), str(r), spec, str(out)])
    got = np.load(out)
    assert got["rows"].tolist() == [0, 1, 2, 3, 3, 2]
    assert got["cols"].tolist() == [2, 3, 0, 1, 4, 4]
    assert got["bits"].tolist() == [
        0x7FF8000000000000, 0x7FF0000000000001, 0xFFF80000DEADBEEF,
        0x7FF0000000000000, 0x8000000000000000, 0x3FD5555555555555]
