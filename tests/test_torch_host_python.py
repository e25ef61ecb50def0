"""The port's Python host path (--host python) against the JAX package: the
record readers (io/bam.BamReader, io/bai.RegionStream under a region plan,
io/cram.CramReader with and without a .crai container plan) through
collect_reads, the per-variant scores of score_all on both backends' plain
versions, the per-cell calls, the debug alignment log, and the `.mtx` of
whole runs byte for byte (BAM and CRAM, --sw-mode full and banded, three
scoring modes). Inputs are seeded synthetic data of a few hundred reads;
the tolerance is exact equality."""

import json
import logging

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vartrix_tpu.core import calls as jcalls
from vartrix_tpu.core import pipeline as jpipe
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.driver import _select_backend
from vartrix_tpu.io import bai as jbai
from vartrix_tpu.io import cram as jcram
from vartrix_tpu.io.bam import BamReader as JaxBamReader
from vartrix_tpu.io.fasta import IndexedFasta as JaxFasta
from vartrix_tpu.io.vcf import read_vcf_records as jax_read_vcf
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch import driver as port_driver
from vartrix_tpu_torch.core import calls as pcalls
from vartrix_tpu_torch.core import pipeline as ppipe
from vartrix_tpu_torch.io import bai as pbai
from vartrix_tpu_torch.io import cram as pcram
from vartrix_tpu_torch.io.bam import BamReader
from vartrix_tpu_torch.io.barcodes import load_barcodes
from vartrix_tpu_torch.io.fasta import IndexedFasta
from vartrix_tpu_torch.io.vcf import read_vcf_records
from vartrix_tpu_torch.ops import sw_cuda

MODES = {
    "consensus": ["-s", "consensus"],
    "coverage_umi": ["-s", "coverage", "--umi"],
    "alt_frac": ["-s", "alt_frac"],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scorer's many small ops on one thread: with the suite's
    workers sharing the cores, spinning intra-op threads slow it 50x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """A BAM and the same reads as a CRAM of several containers, with its
    .crai."""
    d = tmp_path_factory.mktemp("pyhost")
    info = generate_dataset(str(d), SynthConfig(
        n_variants=10, n_cells=30, reads_per_variant=20, seed=33,
        spliced_frac=0.3, indel_frac=0.2))
    b = BamReader(info["bam"])
    cram = str(d / "reads.cram")
    pcram.write_cram(cram, list(zip(b.ref_names, b.ref_lens)), b.records(),
                     fasta_path=info["fasta"], records_per_container=50)
    pcram.write_crai(cram, fasta_path=info["fasta"])
    return dict(info, cram=cram)


def _works(pkg_pipe, fasta_cls, read_vcf, ds, use_umi=True):
    args = pkg_pipe.PipelineArgs(use_umi=use_umi)
    return pkg_pipe.prepare_variants(read_vcf(ds["vcf"]),
                                     fasta_cls(ds["fasta"]), args), args


def _loci(ds):
    return [(f"chr{c + 1}", p, p + len(r)) for c, p, r, _ in ds["variants"]]


def _sources(kind, ds):
    """(port reader, JAX reader) of one record source."""
    if kind == "bam":
        return BamReader(ds["bam"]), JaxBamReader(ds["bam"])
    if kind == "region_stream":
        tids = BamReader(ds["bam"]).tid_by_name
        plan, _ = pbai.plan_region_fetch(ds["bam"], _loci(ds)[:4], tids)
        assert plan == jbai.plan_region_fetch(ds["bam"], _loci(ds)[:4],
                                              tids)[0]
        return (pbai.RegionStream(ds["bam"], plan),
                jbai.RegionStream(ds["bam"], plan))
    port, jax = (pcram.CramReader(ds["cram"], ds["fasta"]),
                 jcram.CramReader(ds["cram"], ds["fasta"]))
    if kind == "cram":
        return port, jax
    offs = port.containers_for_loci(_loci(ds)[:4])
    assert offs == jax.containers_for_loci(_loci(ds)[:4])
    assert 0 < len(offs) < len(port.container_offsets())
    return (port_driver._CramRegions(port, offs),
            type("R", (), {"tid_by_name": jax.tid_by_name,
                           "records": lambda self: jax.records_for_containers(
                               offs)})())


@pytest.mark.parametrize("kind", ["bam", "region_stream", "cram",
                                  "cram_containers"])
def test_collect_reads_equal_to_jax(ds, kind):
    port_src, jax_src = _sources(kind, ds)
    barcodes = load_barcodes(ds["barcodes"])
    pw, pargs = _works(ppipe, IndexedFasta, read_vcf_records, ds)
    jw, jargs = _works(jpipe, JaxFasta, jax_read_vcf, ds)
    ppipe.collect_reads(port_src, pw, barcodes, pargs)
    jpipe.collect_reads(jax_src, jw, barcodes, jargs)
    n = 0
    for a, b in zip(pw, jw):
        assert (a.read_seqs, a.cell_indices, a.umis, a.qnames) == (
            b.read_seqs, b.cell_indices, b.umis, b.qnames)
        assert (a.metrics.as_dict() if a._metrics else None) == (
            b.metrics.as_dict() if b._metrics else None)
        n += len(a.read_seqs)
    assert n > 0


@pytest.mark.parametrize("sw_mode", ["full", "banded"])
def test_score_all_equal_to_jax(ds, sw_mode):
    barcodes = load_barcodes(ds["barcodes"])
    pw, pargs = _works(ppipe, IndexedFasta, read_vcf_records, ds, False)
    jw, jargs = _works(jpipe, JaxFasta, jax_read_vcf, ds, False)
    ppipe.collect_reads(BamReader(ds["bam"]), pw, barcodes, pargs)
    jpipe.collect_reads(JaxBamReader(ds["bam"]), jw, barcodes, jargs)
    # an empty haplotype scores 0 without a call to the backend
    pw[0].alt_hap = jw[0].alt_hap = b""
    backend = (sw_cuda.SwBackend if sw_mode == "full"
               else sw_cuda.BandedSwBackend)("cpu", kernel=False)
    got = ppipe.score_all(pw, backend)
    want = jpipe.score_all(jw, _select_backend("cpu", 2, sw_mode))
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert not got[0][:, 1].any() and max(int(a.max(initial=0))
                                          for a in got) > 25


_scores = st.lists(st.builds(
    jcalls.Scores, cell_index=st.integers(0, 6),
    umi=st.sampled_from([b"\x01", b"AAA", b"CCC", b"GGG"]),
    ref_score=st.integers(0, 60), alt_score=st.integers(0, 60)),
    max_size=40)


@settings(max_examples=60, deadline=None)
@given(_scores, st.booleans())
def test_calls_equal_to_jax(scores, use_umi):
    scores = sorted(scores, key=lambda s: s.cell_index)
    port = [pcalls.Scores(s.cell_index, s.umi, s.ref_score, s.alt_score)
            for s in scores]
    for fn in ("consensus_scoring", "alt_frac", "coverage"):
        got = getattr(pcalls, fn)(port, 3, use_umi)
        want = getattr(jcalls, fn)(scores, 3, use_umi)
        assert repr(got) == repr(want)


def _run(main, ds, reads, out, extra, host="python"):
    argv = ["-v", ds["vcf"], "-b", reads, "-f", ds["fasta"],
            "-c", ds["barcodes"], "-o", str(out),
            "--ref-matrix", str(out) + ".ref", "--host", host, *extra]
    main(argv)
    with open(out, "rb") as f:
        got = f.read()
    if "coverage" in extra:
        with open(str(out) + ".ref", "rb") as f:
            got += f.read()
    return got


@pytest.mark.parametrize("sw_mode", ["full", "banded"])
@pytest.mark.parametrize("reads", ["bam", "cram"])
@pytest.mark.parametrize("mode", list(MODES))
def test_python_host_run_byte_equal_to_jax(ds, tmp_path, mode, reads,
                                           sw_mode):
    args = MODES[mode] + ["--sw-mode", sw_mode]
    got = _run(port_driver._main, ds, ds[reads], tmp_path / "p.mtx",
               args + ["--device", "cpu", "--backend", "torch"])
    want = _run(jax_main, ds, ds[reads], tmp_path / "j.mtx",
                args + ["--backend", "cpu"])
    assert got == want


def test_python_host_region_plan_byte_equal_to_jax(ds, tmp_path,
                                                   monkeypatch):
    # --fetch regions on the BAM: the records come from a RegionStream
    monkeypatch.setattr(port_driver, "AUTO_REGION_BYTES", 0)
    args = ["--fetch", "regions"]
    got = _run(port_driver._main, ds, ds["bam"], tmp_path / "p.mtx",
               args + ["--device", "cpu", "--backend", "torch"])
    want = _run(jax_main, ds, ds["bam"], tmp_path / "j.mtx",
                args + ["--backend", "cpu"])
    assert got == want


def _alignment_lines(caplog):
    return [r.getMessage() for r in caplog.records
            if "_aln:" in r.getMessage() or "ref_score:" in r.getMessage()]


@pytest.mark.parametrize("host", ["python", "auto"])
def test_debug_alignment_log_equal_to_jax(tmp_path, caplog, host):
    # a few reads: each alignment is traced back in Python. --host auto
    # takes the Python host at --log-level debug in both packages
    ds = generate_dataset(str(tmp_path / "d"), SynthConfig(
        n_variants=3, n_cells=8, reads_per_variant=5, seed=35))
    debug = ["--log-level", "debug", "--metrics-json"]
    with caplog.at_level(logging.DEBUG, logger="vartrix"):
        got_mtx = _run(port_driver._main, ds, ds["bam"], tmp_path / "p.mtx",
                       ["--device", "cpu", "--backend", "torch", *debug,
                        str(tmp_path / "p.json")], host)
        got = _alignment_lines(caplog)
        caplog.clear()
        want_mtx = _run(jax_main, ds, ds["bam"], tmp_path / "j.mtx",
                        ["--backend", "cpu", *debug,
                         str(tmp_path / "j.json")], host)
        want = _alignment_lines(caplog)
    assert got == want and len(got) > 20
    assert got_mtx == want_mtx
    hosts = [json.loads((tmp_path / f"{k}.json").read_text())["config"]["host"]
             for k in "pj"]
    assert hosts == ["python", "python"]
