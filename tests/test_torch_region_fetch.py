"""The port's indexed region fetch against the JAX package: the merged
chunk plan (BAI and CSI), the index builders' bytes, the chunk-list merge,
the region and bounded-memory column loaders, and the `.mtx` of --fetch
whole/auto/regions byte for byte, on a sparse whole-genome-like dataset
(2 x 2 Mb, 12 variants, 20,000 background reads)."""

import itertools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.io import bai as jbai
from vartrix_tpu.io.bam_native import ColumnarBam as JaxColumnarBam
from vartrix_tpu.io.cram import write_crai as jax_write_crai
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch import driver as port_driver
from vartrix_tpu_torch.io import bai as pbai
from vartrix_tpu_torch.io import bam_native as pbn
from vartrix_tpu_torch.io.bam import BamHeader
from vartrix_tpu_torch.io.bam import BamReader as PortBamReader
from vartrix_tpu_torch.io.cram import write_cram

COLUMNS = ("tid", "pos", "ref_end", "mapq", "flag", "seq_off", "seq_pool",
           "itv_off", "itv_pool", "cb_off", "cb_pool", "ub_off", "ub_pool")
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
def sparse_ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse")
    return generate_dataset(str(d), SynthConfig(
        n_chroms=2, chrom_len=2_000_000, n_variants=12, n_cells=60,
        reads_per_variant=40, background_reads=20_000, seed=9))


@pytest.fixture(scope="module")
def csi_ds(sparse_ds, tmp_path_factory):
    """The same BAM indexed by a CSI only."""
    d = tmp_path_factory.mktemp("csi")
    bam = str(d / "reads.bam")
    shutil.copy(sparse_ds["bam"], bam)
    jbai.build_csi(bam)
    return dict(sparse_ds, bam=bam)


def _loci(info):
    return [(f"chr{c + 1}", p, p + len(r)) for c, p, r, a in info["variants"]]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_columns_equal(a, b):
    assert a.n == b.n and a.ref_names == b.ref_names
    for attr in COLUMNS:
        assert np.array_equal(getattr(a, attr), getattr(b, attr)), attr


@pytest.mark.parametrize("index", ["bai", "csi"])
def test_plan_equal_to_jax(sparse_ds, csi_ds, index):
    info = sparse_ds if index == "bai" else csi_ds
    tids = BamHeader(info["bam"]).tid_by_name
    loci = _loci(info)
    rng = np.random.default_rng(5)
    subsets = [loci, loci[:1], loci[3:9],
               [loci[i] for i in rng.choice(len(loci), 5, replace=False)]]
    for sub in subsets:
        plan, frac = pbai.plan_region_fetch(info["bam"], sub, tids)
        assert (plan, frac) == jbai.plan_region_fetch(info["bam"], sub, tids)
        assert plan
    plan, frac = pbai.plan_region_fetch(info["bam"], loci, tids)
    assert frac < 0.5  # the sparse dataset qualifies for auto


def test_plan_without_readable_index(sparse_ds, tmp_path):
    bam = str(tmp_path / "reads.bam")
    shutil.copy(sparse_ds["bam"], bam)
    tids = BamHeader(bam).tid_by_name
    assert pbai.plan_region_fetch(bam, _loci(sparse_ds), tids) == (None, 1.0)
    with open(bam + ".bai", "wb") as f:
        f.write(b"not an index")
    assert pbai.plan_region_fetch(bam, _loci(sparse_ds), tids) == (None, 1.0)


@pytest.mark.parametrize("kind", ["bai", "csi"])
def test_built_index_bytes_equal_to_jax(sparse_ds, tmp_path, kind):
    port_fn = getattr(pbai, f"build_{kind}")
    jax_fn = getattr(jbai, f"build_{kind}")
    port_fn(sparse_ds["bam"], str(tmp_path / f"p.{kind}"))
    jax_fn(sparse_ds["bam"], str(tmp_path / f"j.{kind}"))
    got = _read(tmp_path / f"p.{kind}")
    assert got == _read(tmp_path / f"j.{kind}")
    if kind == "bai":
        # the index write_bam wrote beside the file is the same index
        assert got == _read(sparse_ds["bam"] + ".bai")
        idx = pbai.BaiIndex(str(tmp_path / "p.bai"))
    else:
        idx = pbai.CsiIndex(str(tmp_path / "p.csi"))
    assert len(idx.bins) == 2


@pytest.mark.parametrize("lists,want", [
    ([[(0 << 16 | 0, 5 << 16 | 100)], [(3 << 16 | 0, 9 << 16 | 5)],
      [((9 + 16384) << 16, (9 + 16385) << 16)],
      [((9 + 400000) << 16, (9 + 400001) << 16)]],
     [(0, (9 + 16385) << 16), ((9 + 400000) << 16, (9 + 400001) << 16)]),
    ([[(10, 1000)], [(20, 30)]], [(10, 1000)]),
    ([], []),
    ([[], []], []),
], ids=["overlap_and_gap_bridge", "contained", "empty", "empty_lists"])
def test_merge_chunk_lists(lists, want):
    assert pbai.merge_chunk_lists(lists) == want
    assert jbai.merge_chunk_lists(lists) == want


def test_reg2bins_equal_to_jax():
    for beg, end in ((0, 1), (0, 400), (16383, 16385), (1 << 20, 3 << 20),
                     (123456, 7654321)):
        assert pbai.reg2bins(beg, end) == jbai.reg2bins(beg, end)
        assert (pbai.reg2bins_csi(beg, end, 14, 6)
                == jbai.reg2bins_csi(beg, end, 14, 6))


def test_region_columns_equal_to_jax(sparse_ds):
    info = sparse_ds
    tids = BamHeader(info["bam"]).tid_by_name
    plan, _ = pbai.plan_region_fetch(info["bam"], _loci(info), tids)
    got = pbn.ColumnarBam(info["bam"], b"CB", chunks=plan)
    assert got.loader == "regions"
    _assert_columns_equal(
        got, JaxColumnarBam(info["bam"], b"CB", chunks=np.asarray(plan)))
    # far fewer records than the file, and every variant's reads
    whole = pbn.ColumnarBam(info["bam"], b"CB")
    assert whole.loader == "whole"
    assert 12 * 40 <= got.n < whole.n * 0.5
    for chrom, s, e in _loci(info):
        tid = whole.tid_by_name[chrom]
        want = ((whole.tid == tid) & (whole.pos < e) & (whole.ref_end > s)).sum()
        assert ((got.tid == tid) & (got.pos < e) & (got.ref_end > s)).sum() == want


def test_bounded_loader_equal_to_monolithic(sparse_ds, monkeypatch):
    """The bounded-memory loader, really taken (threshold lowered, 1 MiB
    segments so records cross segment boundaries), gives the columns of
    the monolithic load and of the JAX package's."""
    bam = sparse_ds["bam"]
    assert os.path.getsize(bam) > 1 << 20
    mono = pbn.ColumnarBam(bam, b"CB")
    assert mono.loader == "whole"
    monkeypatch.setattr(pbn, "STREAM_DECODE_BYTES", 0)
    monkeypatch.setattr(pbn, "STREAM_SEGMENT_BYTES", 1 << 20)
    bounded = pbn.ColumnarBam(bam, b"CB", n_threads=2)
    assert bounded.loader == "bounded"
    _assert_columns_equal(bounded, mono)
    monkeypatch.setenv("VARTRIX_STREAM_DECODE", "0")
    _assert_columns_equal(bounded, JaxColumnarBam(bam, b"CB"))


def _run(main, info, out, extra):
    main(["-v", info["vcf"], "-b", info["bam"], "-f", info["fasta"],
          "-c", info["barcodes"], "-o", str(out),
          "--ref-matrix", str(out) + ".ref", *extra])
    return _read(out), _read(str(out) + ".ref") if "coverage" in extra else b""


@pytest.mark.parametrize("fetch", ["whole", "auto", "regions"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fetch_matrices_byte_equal_to_jax(sparse_ds, tmp_path, monkeypatch,
                                          caplog, mode, fetch):
    # auto plans only from AUTO_REGION_BYTES; lowered, the sparse BAM takes
    # regions as a real whole-genome BAM would
    monkeypatch.setattr(port_driver, "AUTO_REGION_BYTES", 0)
    args = MODES[mode] + ["--fetch", fetch]
    got = _run(port_driver._main, sparse_ds, tmp_path / "p.mtx",
               args + ["--device", "cpu", "--backend", "torch",
                       "--log-level", "info"])
    strategy = "whole" if fetch == "whole" else "regions"
    assert f"(strategy: {strategy})" in caplog.text
    want = _run(jax_main, sparse_ds, tmp_path / "j.mtx",
                args + ["--host", "native", "--backend", "cpu"])
    assert got == want
    assert got[0].count(b"\n") > 3


@pytest.mark.parametrize("mode", list(MODES))
def test_banded_regions_byte_equal_to_jax(sparse_ds, tmp_path, mode):
    args = MODES[mode] + ["--fetch", "regions", "--sw-mode", "banded"]
    got = _run(port_driver._main, sparse_ds, tmp_path / "p.mtx",
               args + ["--device", "cpu", "--backend", "torch"])
    want = _run(jax_main, sparse_ds, tmp_path / "j.mtx",
                args + ["--host", "native", "--backend", "cpu"])
    assert got == want


def test_auto_small_bam_decodes_whole(sparse_ds, tmp_path, caplog):
    _run(port_driver._main, sparse_ds, tmp_path / "p.mtx",
         ["--device", "cpu", "--backend", "torch", "--log-level", "info"])
    assert "(strategy: whole)" in caplog.text
    assert "Fetch plan" not in caplog.text


def test_auto_empty_plan_stays_whole(sparse_ds, tmp_path, monkeypatch,
                                     caplog):
    monkeypatch.setattr(port_driver, "AUTO_REGION_BYTES", 0)
    monkeypatch.setattr(port_driver, "plan_region_fetch",
                        lambda *a: ([], 0.0))
    _run(port_driver._main, sparse_ds, tmp_path / "p.mtx",
         ["--device", "cpu", "--backend", "torch", "--log-level", "info"])
    assert "(strategy: whole)" in caplog.text


def test_fetch_regions_without_usable_index_exits(sparse_ds, tmp_path):
    d = tmp_path / "noidx"
    d.mkdir()
    bam = str(d / "reads.bam")
    shutil.copy(sparse_ds["bam"], bam)
    with open(bam + ".bai", "wb") as f:
        f.write(b"stub")
    info = dict(sparse_ds, bam=bam)
    with pytest.raises(SystemExit) as e:
        _run(port_driver._main, info, tmp_path / "p.mtx",
             ["--fetch", "regions", "--device", "cpu", "--backend", "torch"])
    assert e.value.code == 1
    assert not (tmp_path / "p.mtx").exists()


def test_index_cli_rebuilds_bai(sparse_ds, tmp_path):
    bam = str(tmp_path / "reads.bam")
    shutil.copy(sparse_ds["bam"], bam)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "vartrix_tpu_torch.io.bai", bam],
                       cwd=root, capture_output=True, text=True, check=True)
    assert r.stdout.strip() == f"{bam} -> {bam}.bai"
    assert _read(bam + ".bai") == _read(sparse_ds["bam"] + ".bai")
    # a CRAM (told apart by content) gets its .crai, as JAX's write_crai
    # writes it
    b = PortBamReader(sparse_ds["bam"])
    cram = str(tmp_path / "x.cram")
    write_cram(cram, list(zip(b.ref_names, b.ref_lens)),
               itertools.islice(b.records(), 300), records_per_container=100)
    r = subprocess.run([sys.executable, "-m", "vartrix_tpu_torch.io.bai",
                        cram], cwd=root, capture_output=True, text=True,
                       check=True)
    assert r.stdout.strip() == f"{cram} -> {cram}.crai"
    (tmp_path / "jax").mkdir()
    want = str(tmp_path / "jax" / "x.cram.crai")
    jax_write_crai(cram, want)
    # equal bytes but for the gzip header's timestamp (bytes 4-8)
    got, exp = _read(cram + ".crai"), _read(want)
    assert got[:4] + got[8:] == exp[:4] + exp[8:]
