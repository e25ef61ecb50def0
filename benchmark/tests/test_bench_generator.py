"""The benchmark's traffic generator: deterministic per seed, its files
byte for byte what the port's own writer makes of the same records, and
the traffic the workloads state (STAR mapq, N reads, distinct
barcodes)."""

import json
import os

import numpy as np
import pytest

from benchmark import harness
from benchmark.inputs import bam, synth
from benchmark.tests import load_any_cell
from vartrix_tpu_torch.io.bam_writer import encode_record, write_bam
from vartrix_tpu_torch.io.fasta import IndexedFasta

SMALL = dict(n_chroms=2, chrom_len=20_000, n_variants=20, n_cells=50,
             reads_per_variant=30, background_reads=400, spliced_frac=0.5,
             multimap_frac=0.3, n_read_frac=0.2)
COLUMNS = ("tid", "pos", "flag", "mapq", "cigar_ops", "cigar_lens",
           "n_cigar", "seq", "cell", "umi", "qname_id", "genome", "v_pos")


def test_same_seed_same_dataset():
    a = synth.generate(SMALL, 2 ** 31 + 3)
    b = synth.generate(SMALL, 2 ** 31 + 3)
    c = synth.generate(SMALL, 2 ** 31 + 4)
    for k in COLUMNS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.v_ref == b.v_ref and a.v_alt == b.v_alt
    assert a.barcodes == b.barcodes
    assert not np.array_equal(a.seq, c.seq)


def test_files_equal_the_ports_writer(tmp_path):
    ds = synth.generate(SMALL, 17)
    paths = bam.write(ds, str(tmp_path / "b"))
    recs = []
    for k in range(ds.n):
        cig = [(int(ds.cigar_ops[k, j]), int(ds.cigar_lens[k, j]))
               for j in range(ds.n_cigar[k])]
        recs.append(encode_record(
            qname=b"r%09d" % ds.qname_id[k], flag=int(ds.flag[k]),
            tid=int(ds.tid[k]), pos=int(ds.pos[k]), mapq=int(ds.mapq[k]),
            cigar=cig, seq=ds.seq[k].tobytes(),
            tags=[(b"CB", ds.barcodes[ds.cell[k]].encode()),
                  (b"UB", ds.umi[k].tobytes())]))
    port = str(tmp_path / "port.bam")
    write_bam(port, [(c, ds.chrom_len) for c in ds.chroms], recs)
    for ext in ("", ".bai"):
        with open(paths["bam"] + ext, "rb") as f, open(port + ext,
                                                       "rb") as g:
            assert f.read() == g.read(), ext
    fa = IndexedFasta(paths["fasta"])
    for name, g in zip(ds.chroms, ds.genome):
        assert fa.fetch_upper(name, 0, ds.chrom_len) == g.tobytes()


def test_traffic_as_stated():
    ds = synth.generate({**SMALL, "n_read_frac": 0.01,
                         "multimap_frac": 0.08,
                         "background_reads": 20_000}, 5)
    assert set(np.unique(ds.mapq).tolist()) <= {0, 1, 3, 255}
    multi = (ds.mapq != 255).mean()
    assert 0.06 < multi < 0.10
    with_n = (ds.seq == ord("N")).any(axis=1).mean()
    assert 0.007 < with_n < 0.013
    assert len(set(ds.barcodes)) == len(ds.barcodes)
    assert np.all(np.diff(ds.tid.astype(np.int64) << 32 | ds.pos) >= 0)


def test_dataset_files_follow_the_seed(tmp_path):
    cell = load_any_cell("souporcell-dense")
    cell.workload["generator"] = {**cell.workload["generator"], **SMALL}
    paths, n = harness.dataset(cell, 9, 2, str(tmp_path / "a"))
    assert n == synth.generate(cell.generator, 9).n
    again, n2 = harness.dataset(cell, 9, 2, str(tmp_path / "b"))
    other, _ = harness.dataset(cell, 10, 2, str(tmp_path / "c"))
    assert n2 == n
    for kind in paths:
        with open(paths[kind], "rb") as f, open(again[kind], "rb") as g:
            assert f.read() == g.read()
    with open(paths["bam"], "rb") as f, open(other["bam"], "rb") as g:
        assert f.read() != g.read()


def test_too_small_bam_fails(tmp_path):
    cell = harness.load_cell("readme-sparse")
    cell.workload["generator"] = {**cell.workload["generator"], **SMALL}
    with pytest.raises(RuntimeError, match="under"):
        harness.dataset(cell, 1, 2, str(tmp_path / "in"))


@pytest.mark.parametrize("name", ["souporcell-dense", "readme-dense",
                                  "readme-sparse"])
def test_workload_files_name_their_generator(name):
    with open(os.path.join(harness.BENCH_DIR, "workloads",
                           f"{name}.json")) as f:
        w = json.load(f)
    assert set(w["generator"]) <= set(synth.DEFAULTS)
    cell = load_any_cell(name)
    assert cell.generator["read_len"] == cell.config["shapes"]["read_len"]
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "inputs",
                                       f"{w['input']}.py"))
