"""The region loader's inflate (csrc/genomio.cpp, gio_bam_load_regions):
the BGZF blocks of all a plan's chunks are inflated across the threads,
whatever the plan's shape. Its columns against the whole-file loader and
the JAX package's region loader on hand-made plans over a multi-block BAM
(one chunk over the whole file, chunks that share a boundary block, a
chunk whose end falls inside a record), a corrupt block, and the block
counters the driver records. And the four loaders, which share these
passes, against the JAX package's on a header of several blocks."""

import gzip
import json
import math
import shutil
import struct

import numpy as np
import pytest

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.io.bam_native import ColumnarBam as JaxColumnarBam
from vartrix_tpu_torch import driver
from vartrix_tpu_torch.io import bai as pbai
from vartrix_tpu_torch.io import bam_native as pbn
from vartrix_tpu_torch.io.bam import BamHeader, _header_end
from vartrix_tpu_torch.io.bam_writer import write_bam
from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

COLUMNS = ("tid", "pos", "ref_end", "mapq", "flag", "seq_off", "seq_pool",
           "itv_off", "itv_pool", "cb_off", "cb_pool", "ub_off", "ub_pool")


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("inflate")),
                            SynthConfig(n_variants=30, n_cells=50,
                                        reads_per_variant=150, seed=23))


def _blocks(path):
    """[(file offset, ISIZE)] of the file's BGZF blocks, EOF block included."""
    with open(path, "rb") as f:
        raw = f.read()
    out, pos = [], 0
    while pos < len(raw):
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        x, bsize = pos + 12, None
        while x < pos + 12 + xlen:
            slen = struct.unpack_from("<H", raw, x + 2)[0]
            if raw[x:x + 2] == b"BC":
                bsize = struct.unpack_from("<H", raw, x + 4)[0] + 1
            x += 4 + slen
        out.append((pos, struct.unpack_from("<I", raw, pos + bsize - 4)[0]))
        pos += bsize
    return out


@pytest.fixture(scope="module")
def layout(ds):
    """(records' (vbeg, vend) virtual offsets, the BAM's blocks)."""
    recs = [(b, e) for b, e, *_ in pbai._bam_records(ds["bam"])[1]]
    return recs, _blocks(ds["bam"])


def _plan_blocks(plan, blocks):
    """The blocks a plan's chunks inflate, a shared boundary block once per
    chunk."""
    n = 0
    for vbeg, vend in plan:
        beg, end = vbeg >> 16, vend >> 16
        n += sum(beg <= off < end or (off == end and vend & 0xFFFF > 0)
                 for off, _ in blocks)
    return n


def _load(ds, plan, n_threads):
    got = pbn.ColumnarBam(ds["bam"], b"CB", n_threads, chunks=plan)
    assert got.loader == "regions"
    return got


def _jax(ds, plan):
    return JaxColumnarBam(ds["bam"], b"CB", 2, chunks=np.asarray(plan))


def _assert_columns_equal(a, b):
    assert a.n == b.n and a.ref_names == b.ref_names
    for attr in COLUMNS:
        assert np.array_equal(getattr(a, attr), getattr(b, attr)), attr


def _gapped_plan(recs):
    """Chunks of 100 records with 300 records left out between them."""
    return [(recs[i][0], recs[i + 100][0])
            for i in range(0, len(recs) - 100, 400)]


@pytest.mark.parametrize("n_threads", [1, 2, 8])
def test_one_chunk_equal_to_whole_and_jax(ds, layout, n_threads):
    recs, blocks = layout
    plan = [(recs[0][0], recs[-1][1])]
    got = _load(ds, plan, n_threads)
    assert got.n == len(recs)
    _assert_columns_equal(got, pbn.ColumnarBam(ds["bam"], b"CB", n_threads))
    _assert_columns_equal(got, _jax(ds, plan))
    # every block holding a record, spread over the threads
    assert got.blocks == _plan_blocks(plan, blocks) == sum(
        1 for _, isize in blocks if isize) >= 16
    assert got.blocks_thread_max == math.ceil(got.blocks / n_threads)


@pytest.mark.parametrize("plan_of", ["one_chunk", "gapped"])
def test_thread_counts_give_identical_columns(ds, layout, plan_of):
    recs, blocks = layout
    plan = ([(recs[0][0], recs[-1][1])] if plan_of == "one_chunk"
            else _gapped_plan(recs))
    assert len(plan) >= (1 if plan_of == "one_chunk" else 8)
    loads = {t: _load(ds, plan, t) for t in (1, 2, 8)}
    for t in (2, 8):
        _assert_columns_equal(loads[t], loads[1])
    _assert_columns_equal(loads[1], _jax(ds, plan))
    for t, got in loads.items():
        assert got.blocks == _plan_blocks(plan, blocks)
        assert got.blocks_thread_max <= math.ceil(got.blocks / t)


def _straddling(recs):
    """Index of a record that starts mid-block and ends in the next block."""
    return next(i for i, (b, e) in enumerate(recs)
                if i > len(recs) // 2 and b & 0xFFFF
                and e >> 16 > b >> 16 and e & 0xFFFF)


@pytest.mark.parametrize("every", [None, 500])
def test_chunks_sharing_a_boundary_block_equal_to_jax(ds, layout, every):
    """Chunks split at record starts inside blocks: each chunk inflates its
    own copy of the block where it meets the next."""
    recs, blocks = layout
    cuts = ([_straddling(recs)] if every is None
            else list(range(every, len(recs), every)))
    starts = [recs[0][0]] + [recs[i][0] for i in cuts]
    plan = list(zip(starts, starts[1:] + [recs[-1][1]]))
    assert sum(1 for b, _ in plan[1:] if b & 0xFFFF) >= len(plan) // 2
    got = _load(ds, plan, 4)
    assert got.n == len(recs)
    _assert_columns_equal(got, _jax(ds, plan))
    _assert_columns_equal(got, pbn.ColumnarBam(ds["bam"], b"CB", 2))
    assert got.blocks == _plan_blocks(plan, blocks) > len(plan)


@pytest.mark.parametrize("where", ["inside_block", "across_blocks"])
def test_chunk_ending_mid_record_equal_to_jax(ds, layout, where):
    """A chunk's end inside a record keeps the whole record: where the
    record runs past the chunk's last block, the loader inflates further
    blocks for it (the defensive extension)."""
    recs, blocks = layout
    j = _straddling(recs)
    if where == "inside_block":
        j = next(i for i in range(j, 0, -1)
                 if recs[i][0] >> 16 == recs[i][1] >> 16)
    vend = recs[j][0] + 1
    plan = [(recs[j - 40][0], vend)]
    got = _load(ds, plan, 4)
    assert got.n == 41
    _assert_columns_equal(got, _jax(ds, plan))
    whole = pbn.ColumnarBam(ds["bam"], b"CB", 2)
    assert np.array_equal(got.pos, whole.pos[j - 40:j + 1])
    assert np.array_equal(got.seq_pool, whole.seq_pool[
        whole.seq_off[j - 40]:whole.seq_off[j + 1]])


@pytest.mark.parametrize("damage", ["deflate", "magic", "isize"])
def test_corrupt_block_raises(ds, layout, tmp_path, damage):
    recs, blocks = layout
    bam = str(tmp_path / "reads.bam")
    shutil.copy(ds["bam"], bam)
    off, isize = blocks[len(blocks) // 2]
    with open(bam, "r+b") as f:
        f.seek(off)
        head = f.read(18)
        xlen = struct.unpack_from("<H", head, 10)[0]
        bsize = struct.unpack_from("<H", head, 16)[0] + 1
        if damage == "deflate":  # BTYPE 11, a reserved block type
            f.seek(off + 12 + xlen)
            f.write(b"\xff")
        elif damage == "magic":
            f.seek(off)
            f.write(b"\x00")
        else:
            f.seek(off + bsize - 4)
            f.write(struct.pack("<I", isize + 1))
    plan = [(recs[0][0], recs[-1][1])]
    for n_threads in (1, 8):
        with pytest.raises(IOError, match="BGZF chunk decode failure"):
            pbn.ColumnarBam(bam, b"CB", n_threads, chunks=plan)
    with pytest.raises(IOError, match="BGZF chunk decode failure"):
        JaxColumnarBam(bam, b"CB", 2, chunks=np.asarray(plan))


@pytest.mark.parametrize("fetch", ["regions", "whole"])
def test_driver_counts_the_blocks(ds, layout, tmp_path, fetch):
    recs, blocks = layout
    threads = 3
    # --mapq 255 drops every read after the decode: nothing to score
    driver._main(["-v", ds["vcf"], "-b", ds["bam"], "-f", ds["fasta"],
                  "-c", ds["barcodes"], "-o", str(tmp_path / "o.mtx"),
                  "--device", "cpu", "--backend", "torch", "--fetch", fetch,
                  "--threads", str(threads), "--mapq", "255",
                  "--metrics-json", str(tmp_path / "m.json")])
    with open(tmp_path / "m.json") as f:
        c = json.load(f)["counters"]
    if fetch == "whole":
        assert "decode.blocks" not in c
        assert "decode.blocks_thread_max" not in c
        return
    loci = [(f"chr{ci + 1}", p, p + len(r)) for ci, p, r, a in ds["variants"]]
    plan, _ = pbai.plan_region_fetch(ds["bam"], loci,
                                     BamHeader(ds["bam"]).tid_by_name)
    assert c["decode.chunks"] == len(plan)
    assert c["decode.blocks"] == _plan_blocks(plan, blocks) > threads
    assert 0 < c["decode.blocks_thread_max"] <= math.ceil(
        c["decode.blocks"] / threads)


@pytest.fixture(scope="module")
def long_header(ds, tmp_path_factory):
    """ds's records behind 6,000 more references, whose header spans four
    BGZF blocks: (the BAM's path, its records' (vbeg, vend))."""
    with open(ds["bam"], "rb") as f:
        stream = gzip.decompress(f.read())
    h = BamHeader(ds["bam"])
    refs = list(zip(h.ref_names, h.ref_lens)) + [
        (f"pad{i}", 1000) for i in range(6000)]
    bam = str(tmp_path_factory.mktemp("long_header") / "reads.bam")
    write_bam(bam, refs, [stream[_header_end(stream):]], write_index=False)
    return bam, [(b, e) for b, e, *_ in pbai._bam_records(bam)[1]]


@pytest.mark.parametrize("loader", ["whole", "bounded", "regions", "bytes"])
def test_loaders_after_a_header_of_several_blocks(long_header, monkeypatch,
                                                  loader):
    """Records that begin partway through a block, after a header that
    spans several, decode alike in each loader and in the JAX package's."""
    bam, recs = long_header
    assert recs[0][0] >> 16 > 0 and recs[0][0] & 0xFFFF
    kwargs = {}
    if loader == "bounded":
        monkeypatch.setattr(pbn, "STREAM_DECODE_BYTES", 0)
        monkeypatch.setattr(pbn, "STREAM_SEGMENT_BYTES", 1 << 20)
    elif loader == "regions":
        kwargs["chunks"] = [(recs[0][0], recs[-1][1])]
    elif loader == "bytes":
        with open(bam, "rb") as f:
            kwargs["bam_bytes"] = gzip.decompress(f.read())
    got = pbn.ColumnarBam(bam, b"CB", 2, **kwargs)
    assert got.loader == loader and got.n == len(recs) > 0
    _assert_columns_equal(got, JaxColumnarBam(bam, b"CB"))
