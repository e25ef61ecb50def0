"""The port's CRAM input against the JAX package: the writer's bytes, the
native decoder's BAM stream (libcramio, built by the port from
native/cramio.cpp), the Python codec's records and its BAM transcode, on
every writer profile the JAX tests use; the .crai both ways and the
container plan; the decoder quirk both packages share; and the `.mtx` of
a CRAM run on the native host, byte for byte, with --fetch whole and auto,
on libcramio's route and on the transcoder's. Inputs are a seeded
synthetic dataset of a few hundred reads; the tolerance is exact
equality."""

import gzip
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.io import cram as jcram
from vartrix_tpu.io.bam import BamReader as JaxBamReader
from vartrix_tpu.io.bam_native import cram_decode_native as jax_cram_decode
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch import driver as port_driver
from vartrix_tpu_torch.io import bam_native as pbn
from vartrix_tpu_torch.io import cram as pcram
from vartrix_tpu_torch.io.bam import BamReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = {
    "external": {},
    "mixed": {"codec_profile": "mixed"},
    "exotic": {"codec_profile": "exotic"},
    "gzip": {"block_method": "gzip"},
    "rans0": {"block_method": "rans0"},
    "rans1": {"block_method": "rans1"},
    "bzip2": {"block_method": "bzip2"},
    "lzma": {"block_method": "lzma"},
    "ransnx16mix": {"block_method": "ransnx16mix"},
    "slices2": {"slices_per_container": 2, "records_per_container": 100},
}
MODES = {
    "consensus": ["-s", "consensus"],
    "coverage_umi": ["-s", "coverage", "--umi"],
    "alt_frac": ["-s", "alt_frac"],
}


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("cram")), SynthConfig(
        n_variants=12, n_cells=40, reads_per_variant=25, seed=21,
        spliced_frac=0.3, indel_frac=0.2))


def _write(mod, reader_cls, ds, path, **kw):
    b = reader_cls(ds["bam"])
    mod.write_cram(path, list(zip(b.ref_names, b.ref_lens)), b.records(),
                   fasta_path=ds["fasta"], **kw)
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _records(reader):
    return [(r.tid, r.pos, r.mapq, r.flag, r.cigar, r._buf)
            for r in reader.records()]


@pytest.mark.parametrize("profile", list(PROFILES))
def test_decoders_equal_to_jax(ds, tmp_path, profile):
    kw = PROFILES[profile]
    got = _write(pcram, BamReader, ds, str(tmp_path / "p.cram"), **kw)
    want = _write(jcram, JaxBamReader, ds, str(tmp_path / "j.cram"), **kw)
    assert _read(got) == _read(want)
    # libcramio's BAM stream, the Python codec's records, its transcode
    stream = pbn.cram_decode_native(got, ds["fasta"])
    assert np.array_equal(stream, jax_cram_decode(want, ds["fasta"]))
    assert _records(pcram.CramReader(got, ds["fasta"])) == _records(
        jcram.CramReader(want, ds["fasta"]))
    n = pcram.transcode_to_bam(got, str(tmp_path / "p.bam"), ds["fasta"])
    assert n == jcram.transcode_to_bam(want, str(tmp_path / "j.bam"),
                                       ds["fasta"]) == ds["n_reads"]
    assert _read(tmp_path / "p.bam") == _read(tmp_path / "j.bam")
    # the columns of the stream are the BAM's
    cols = pbn.ColumnarBam(got, bam_bytes=stream)
    whole = pbn.ColumnarBam(ds["bam"])
    assert cols.loader == "bytes" and cols.n == whole.n
    for attr in ("tid", "pos", "ref_end", "flag", "seq_pool", "cb_pool",
                 "ub_pool"):
        assert np.array_equal(getattr(cols, attr), getattr(whole, attr))


@pytest.fixture(scope="module")
def multi(ds, tmp_path_factory):
    """A CRAM of many containers with its .crai from each package."""
    d = tmp_path_factory.mktemp("multi")
    cram = _write(pcram, BamReader, ds, str(d / "reads.cram"),
                  records_per_container=40)
    (d / "jax").mkdir()
    jax_crai = str(d / "jax" / "reads.cram.crai")
    jcram.write_crai(cram, jax_crai, ds["fasta"])
    pcram.write_crai(cram, fasta_path=ds["fasta"])
    return cram, jax_crai


def test_crai_written_and_read_by_both(multi, ds):
    cram, jax_crai = multi
    got, want = _read(cram + ".crai"), _read(jax_crai)
    # equal bytes but for the gzip header's timestamp (bytes 4-8)
    assert got[:4] + got[8:] == want[:4] + want[8:]
    assert gzip.decompress(got) == gzip.decompress(want)
    assert pcram.read_crai(jax_crai) == jcram.read_crai(cram + ".crai")
    assert len(pcram.read_crai(jax_crai)) > 5


def test_containers_for_loci_equal_to_jax(multi, ds):
    cram, _ = multi
    loci = [(f"chr{c + 1}", p, p + len(r)) for c, p, r, _ in ds["variants"]]
    port, jax = pcram.CramReader(cram), jcram.CramReader(cram)
    for sub in (loci, loci[:3], loci[-1:], [], [("nochr", 0, 10)]):
        offs = port.containers_for_loci(sub)
        assert offs == jax.containers_for_loci(sub)
        assert pbn.cram_decode_native(cram, ds["fasta"], offs).tobytes() == \
            jax_cram_decode(cram, ds["fasta"], offs).tobytes()
    assert 0 < len(port.containers_for_loci(loci[:3])) < len(
        port.container_offsets())


def _quirk_stream(n_out):
    """A rANS Nx16 order-1 stream whose frequency table lacks the context
    every state starts in (byte 0): an alphabet of one symbol, 'A'."""
    out = bytes([pcram.NX16_ORDER1]) + pcram.write_uint7(n_out)
    out += bytes([12 << 4, ord("A"), 0]) + pcram.write_uint7(4096)
    return out + struct.pack("<4I", *[pcram.RANS_NX16_LOW] * 4)


def test_nx16_missing_context_quirk_shared_by_both_packages(
        ds, tmp_path, monkeypatch):
    """native/cramio.cpp:386 decodes a rANS Nx16 order-1 context that is
    absent from the frequency table through an all-zero lookup (every
    symbol 0), where the Python codec raises "missing context table". The
    port builds libcramio from the same source and copies the codec, so it
    shows both behaviours as the JAX package does: on a CRC-valid CRAM
    whose quality-score block holds such a stream, both Python readers
    raise, and both native decoders return the same BAM stream, with
    every quality 0 and everything else decoded. The driver's native host
    takes libcramio's stream (no decode error is reported), so the run
    writes the clean file's matrix; the quirk is pinned here, not fixed in
    one package only."""
    qs = pcram._SERIES_IDS["QS"]
    real_write_block = pcram.write_block
    hit = []

    def write_block(b, compress=True, method_hint="gzip"):
        if b.content_type == pcram.CT_EXTERNAL and b.content_id == qs:
            hit.append(b.content_id)
            body = _quirk_stream(len(b.data))
            out = bytes([pcram.METHOD_RANSNX16, b.content_type])
            out += pcram.write_itf8(b.content_id) + pcram.write_itf8(
                len(body)) + pcram.write_itf8(len(b.data)) + body
            return out + struct.pack("<I", pcram.zlib.crc32(out))
        return real_write_block(b, compress, method_hint)

    clean = _write(pcram, BamReader, ds, str(tmp_path / "clean.cram"),
                   block_method="ransnx16o1")
    monkeypatch.setattr(pcram, "write_block", write_block)
    cram = _write(pcram, BamReader, ds, str(tmp_path / "reads.cram"),
                  block_method="ransnx16o1")
    monkeypatch.undo()
    assert hit
    for mod in (pcram, jcram):
        with pytest.raises(ValueError, match="missing context table"):
            _records(mod.CramReader(cram, ds["fasta"]))
    stream = pbn.cram_decode_native(cram, ds["fasta"])
    assert np.array_equal(stream, jax_cram_decode(cram, ds["fasta"]))
    good = pbn.cram_decode_native(clean, ds["fasta"])
    assert len(stream) == len(good) and not np.array_equal(stream, good)
    cols, ref = (pbn.ColumnarBam(cram, bam_bytes=s) for s in (stream, good))
    for attr in ("pos", "flag", "seq_pool", "cb_pool", "ub_pool"):
        assert np.array_equal(getattr(cols, attr), getattr(ref, attr))
    assert not any(_quals(stream)) and any(_quals(good))
    # the native host's run takes the stream and writes the clean file's
    # matrix (--fetch whole: the Python codec cannot index this file, so
    # the clean file's .crai stands beside it, unread)
    pcram.write_crai(clean, fasta_path=ds["fasta"])
    with open(cram + ".crai", "wb") as f:
        f.write(_read(clean + ".crai"))
    outs = [_run(port_driver._main, dict(ds, bam=path),
                 tmp_path / (os.path.basename(path) + ".mtx"),
                 ["--fetch", "whole", "--device", "cpu", "--backend",
                  "torch"]) for path in (cram, clean)]
    assert outs[0] == outs[1]


def _quals(stream):
    """The quality bytes of every record of a raw BAM stream."""
    data = stream.tobytes()
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    out = bytearray()
    while off < len(data):
        bs, = struct.unpack_from("<i", data, off)
        l_name, n_cigar, l_seq = (data[off + 12],
                                  struct.unpack_from("<H", data, off + 16)[0],
                                  struct.unpack_from("<i", data, off + 20)[0])
        q = off + 36 + l_name + 4 * n_cigar + (l_seq + 1) // 2
        out += data[q : q + l_seq]
        off += 4 + bs
    return bytes(out)


@pytest.fixture(scope="module")
def cram_ds(ds, tmp_path_factory):
    d = tmp_path_factory.mktemp("cram_ds")
    cram = _write(pcram, BamReader, ds, str(d / "reads.cram"),
                  records_per_container=60)
    pcram.write_crai(cram, fasta_path=ds["fasta"])
    return dict(ds, bam=cram)


def _run(main, info, out, extra, metrics=None):
    argv = ["-v", info["vcf"], "-b", info["bam"], "-f", info["fasta"],
            "-c", info["barcodes"], "-o", str(out),
            "--ref-matrix", str(out) + ".ref", *extra]
    if metrics:
        argv += ["--metrics-json", str(metrics)]
    main(argv)
    return _read(out), (_read(str(out) + ".ref") if "coverage" in extra
                        else None)


@pytest.mark.parametrize("fetch", ["whole", "auto"])
@pytest.mark.parametrize("mode", list(MODES))
def test_cram_run_byte_equal_to_jax(cram_ds, tmp_path, mode, fetch):
    args = MODES[mode] + ["--fetch", fetch]
    mj = tmp_path / "m.json"
    got = _run(port_driver._main, cram_ds, tmp_path / "p.mtx",
               args + ["--device", "cpu", "--backend", "torch"], mj)
    want = _run(jax_main, cram_ds, tmp_path / "j.mtx",
                args + ["--host", "native", "--backend", "cpu"])
    assert got == want
    with open(mj) as f:
        payload = json.load(f)
    assert payload["cram_decode"] == "native"
    assert "cram-decode" in payload["phase_seconds"]


def test_banded_cram_run_byte_equal_to_jax(cram_ds, tmp_path):
    args = ["--sw-mode", "banded"]
    got = _run(port_driver._main, cram_ds, tmp_path / "p.mtx",
               args + ["--device", "cpu", "--backend", "torch"])
    want = _run(jax_main, cram_ds, tmp_path / "j.mtx",
                args + ["--host", "native", "--backend", "cpu"])
    assert got == want


def test_transcoder_route_on_libcramio_decode_error(cram_ds, tmp_path,
                                                    monkeypatch, caplog):
    """libcramio's own decode error sends the run through the Python
    transcoder, logged and named in --metrics-json; the .mtx is the same."""
    def refuse(*args, **kwargs):
        raise pbn.CramDecodeError("native CRAM decode: unsupported feature")

    monkeypatch.setattr(port_driver, "cram_decode_native", refuse)
    mj = tmp_path / "m.json"
    got = _run(port_driver._main, cram_ds, tmp_path / "p.mtx",
               ["--device", "cpu", "--backend", "torch", "--log-level",
                "info"], mj)
    want = _run(jax_main, cram_ds, tmp_path / "j.mtx",
                ["--host", "native", "--backend", "cpu"])
    assert got == want
    with open(mj) as f:
        assert json.load(f)["cram_decode"] == "transcode"
    assert "transcoding with the Python CRAM codec" in caplog.text


def test_libcramio_build_failure_raises(cram_ds, tmp_path, monkeypatch):
    """A failure to build or load libcramio is not a decode error: the run
    raises and takes no other route."""
    def broken():
        raise RuntimeError("building cramio.cpp failed")

    monkeypatch.setattr(pbn, "_cram_lib", None)
    monkeypatch.setattr(pbn, "cramio_library", broken)
    with pytest.raises(RuntimeError, match="building cramio.cpp failed"):
        _run(port_driver._main, cram_ds, tmp_path / "p.mtx",
             ["--device", "cpu", "--backend", "torch"])
    assert not (tmp_path / "p.mtx").exists()


def test_stream_on_cram_runs_monolithic(cram_ds, tmp_path, caplog):
    got = _run(port_driver._main, cram_ds, tmp_path / "p.mtx",
               ["--stream", "4", "--device", "cpu", "--backend", "torch",
                "--log-level", "info"])
    want = _run(jax_main, cram_ds, tmp_path / "j.mtx",
                ["--stream", "4", "--host", "native", "--backend", "cpu"])
    assert got == want
    assert "running monolithic" in caplog.text


def test_index_cli_writes_crai(cram_ds, tmp_path):
    cram = str(tmp_path / "reads.cram")
    os.link(cram_ds["bam"], cram)
    r = subprocess.run([sys.executable, "-m", "vartrix_tpu_torch.io.bai",
                        cram, "-f", cram_ds["fasta"]], cwd=ROOT,
                       capture_output=True, text=True, check=True)
    assert r.stdout.strip() == f"{cram} -> {cram}.crai"
    got, want = _read(cram + ".crai"), _read(cram_ds["bam"] + ".crai")
    assert got[:4] + got[8:] == want[:4] + want[8:]
