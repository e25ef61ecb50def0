"""Top-level driver: argv -> matrices on disk.

The run of the reference `_main` (reference src/main.rs:163-418):
validate the inputs, build the haplotypes, decode the reads, filter and
join them to variants, score every (read, haplotype) pair on the device,
aggregate the calls and write the matrices. Callable in-process
(`_main(argv)`) for tests.

Two host runtimes (--host). The native one (the default) decodes a BAM
into columns (the whole file, or the chunks of one merged BAI/CSI region
plan: --fetch), or a CRAM into an in-memory BAM stream with libcramio (its
.crai's containers for the variants, unless --fetch whole), and scores
each read's (ref, alt) pair into one call code. --stream N windows decode,
collect and score over groups of N variants of a BAM; --checkpoint-dir
keeps each variant's codes for a rerun; --profile-dir writes a
torch.profiler trace of the scoring phase. The Python one decodes record
by record (io/bam.BamReader, io/bai.RegionStream under a region plan,
io/cram.CramReader under a .crai container plan), scores plain (read,
haplotype) rows and forms the calls per variant (core/calls.py), logging
every read's alignment at --log-level debug (which --host auto takes for
that log); --stream, --checkpoint-dir, --profile-dir and --device-agg do
not apply to it.

--device-agg forms the native host's calls and (variant, cell) counts on
--device (core/agg_device_driver.py); --mesh-devices N splits full-mode
scoring over local devices (ops/sw_cuda.MeshSwBackend); --distributed
runs one row shard per process on torch.distributed and gathers the
matrices to rank 0 (parallel/multihost.py).

Scoring runs on --device (default cuda) with --backend cuda (the
hand-written kernel, default) or torch (the plain PyTorch version), in
--sw-mode full (csrc/sw_pair.cu) or banded (band bounds built on the
device by csrc/band_build.cu, then csrc/sw_banded.cu). A run that asks for a CUDA device where there is none
stops; it never continues on the CPU unless --device cpu is given.
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from .cli import build_parser
from .core import agg_numpy
from .core import calls as calls_mod
from .core.agg_device_driver import aggregate_on_device
from .core.fast_pipeline import collect_reads_fast, score_all_fast
from .core.pipeline import (PipelineArgs, collect_reads, prepare_variants,
                            score_all)
from .io.bai import RegionStream, plan_region_fetch
from .io.bam import BamHeader, BamReader
from .io.bam_native import ColumnarBam, CramDecodeError, cram_decode_native
from .io.cram import CramReader, transcode_to_bam
from .io.barcodes import load_barcodes, write_barcodes
from .io.fasta import FastaIndex, IndexedFasta
from .io.matrix_market import TriMat, write_matrix_market
from .io.vcf import iter_vcf_records, read_vcf_records
from .ops import sw_cuda
from .parallel.mesh import make_mesh
from .parallel.multihost import (gather_metrics, gather_triplets,
                                 process_group, shard_range)
from .utils import trace
from .utils.metrics import Metrics, log_metrics

log = logging.getLogger("vartrix")

# --fetch auto plans an indexed region decode only for BAMs of at least this
# many bytes (planning a large VCF costs more than whole-file decode of a
# small BAM can save), and takes it when the plan covers under
# AUTO_REGION_FRACTION of the file
AUTO_REGION_BYTES = 64 * 1024 * 1024
AUTO_REGION_FRACTION = 0.5


def validate_output_path(p: str) -> None:
    if os.path.exists(p):
        log.error("Output path already exists")
        sys.exit(1)
    parent = os.path.dirname(p)
    if parent and not os.path.isdir(parent):
        log.error("Output directory %r does not exist", parent)
        sys.exit(1)


def check_inputs_exist(fasta_file, vcf_file, bam_file, cell_barcodes,
                       out_matrix_path, out_ref_matrix_path) -> None:
    for path in (fasta_file, vcf_file, bam_file, cell_barcodes):
        if not os.path.exists(path):
            log.error("Input file %s does not exist", path)
            sys.exit(1)
    for p in (out_matrix_path, out_ref_matrix_path):
        validate_output_path(p)
    fai = fasta_file + ".fai"
    if not os.path.exists(fai):
        log.error("File %s does not exist", fai)
        sys.exit(1)
    ext = os.path.splitext(bam_file)[1].lstrip(".")
    if ext == "bam":
        if not (os.path.exists(bam_file + ".bai") or os.path.exists(bam_file + ".csi")):
            log.error("BAM index does not exist. Expecting %s or %s",
                      bam_file + ".bai", bam_file + ".csi")
            sys.exit(1)
    elif ext == "cram":
        if not os.path.exists(bam_file + ".crai"):
            log.error("CRAM index %s does not exist", bam_file + ".crai")
            sys.exit(1)
    else:
        log.error("BAM file did not end in .bam or .cram. Unable to validate")
        sys.exit(1)


def validate_inputs(records, bam: BamHeader, fasta_index: FastaIndex) -> None:
    """Cross-check VCF chroms against FASTA and BAM; check variant end fits
    the chromosome (reference src/main.rs:545-594)."""
    fa_seqs = {e.name for e in fasta_index.sequences()}
    bam_seqs = set(bam.ref_names)
    for rec in records:
        if rec.chrom not in fa_seqs:
            log.error("Sequence %s not seen in FASTA", rec.chrom)
            sys.exit(1)
        if rec.chrom not in bam_seqs:
            log.error("Sequence %s not seen in BAM", rec.chrom)
            sys.exit(1)
        chrom_len = fasta_index.chrom_len(rec.chrom)
        end = rec.pos + len(rec.ref)
        if end > chrom_len:
            log.error(
                "Record %s:%d has end position %d, which is larger than the "
                "chromosome length (%d). Does your FASTA match your VCF?",
                rec.chrom, rec.pos, end, chrom_len)
            sys.exit(1)


def _is_cram(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"CRAM"


def open_reads(path: str, fasta_path: str):
    """The input's reader, told apart by content as htslib does: a
    CramReader for a CRAM (its records decode on demand), else the BAM's
    header (BamHeader): the fetch strategy chosen later decodes a BAM's
    records."""
    if _is_cram(path):
        return CramReader(path, fasta_path)
    return BamHeader(path)


class _CramRegions:
    """A CramReader's records restricted to a .crai container plan."""

    def __init__(self, cram: CramReader, offsets):
        self.tid_by_name = cram.tid_by_name
        self._cram = cram
        self._offsets = offsets

    def records(self):
        return self._cram.records_for_containers(self._offsets)


def write_variants(out_variants: str, vcf_file: str) -> None:
    with open(out_variants, "wt") as f:
        for rec in iter_vcf_records(vcf_file):
            f.write(f"{rec.chrom}_{rec.pos}\n")


@contextmanager
def _phase(name: str, profile_dir: Optional[str] = None,
           device: str = "cpu"):
    """A pipeline stage as the recorder's phase span "vartrix::<name>"
    (utils/trace.phase), logged at info level. With profile_dir, a
    torch.profiler trace of the stage (CPU activity, and the card's with
    --device cuda; every thread's spans where this PyTorch can record
    them) is written to profile_dir/<name>.pt.trace.json; the phase's span
    opens once the profiler runs, is the trace's window and holds the
    final device synchronisation. A trace that was asked for and cannot be
    written raises."""
    sp = None
    try:
        if not profile_dir:
            with trace.phase(name) as sp:
                yield
            return
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts,
                     experimental_config=_all_threads()) as prof:
            with trace.profiling(), trace.phase(name) as sp:
                yield
                if device == "cuda":
                    torch.cuda.synchronize()
        path = os.path.join(profile_dir, f"{name}.pt.trace.json")
        prof.export_chrome_trace(path)
        log.info("Profiler trace of %s: %s", name, path)
    finally:
        if sp is not None and sp.seconds is not None:
            log.info("Phase %-12s %.2fs", name, sp.seconds)


def _all_threads():
    """The profiler's option that records the spans of every thread, or
    None where this PyTorch lacks it (then only the calling thread's)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _loci(works) -> list:
    return [(w.locus.chrom, w.locus.start, w.locus.end) for w in works]


def plan_fetch(args, works, tid_by_name) -> Optional[list]:
    """The merged chunk plan to decode, or None for the whole file.

    --fetch whole and small BAMs under auto decode the whole file; auto
    takes the region plan when it covers under AUTO_REGION_FRACTION of the
    file, and keeps the whole file on an empty plan with live variants
    (indistinguishable from a stub or foreign index). --fetch regions
    takes any plan and exits 1 when no index is usable. (A CRAM's plan is
    cram_containers'.)"""
    if args.fetch == "whole" or (
            args.fetch == "auto"
            and os.path.getsize(args.bam) < AUTO_REGION_BYTES):
        return None
    loci = _loci(w for w in works if not w.skipped)
    with trace.span("vartrix::plan"):
        plan, frac = plan_region_fetch(args.bam, loci, tid_by_name)
    if plan is not None and not plan and (args.fetch == "auto" or not loci):
        plan = None
    if plan is not None and (args.fetch == "regions"
                             or frac < AUTO_REGION_FRACTION):
        log.info("Fetch plan: %d merged chunks covering ~%.1f%% of the "
                 "BAM (indexed region decode)", len(plan), 100 * frac)
        return plan
    if args.fetch == "regions":
        log.error("--fetch regions requested but no usable BAM index")
        sys.exit(1)
    return None


def cram_containers(args, bam: CramReader, works) -> Optional[list]:
    """The offsets of the CRAM containers whose .crai entries overlap a
    live variant, or None for every container (--fetch whole, or no valid
    .crai)."""
    if args.fetch == "whole":
        return None
    with trace.span("vartrix::plan"):
        offs = bam.containers_for_loci(_loci(w for w in works
                                             if not w.skipped))
    if offs is not None:
        log.info("CRAM fetch plan: %d of %d containers", len(offs),
                 len(bam.container_offsets()))
    return offs


def decode_cram(args, pargs, bam: CramReader, works):
    """(ColumnarBam, route) of a CRAM on the native host: libcramio decodes
    the planned containers into an in-memory BAM stream (route "native").
    Where libcramio reports that it cannot decode the file, the Python
    codec transcodes the same containers to a BAM (route "transcode"); a
    failure to build or load libcramio raises."""
    offs = cram_containers(args, bam, works)
    threads = max(args.threads, 1)
    try:
        with _phase("cram-decode"):
            stream = cram_decode_native(args.bam, args.fasta, offs, threads)
    except CramDecodeError as exc:
        log.info("%s; transcoding with the Python CRAM codec", exc)
        loci = None if offs is None else _loci(
            w for w in works if not w.skipped)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "transcoded.bam")
            with _phase("cram-decode"):
                transcode_to_bam(args.bam, path, args.fasta, loci=loci)
            with _phase("decode"):
                return (_decoded(ColumnarBam(path, pargs.bam_tag.encode(),
                                             threads), offs), "transcode")
    with _phase("decode"):
        return _decoded(ColumnarBam(args.bam, pargs.bam_tag.encode(),
                                    threads, bam_bytes=stream), offs), "native"


def _decoded(cbam: ColumnarBam, chunks) -> ColumnarBam:
    """Counts a decode: its records, and the merged chunks (or CRAM
    containers) it read, a whole file counting as one."""
    trace.count("decode.records", cbam.n)
    trace.count("decode.chunks", 1 if chunks is None else len(chunks))
    return cbam


def _decode_early(path: str, tag: bytes, threads: int) -> ColumnarBam:
    """The whole-file decode on the early decode's worker thread."""
    with trace.span("vartrix::decode.early"):
        return ColumnarBam(path, tag, threads)


def _stream_score(args, pargs, works, cell_barcodes, backend, tid_by_name):
    """Windowed decode->collect->score (--stream N): the live variants in
    contiguous windows of N, each window's reads region-decoded through
    its own index plan, collected, scored and freed, so peak memory holds
    one window; window k+1 decodes on a producer thread while window k
    scores on the device.

    Outputs are identical to the monolithic path: a variant lives in
    exactly one window, its window's plan covers every read overlapping
    its locus (the plan of --fetch regions), and collect selects each
    variant's candidates by (tid, pos) range, so extra reads a window's
    chunks include never reach another variant. UMI ids stay consistent
    within a variant because all its reads decode in its own window.

    Returns (read_idx, cells_l, umis_l, per-variant codes, records
    decoded) aligned to `works`, or None when no index is usable (the
    caller runs monolithic)."""
    V = len(works)
    live = [i for i, w in enumerate(works) if not w.skipped]
    windows = [live[k : k + args.stream]
               for k in range(0, len(live), args.stream)]
    read_idx = [np.zeros(0, np.int64)] * V
    cells_l = [np.zeros(0, np.int32)] * V
    umis_l = [np.zeros(0, np.int64)] * V
    codes = [np.zeros(0, np.int8)] * V
    if not windows:
        return read_idx, cells_l, umis_l, codes, 0

    def plan_of(win):
        with trace.span("vartrix::plan"):
            return plan_region_fetch(args.bam, _loci(works[i] for i in win),
                                     tid_by_name)[0]

    def decode(win, plan=None):
        plan = plan_of(win) if plan is None else plan
        if plan is None:
            raise RuntimeError("BAM index became unusable mid-stream")
        with trace.span("vartrix::decode"):
            return _decoded(ColumnarBam(args.bam, pargs.bam_tag.encode(),
                                        max(args.threads, 1), chunks=plan),
                            plan)

    first = plan_of(windows[0])
    if first is None:
        return None
    n_records = 0
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(trace.carry(decode), windows[0], first)
        for t, win in enumerate(windows):
            with trace.span("vartrix::stream.window"):
                cbam = fut.result()
                if t + 1 < len(windows):
                    fut = ex.submit(trace.carry(decode), windows[t + 1])
                n_records += cbam.n
                sub = [works[i] for i in win]
                with trace.span("vartrix::collect"):
                    ri, cl, ul = collect_reads_fast(cbam, sub, cell_barcodes,
                                                    pargs)
                _scored(ri)
                sc = score_all_fast(cbam, sub, ri, backend)
                for k, i in enumerate(win):
                    read_idx[i], cells_l[i], umis_l[i] = ri[k], cl[k], ul[k]
                    codes[i] = sc[k]
                del cbam
    log.info("Streamed %d variants over %d windows of <=%d",
             len(live), len(windows), args.stream)
    return read_idx, cells_l, umis_l, codes, n_records


def _scored(read_idx) -> None:
    """Counts the reads collect hands to scoring."""
    trace.count("collect.reads_scored", sum(len(r) for r in read_idx))


def _score_checkpointed(args, cbam, works, read_idx, backend):
    """score_all_fast over the variants the checkpoint directory does not
    hold yet; loads the rest (rows whose saved shape matches) and saves
    what it scores. The key covers the inputs and the filter flags."""
    from .core.checkpoint import ScoreCheckpoint, manifest_key

    key = manifest_key(
        [args.vcf, args.bam, args.fasta, args.cell_barcodes],
        {"padding": args.padding, "mapq": args.mapq,
         "primary": args.primary_alignments,
         "duplicates": args.no_duplicates, "umi": args.umi,
         "bam_tag": args.bam_tag, "valid_chars": args.valid_chars})
    ckpt = ScoreCheckpoint(args.checkpoint_dir, key)
    cached, todo = {}, []
    for wi, w in enumerate(works):
        arr = ckpt.load(w.row)
        want = len(read_idx[wi])
        # (n, 2) int32 scores or (n,) int8 fused call codes
        if arr is not None and arr.shape in ((want, 2), (want,)):
            cached[wi] = arr if arr.ndim == 1 else arr.astype(np.int32)
        else:
            todo.append(wi)
    sub = score_all_fast(cbam, [works[i] for i in todo],
                         [read_idx[i] for i in todo], backend)
    for wi, arr in zip(todo, sub):
        ckpt.save(works[wi].row, arr)
        cached[wi] = arr
    log.info("Checkpoint: %d variants loaded, %d scored",
             len(works) - len(todo), len(todo))
    return [cached[wi] for wi in range(len(works))]


def check_device(device: str, backend: str) -> None:
    """Exits on a --device/--backend combination that cannot run here."""
    if device == "cuda" and not torch.cuda.is_available():
        log.error("--device cuda: no CUDA device is available. The plain "
                  "version runs on the CPU only when asked: --device cpu "
                  "--backend torch")
        sys.exit(1)
    if backend == "cuda" and device != "cuda":
        log.error("--backend cuda is the CUDA kernel and needs --device "
                  "cuda; use --backend torch for --device %s", device)
        sys.exit(1)


def select_backend(device: str, backend: str, sw_mode: str,
                   mesh_devices: int = 0):
    """The scoring backend for --device/--backend/--sw-mode/--mesh-devices
    (check_device first). Neither mode scores on host threads: --threads
    serves the decode only. --mesh-devices splits full-mode scoring over
    parallel/mesh.make_mesh's devices, each with --backend's scorer; in
    banded mode it is logged and the banded scorer runs unsharded on
    --device."""
    kernel = backend == "cuda"
    if sw_mode == "banded":
        if mesh_devices:
            log.error("--mesh-devices is a full-SW device path; --sw-mode "
                      "banded runs unsharded on --device %s", device)
        return sw_cuda.BandedSwBackend(device, kernel=kernel)
    if mesh_devices:
        devices = make_mesh(mesh_devices, device)
        log.info("Mesh scoring across %d local devices", len(devices))
        return sw_cuda.MeshSwBackend(devices, kernel=kernel)
    return sw_cuda.SwBackend(device, kernel=kernel)


def _native_host(args, pargs, bam, works, cell_barcodes, backend, early,
                 matrix: TriMat, ref_matrix: TriMat):
    """Decode, collect, score and aggregate on the native host runtime;
    adds the matrix triplets and returns (metrics, CRAM decode route or
    None)."""
    is_cram = isinstance(bam, CramReader)
    cram_route = None
    streamed = None
    if args.stream > 0:
        if is_cram:
            log.info("--stream: a CRAM decodes the containers of its .crai "
                     "plan instead; running monolithic")
        elif args.checkpoint_dir:
            log.info("--stream is incompatible with --checkpoint-dir; "
                     "running monolithic")
        else:
            # one phase spans the windows' decode, collect and score: they
            # overlap by design, so separate timers would double-count
            with _phase("stream", args.profile_dir, args.device):
                streamed = _stream_score(args, pargs, works, cell_barcodes,
                                         backend, bam.tid_by_name)
            if streamed is None:
                log.info("--stream requested but no usable BAM index; "
                         "running monolithic")
    if streamed is not None:
        read_idx, cells_l, umis_l, per_variant_codes, n_records = streamed
        log.info("Decoded %d records (strategy: stream windows)", n_records)
    else:
        if is_cram:
            cbam, cram_route = decode_cram(args, pargs, bam, works)
            strategy = f"cram, {cram_route} decode"
        else:
            chunks = None if early is not None else plan_fetch(
                args, works, bam.tid_by_name)
            with _phase("decode"):
                # the early decode's timer measures only the remaining wait
                cbam = _decoded(
                    early.result() if early is not None else
                    ColumnarBam(args.bam, pargs.bam_tag.encode(),
                                max(args.threads, 1), chunks=chunks), chunks)
            strategy = cbam.loader
        log.info("Decoded %d records (strategy: %s)", cbam.n, strategy)
        with _phase("collect"):
            read_idx, cells_l, umis_l = collect_reads_fast(
                cbam, works, cell_barcodes, pargs)
        _scored(read_idx)
        with _phase("score", args.profile_dir, args.device):
            if args.checkpoint_dir:
                per_variant_codes = _score_checkpointed(
                    args, cbam, works, read_idx, backend)
            else:
                per_variant_codes = score_all_fast(cbam, works, read_idx,
                                                   backend)
        del cbam
    log.debug("Finished aligning reads for all variants")

    metrics = Metrics()
    for w in works:
        if w._metrics is not None:  # lazy: untouched rows carry none
            metrics.add(w._metrics)
    with _phase("aggregate"):
        if args.device_agg:
            g_rows, g_cols, ref_c, alt_c, unk_c = aggregate_on_device(
                cells_l, umis_l, per_variant_codes, pargs.use_umi,
                args.device)
        else:
            g_rows, g_cols, ref_c, alt_c, unk_c = agg_numpy.aggregate_flat(
                cells_l, umis_l, per_variant_codes, pargs.use_umi)
    tot = (ref_c + alt_c + unk_c).astype(np.float64)
    if args.scoring_method == "consensus":
        vals = np.where((ref_c > 0) & (alt_c > 0), 3.0,
                        np.where(alt_c > 0, 2.0,
                                 np.where(ref_c > 0, 1.0, 0.0)))
        keep = vals > 0
        matrix.add_triplets(g_rows[keep], g_cols[keep], vals[keep])
    elif args.scoring_method == "alt_frac":
        with np.errstate(invalid="ignore", divide="ignore"):
            vals = alt_c / tot  # 0/0 -> NaN preserved
        matrix.add_triplets(g_rows, g_cols, vals)
    elif args.scoring_method == "coverage":
        matrix.add_triplets(g_rows, g_cols, alt_c)
        ref_matrix.add_triplets(g_rows, g_cols, ref_c)
    else:
        raise ValueError("Scoring method is invalid")
    if log.isEnabledFor(logging.INFO):
        for r, c in zip(g_rows[unk_c > 1], g_cols[unk_c > 1]):
            log.info("Variant at index %d has multiple unknown reads "
                     "at barcode index %d. Check this locus manually",
                     int(r), int(c))
    return metrics, cram_route


def _python_host(args, pargs, bam, works, cell_barcodes, backend,
                 matrix: TriMat, ref_matrix: TriMat) -> Metrics:
    """Collect, score and call on the Python record path; adds the matrix
    triplets and returns the metrics. Records come from the CRAM's reader
    (its .crai container plan unless --fetch whole), a RegionStream under
    a BAM's region plan, or a whole-file BamReader; every (read,
    haplotype) pair is scored as plain rows by the backend (core/pipeline.
    score_all)."""
    if isinstance(bam, CramReader):
        offs = cram_containers(args, bam, works)
        reads_src = bam if offs is None else _CramRegions(bam, offs)
    else:
        chunks = plan_fetch(args, works, bam.tid_by_name)
        reads_src = (BamReader(args.bam) if chunks is None
                     else RegionStream(args.bam, chunks))
    try:
        with _phase("collect"):
            collect_reads(reads_src, works, cell_barcodes, pargs)
    finally:
        if isinstance(reads_src, RegionStream):
            reads_src.close()
    with _phase("score"):
        per_variant_scores = score_all(works, backend)
    if log.isEnabledFor(logging.DEBUG):
        from .ops.sw_numpy import pretty_alignment
        for w, sc in zip(works, per_variant_scores):
            locus_str = f"{w.locus.chrom}:{w.locus.start}"
            log.debug("Evaluating record %s", locus_str)
            for k, (seq, qn) in enumerate(zip(w.read_seqs, w.qnames)):
                log.debug("%s %s ref_aln:\n%s", locus_str, qn.decode(),
                          pretty_alignment(seq, w.rref))
                log.debug("%s %s alt_aln:\n%s", locus_str, qn.decode(),
                          pretty_alignment(seq, w.alt_hap))
                log.debug("%s %s ref_score: %d alt_score: %d", locus_str,
                          qn.decode(), int(sc[k, 0]), int(sc[k, 1]))
    log.debug("Finished aligning reads for all variants")

    metrics = Metrics()
    alt_t: tuple = ([], [], [])  # (rows, cols, values) in call order
    ref_t: tuple = ([], [], [])

    def put(t, i, res):
        for j, r in res:
            t[0].append(i)
            t[1].append(j)
            t[2].append(r)

    with _phase("aggregate"):
        for w, sc in zip(works, per_variant_scores):
            if w._metrics is not None:
                metrics.add(w._metrics)
            # stable sort by cell_index (reference src/main.rs:932)
            order = sorted(range(len(w.cell_indices)),
                           key=lambda k: w.cell_indices[k])
            scores = [
                calls_mod.Scores(cell_index=w.cell_indices[k], umi=w.umis[k],
                                 ref_score=int(sc[k, 0]),
                                 alt_score=int(sc[k, 1]))
                for k in order
            ]
            i = w.row
            if args.scoring_method == "alt_frac":
                put(alt_t, i, calls_mod.alt_frac(scores, i, pargs.use_umi))
            elif args.scoring_method == "consensus":
                put(alt_t, i, calls_mod.consensus_scoring(scores, i,
                                                          pargs.use_umi))
            elif args.scoring_method == "coverage":
                alt_res, ref_res = calls_mod.coverage(scores, i,
                                                      pargs.use_umi)
                put(alt_t, i, alt_res)
                put(ref_t, i, ref_res)
            else:
                raise ValueError("Scoring method is invalid")
        matrix.add_triplets(*alt_t)
        ref_matrix.add_triplets(*ref_t)
    return metrics


def _main(argv: List[str]) -> None:
    """Full run. argv excludes the program name (pass sys.argv[1:])."""
    args = build_parser().parse_args(argv)

    level = {"info": logging.INFO, "debug": logging.DEBUG, "error": logging.ERROR}[args.log_level]
    logging.basicConfig(level=level, stream=sys.stderr,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    log.setLevel(level)
    # fresh per run (tests call _main in-process); the phase lines of info
    # logging need the recorder's times too
    trace.reset(record=bool(args.metrics_json)
                or log.isEnabledFor(logging.INFO))

    with trace.span("vartrix::job"):
        check_inputs_exist(args.fasta, args.vcf, args.bam,
                           args.cell_barcodes, args.out_matrix,
                           args.ref_matrix)
        check_device(args.device, args.backend)
        with process_group(args.distributed) as (dist_rank, dist_count):
            if args.distributed:
                args.num_shards, args.shard_index = dist_count, dist_rank
                log.info("Distributed: process %d/%d", dist_rank, dist_count)
                if args.device == "cuda":
                    torch.cuda.set_device(dist_rank
                                          % torch.cuda.device_count())
            payload = _run(args, dist_rank, dist_count)
    if payload is not None:
        import json
        payload["spans"] = trace.spans()
        payload["counters"] = trace.counters()
        with open(args.metrics_json, "wt") as f:
            json.dump(payload, f, indent=1)
        log.debug("Wrote metrics JSON")


def kernel_launches(counters: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches from the recorder's launch.<kernel>.<mode>
    counters, both modes together."""
    return {k: sum(n for name, n in counters.items()
                   if name.startswith(f"launch.{k}."))
            + counters.get(f"launch.{k}", 0)
            for k in ("sw_pair", "sw_banded", "band_build", "band_index")}


def _run(args, dist_rank: int, dist_count: int) -> Optional[dict]:
    """The run after argument checks: this process's rows (all of them, or
    its shard), gathered to rank 0 when the run is distributed, which
    alone writes the outputs. Returns the --metrics-json payload less its
    spans and counters (written once the job's span closes), or None."""
    backend = select_backend(args.device, args.backend, args.sw_mode,
                             args.mesh_devices)

    cell_barcodes = load_barcodes(args.cell_barcodes)
    records = read_vcf_records(args.vcf)
    num_vars = len(records)
    if num_vars == 0:
        log.error("Warning! Zero variants found in input VCF. Output matrices "
                  "will be by definition empty but will still be generated.")
    log.info("Initialized a %d variants x %d cell barcodes matrix", num_vars,
             len(cell_barcodes))

    matrix = TriMat((num_vars, len(cell_barcodes)))
    ref_matrix = TriMat((num_vars, len(cell_barcodes)))

    with _phase("validate"):
        bam = open_reads(args.bam, args.fasta)
        fasta = IndexedFasta(args.fasta)
        validate_inputs(records, bam, fasta.index)

    pargs = PipelineArgs(
        primary=args.primary_alignments,
        mapq=args.mapq,
        duplicates=args.no_duplicates,
        use_umi=args.umi,
        bam_tag=args.bam_tag,
        valid_chars=args.valid_chars.encode(),
        padding=args.padding,
    )

    row_range = None
    if args.num_shards > 1:
        row_range = shard_range(num_vars, args.num_shards, args.shard_index)
        log.info("Shard %d/%d computes variant rows [%d, %d)",
                 args.shard_index, args.num_shards, *row_range)

    # the whole-file decode reads only the BAM and the haplotypes only the
    # FASTA and VCF, so once whole-file is settled (--fetch whole, or auto
    # below AUTO_REGION_BYTES; no --stream) the decode runs on a worker
    # thread meanwhile. A region plan needs the haplotypes' windows first,
    # and a CRAM's decode its container plan.
    # debug logging reports each read's alignment, which only the Python
    # host carries: --host auto takes it there, as the JAX package does
    python_host = args.host == "python" or (args.host == "auto"
                                            and args.log_level == "debug")
    native_bam = not (python_host or isinstance(bam, CramReader))
    early = None
    if native_bam and args.stream == 0 and (
            args.fetch == "whole"
            or (args.fetch == "auto"
                and os.path.getsize(args.bam) < AUTO_REGION_BYTES)):
        ex = ThreadPoolExecutor(max_workers=1)
        early = ex.submit(trace.carry(_decode_early), args.bam,
                          pargs.bam_tag.encode(), max(args.threads, 1))
        ex.shutdown(wait=False)
    with _phase("haplotypes"):
        works = prepare_variants(records, fasta, pargs, row_range=row_range)

    cram_route = None
    if python_host:
        for flag, on in (("--stream", args.stream > 0),
                         ("--checkpoint-dir", args.checkpoint_dir),
                         ("--profile-dir", args.profile_dir),
                         ("--device-agg", args.device_agg)):
            if on:
                log.info("%s applies to the native host; the Python host "
                         "runs without it", flag)
        metrics = _python_host(args, pargs, bam, works, cell_barcodes,
                               backend, matrix, ref_matrix)
    else:
        metrics, cram_route = _native_host(args, pargs, bam, works,
                                           cell_barcodes, backend, early,
                                           matrix, ref_matrix)
    launches = kernel_launches(trace.counters())
    log.debug("Finished scoring alignments for all variants")

    if dist_count > 1:
        matrix = gather_triplets(matrix, dist_rank, dist_count)
        if args.scoring_method == "coverage":
            ref_matrix = gather_triplets(ref_matrix, dist_rank, dist_count)
        metrics = gather_metrics(metrics, dist_count)
        if dist_rank != 0:
            log_metrics(log, metrics)
            return None

    log_metrics(log, metrics)

    with _phase("write"):
        write_matrix_market(args.out_matrix, matrix)
        if args.scoring_method == "coverage":
            write_matrix_market(args.ref_matrix, ref_matrix)
    log.debug("Wrote matrix files")

    if args.out_variants is not None:
        validate_output_path(args.out_variants)
        write_variants(args.out_variants, args.vcf)
        log.debug("Wrote variants file")

    if args.out_barcodes is not None:
        validate_output_path(args.out_barcodes)
        write_barcodes(args.out_barcodes, cell_barcodes)

    matrix_sum = float(matrix.data.sum()) if matrix.nnz() else 0.0
    if matrix_sum == 0.0:
        log.error("The resulting matrix has a sum of 0. Did you use the --umi "
                  "flag on data without UMIs?")

    if not args.metrics_json:
        return None
    payload = {
        "metrics": metrics.as_dict(),
        "phase_seconds": {k: round(v, 4)
                          for k, v in trace.phase_seconds().items()},
        "matrix": {"shape": list(matrix.shape), "nnz": matrix.nnz()},
        "kernel_launches": launches,
        "config": {
            "scoring_method": args.scoring_method, "umi": args.umi,
            "device": args.device, "backend": args.backend,
            "host": "python" if python_host else "native",
            "sw_mode": args.sw_mode,
            "fetch": args.fetch, "threads": args.threads,
            "padding": args.padding,
        },
    }
    if args.scoring_method == "coverage":
        payload["ref_matrix_nnz"] = ref_matrix.nnz()
    if cram_route is not None:
        payload["cram_decode"] = cram_route
    return payload


def main() -> None:
    """CLI entry with the reference's friendly error shell
    (reference src/main.rs:137-160): print the error chain and a bug-report
    hint, exit 1."""
    import traceback

    from . import __version__

    try:
        _main(sys.argv[1:])
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — mirror the catch-all shell
        print(f"Vartrix error. v{__version__}.")
        print(f"Error: {e}")
        cause = e.__cause__ or e.__context__
        while cause is not None:
            print(f"Info: caused by {cause}")
            cause = cause.__cause__ or cause.__context__
        print()
        traceback.print_exc()
        print("If you think this is a bug, please file an issue and include "
              "the information above and the command-line you used.")
        sys.exit(1)


if __name__ == "__main__":
    main()
