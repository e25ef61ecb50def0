"""Top-level driver: argv -> matrices on disk.

The run of the reference `_main` (reference src/main.rs:163-418) with the
native host runtime: validate the inputs, build the haplotypes, decode the
whole BAM into columns, filter and join reads to variants, score every
(read, haplotype) pair on the device, aggregate the call codes and write
the matrices. Callable in-process (`_main(argv)`) for tests.

Scoring runs on --device (default cuda) with --backend cuda (the
hand-written kernel, default) or torch (the plain PyTorch version). A run
that asks for a CUDA device where there is none stops; it never continues
on the CPU unless --device cpu is given.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch

from .cli import build_parser
from .core import agg_numpy
from .core.fast_pipeline import collect_reads_fast, score_all_fast
from .core.pipeline import PipelineArgs, prepare_variants
from .io.bam import BamHeader
from .io.bam_native import ColumnarBam
from .io.barcodes import load_barcodes, write_barcodes
from .io.fasta import FastaIndex, IndexedFasta
from .io.matrix_market import TriMat, write_matrix_market
from .io.vcf import is_bcf, iter_vcf_records, read_vcf_records
from .ops import sw_cuda
from .utils.metrics import Metrics, log_metrics

log = logging.getLogger("vartrix")


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


def write_variants(out_variants: str, vcf_file: str) -> None:
    with open(out_variants, "wt") as f:
        for rec in iter_vcf_records(vcf_file):
            f.write(f"{rec.chrom}_{rec.pos}\n")


def shard_range(num_vars: int, num_shards: int, shard_index: int):
    """Contiguous row range of a shard, by the reference's chunking rule
    (chunk = max(num_vars // num_shards, 1))."""
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard index {shard_index} outside [0, {num_shards})")
    chunk = max(num_vars // num_shards, 1)
    lo = min(chunk * shard_index, num_vars)
    hi = (num_vars if shard_index == num_shards - 1
          else min(chunk * (shard_index + 1), num_vars))
    return lo, hi


_PHASE_TIMES: Dict[str, float] = {}


@contextmanager
def _phase(name: str):
    """Wall-clock a pipeline stage at info level and collect it for
    --metrics-json."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASE_TIMES[name] = _PHASE_TIMES.get(name, 0.0) + dt
        log.info("Phase %-12s %.2fs", name, dt)


def _not_ported(args) -> List[str]:
    """The requested options whose path this package does not have yet."""
    asked = {
        "--host python": args.host == "python",
        "--stream": args.stream > 0,
        "--fetch regions": args.fetch == "regions",
        "CRAM input": _is_cram(args.bam),
        "BCF input": is_bcf(args.vcf),
        "--sw-mode banded": args.sw_mode == "banded",
        "--device-agg": args.device_agg,
        "--mesh-devices": args.mesh_devices != 0,
        "--distributed": args.distributed is not None,
        "--checkpoint-dir": args.checkpoint_dir is not None,
        "--profile-dir": args.profile_dir is not None,
    }
    return [k for k, v in asked.items() if v]


def select_backend(device: str, backend: str) -> sw_cuda.SwBackend:
    """The scoring backend for --device/--backend; exits on a combination
    that cannot run here."""
    if device == "cuda" and not torch.cuda.is_available():
        log.error("--device cuda: no CUDA device is available. The plain "
                  "version runs on the CPU only when asked: --device cpu "
                  "--backend torch")
        sys.exit(1)
    if backend == "cuda" and device != "cuda":
        log.error("--backend cuda is the CUDA kernel and needs --device "
                  "cuda; use --backend torch for --device %s", device)
        sys.exit(1)
    return sw_cuda.SwBackend(device, kernel=backend == "cuda")


def _main(argv: List[str]) -> None:
    """Full run. argv excludes the program name (pass sys.argv[1:])."""
    args = build_parser().parse_args(argv)
    _PHASE_TIMES.clear()  # fresh per run (tests call _main in-process)

    level = {"info": logging.INFO, "debug": logging.DEBUG, "error": logging.ERROR}[args.log_level]
    logging.basicConfig(level=level, stream=sys.stderr,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    log.setLevel(level)

    check_inputs_exist(args.fasta, args.vcf, args.bam, args.cell_barcodes,
                       args.out_matrix, args.ref_matrix)
    missing = _not_ported(args)
    if missing:
        log.error("not yet ported: %s", ", ".join(missing))
        sys.exit(1)
    backend = select_backend(args.device, args.backend)

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
        bam = BamHeader(args.bam)
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
    # FASTA and VCF, so the decode runs on a worker thread meanwhile
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        decode = ex.submit(ColumnarBam, args.bam, pargs.bam_tag.encode(),
                           max(args.threads, 1))
        with _phase("haplotypes"):
            works = prepare_variants(records, fasta, pargs,
                                     row_range=row_range)
        with _phase("decode"):  # the remaining wait
            cbam = decode.result()

    with _phase("collect"):
        read_idx, cells_l, umis_l = collect_reads_fast(
            cbam, works, cell_barcodes, pargs)
    launches = sw_cuda.LAUNCHES
    with _phase("score"):
        per_variant_codes = score_all_fast(cbam, works, read_idx, backend)
    launches = sw_cuda.LAUNCHES - launches
    log.debug("Finished aligning reads for all variants")

    metrics = Metrics()
    for w in works:
        if w._metrics is not None:  # lazy: untouched rows carry none
            metrics.add(w._metrics)
    with _phase("aggregate"):
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
    log.debug("Finished scoring alignments for all variants")

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

    if args.metrics_json:
        import json
        payload = {
            "metrics": metrics.as_dict(),
            "phase_seconds": {k: round(v, 4) for k, v in _PHASE_TIMES.items()},
            "matrix": {"shape": list(matrix.shape), "nnz": matrix.nnz()},
            "kernel_launches": {"sw_pair": launches},
            "config": {
                "scoring_method": args.scoring_method, "umi": args.umi,
                "device": args.device, "backend": args.backend,
                "host": "native", "sw_mode": args.sw_mode,
                "fetch": "whole", "threads": args.threads,
                "padding": args.padding,
            },
        }
        if args.scoring_method == "coverage":
            payload["ref_matrix_nnz"] = ref_matrix.nnz()
        with open(args.metrics_json, "wt") as f:
            json.dump(payload, f, indent=1)
        log.debug("Wrote metrics JSON")


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
