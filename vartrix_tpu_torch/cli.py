"""Command-line interface.

Mirrors the reference CLI exactly: same 18 flags, same short names, same
defaults, same choices (reference src/main.rs:40-135), plus the framework
flags of vartrix_tpu's CLI. --device and --backend choose where and how
the Smith-Waterman scores are computed. Flags whose path this package has
not ported yet are accepted and refused by the driver with a message.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="vartrix",
        description="Variant assignment for single cell genomics "
                    "(PyTorch/CUDA)",
    )
    p.add_argument("--version", action="version", version=f"vartrix {__version__}")
    p.add_argument("-v", "--vcf", metavar="FILE", required=True,
                   help="Called variant file (VCF)")
    p.add_argument("-b", "--bam", metavar="FILE", required=True,
                   help="Cellranger BAM file")
    p.add_argument("-f", "--fasta", metavar="FILE", required=True,
                   help="Genome fasta file")
    p.add_argument("-c", "--cell-barcodes", dest="cell_barcodes", metavar="FILE",
                   required=True, help="File with cell barcodes to be evaluated")
    p.add_argument("-o", "--out-matrix", dest="out_matrix", metavar="OUTPUT_FILE",
                   default="out_matrix.mtx", help="Output Matrix Market file (.mtx)")
    p.add_argument("--out-variants", dest="out_variants", metavar="OUTPUT_FILE",
                   default=None,
                   help="Output variant file. Reports ordered list of variants "
                        "to help with loading into downstream tools")
    p.add_argument("--out-barcodes", dest="out_barcodes", metavar="OUTPUT_FILE",
                   default=None,
                   help="Output cell barcode file. Barcode labels of output "
                        "matrices. Will have duplicate barcodes removed compared "
                        "to input barcodes file.")
    p.add_argument("-p", "--padding", metavar="INTEGER", type=int, default=100,
                   help="Number of padding to use on both sides of the variant. "
                        "Should be at least 1/2 of read length")
    p.add_argument("-s", "--scoring-method", dest="scoring_method",
                   choices=["consensus", "coverage", "alt_frac"],
                   default="consensus",
                   help="Type of matrix to produce. In 'consensus' mode, cells "
                        "with both ref and alt reads are given a 3, alt only "
                        "reads a 2, and ref only reads a 1. Suitable for "
                        "clustering. In 'coverage' mode, it is required that you "
                        "set --ref-matrix to store the second matrix in. The "
                        "'alt_frac' mode will report the fraction of alt reads.")
    p.add_argument("--ref-matrix", dest="ref_matrix", metavar="OUTPUT_FILE",
                   default="ref_matrix.mtx",
                   help="Location to write reference Matrix Market file. Only "
                        "used if --scoring-method is coverage")
    p.add_argument("--log-level", dest="log_level",
                   choices=["info", "debug", "error"], default="error",
                   help="Logging level")
    p.add_argument("--threads", metavar="INTEGER", type=int, default=1,
                   help="Number of parallel threads to use")
    p.add_argument("--mapq", metavar="INTEGER", type=int, default=0,
                   help="Minimum read mapping quality to consider")
    p.add_argument("--primary-alignments", dest="primary_alignments",
                   action="store_true", help="Use primary alignments only")
    p.add_argument("--no-duplicates", dest="no_duplicates", action="store_true",
                   help="Do not consider duplicate alignments")
    p.add_argument("--umi", action="store_true",
                   help="Consider UMI information when populating coverage matrices?")
    p.add_argument("--bam-tag", dest="bam_tag", default="CB",
                   help="BAM tag to consider for marking cells?")
    p.add_argument("--valid-chars", dest="valid_chars", default="ATGCatgc",
                   help="Valid characters in an alternative haplotype. This "
                        "prevents non sequence-resolved variants from being genotyped.")
    # --- framework extensions (additive) ---
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device that scores the alignments. With no CUDA "
                        "device the run stops unless --device cpu is given")
    p.add_argument("--backend", choices=["cuda", "torch"], default="cuda",
                   help="Smith-Waterman scorer: the hand-written CUDA kernel "
                        "(needs --device cuda) or the plain PyTorch version "
                        "on --device")
    p.add_argument("--sw-mode", dest="sw_mode", choices=["full", "banded"],
                   default="full",
                   help="Alignment scoring: 'full' (exact unbanded SW — the "
                        "default; strictly >= banded scores) or 'banded' "
                        "(k-mer chained band, k=6 w=20, reproducing the "
                        "reference tool's rust-bio banding behavior)")
    p.add_argument("--host", choices=["auto", "native", "python"], default="auto",
                   help="Host-side BAM runtime: native columnar decoder "
                        "(libgenomio C++; 'python' is not yet ported)")
    p.add_argument("--fetch", choices=["auto", "whole", "regions"],
                   default="auto",
                   help="BAM read strategy: decode the whole file (fastest "
                        "for dense variant sets) or only the BAI/CSI-indexed "
                        "regions overlapping variants ('regions' is not yet "
                        "ported; 'auto' decodes the whole file)")
    p.add_argument("--stream", metavar="N_VARIANTS", type=int, default=0,
                   help="window the decode->collect->score pipeline over "
                        "contiguous groups of N variants via the BAI region "
                        "plan: peak memory is bounded to one window and the "
                        "next window's decode overlaps the current window's "
                        "scoring. Outputs are identical to the monolithic "
                        "path. 0 (default) = off; requires an index and a "
                        "BAM input (not yet ported)")
    p.add_argument("--profile-dir", dest="profile_dir", metavar="DIR", default=None,
                   help="Write a profiler trace of the scoring phase to "
                        "this directory (not yet ported)")
    p.add_argument("--metrics-json", dest="metrics_json", metavar="FILE",
                   default=None,
                   help="Write run metrics as JSON: the 9 reference "
                        "counters, per-phase wall-clock seconds, matrix "
                        "nnz, and configuration")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", metavar="DIR",
                   default=None,
                   help="Spill per-variant score blocks to this directory and "
                        "resume from them on a rerun (long-run fault tolerance; "
                        "not yet ported)")
    p.add_argument("--mesh-devices", dest="mesh_devices", type=int, default=0,
                   metavar="N",
                   help="Shard scoring batches across N local accelerator "
                        "devices (0 = single device; not yet ported)")
    p.add_argument("--device-agg", dest="device_agg", action="store_true",
                   help="Run the call + (variant,cell) scatter-add aggregation "
                        "(incl. UMI-group consensus) on the accelerator instead "
                        "of the host (not yet ported)")
    p.add_argument("--num-shards", dest="num_shards", type=int, default=1,
                   metavar="N",
                   help="Distribute over N hosts/processes: this process "
                        "computes only its contiguous variant-row shard and "
                        "writes a partial matrix")
    p.add_argument("--shard-index", dest="shard_index", type=int, default=0,
                   metavar="I", help="This process's shard index in [0, N)")
    p.add_argument("--distributed", dest="distributed", metavar="ADDR:PORT,N,RANK",
                   default=None,
                   help="Run as one process of a distributed job (not yet "
                        "ported)")
    return p
