"""Variant preparation (VCF records -> per-variant haplotypes and skip
flags) and the Python record path (--host python): collect_reads streams
the records once and joins each to the variant windows it overlaps through
the filter chain; score_all scores every (read, haplotype) pair in padded
shape buckets. Both keep the reference's semantics (reference
src/main.rs:646-684, 829-894); the native path's counterparts are in
core/fast_pipeline.py.
"""

from __future__ import annotations

import logging
from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.fasta import IndexedFasta
from ..io.vcf import VcfRecord
from ..utils import trace
from ..utils.metrics import Metrics
from .haplotypes import Locus

log = logging.getLogger("vartrix")


@dataclass
class PipelineArgs:
    """Filter configuration (reference `Arguments`, src/main.rs:420-427)."""
    primary: bool = False
    mapq: int = 0
    duplicates: bool = False
    use_umi: bool = False
    bam_tag: str = "CB"
    valid_chars: bytes = b"ATGCatgc"
    padding: int = 100


class VariantWork:
    """Per-variant state: the haplotypes, whether the record is skipped,
    the reads the Python record path collects for it, and its filter
    metrics (the lists and metrics are created lazily: untouched rows carry
    none)."""

    __slots__ = ("row", "locus", "rref", "alt_hap", "skipped",
                 "_read_seqs", "_cell_indices", "_umis", "_qnames",
                 "_metrics")

    def __init__(self, row: int, locus: Locus):
        self.row = row
        self.locus = locus
        self.rref = b""
        self.alt_hap = b""
        self.skipped = False
        self._read_seqs = None
        self._cell_indices = None
        self._umis = None
        self._qnames = None
        self._metrics = None

    @property
    def read_seqs(self) -> List[bytes]:
        if self._read_seqs is None:
            self._read_seqs = []
        return self._read_seqs

    @property
    def cell_indices(self) -> List[int]:
        if self._cell_indices is None:
            self._cell_indices = []
        return self._cell_indices

    @property
    def umis(self) -> List[bytes]:
        if self._umis is None:
            self._umis = []
        return self._umis

    @property
    def qnames(self) -> List[bytes]:
        if self._qnames is None:
            self._qnames = []
        return self._qnames

    @property
    def metrics(self) -> Metrics:
        if self._metrics is None:
            self._metrics = Metrics()
        return self._metrics


def prepare_variants(
    records: List[VcfRecord],
    fasta: IndexedFasta,
    args: PipelineArgs,
    row_range=None,
) -> List[VariantWork]:
    """Build haplotypes; mark multi-allelic / invalid-ALT records skipped
    (semantics of src/main.rs:646-684). row_range=(lo, hi) restricts the
    computed rows for sharded multi-host runs — out-of-range rows are
    silently skipped (no metrics, no haplotypes) but keep their place in
    the matrix dimensions."""
    # valid-chars semantics (src/main.rs:675-684): the check covers the
    # FULL alt haplotype = uppercase ref padding ++ raw ALT bytes. It is
    # decomposed here so the per-record cost is O(len(ALT)):
    #   * ALT bytes: bytes.translate with the valid set as delete table
    #     (leftover bytes == invalid chars), C-speed;
    #   * padding windows: a per-chrom sorted index of invalid positions
    #     in the UPPERCASE chromosome (usually just N runs; empty for
    #     clean genomes), range-tested with searchsorted. Built once per
    #     chrom — the old per-record numpy scan was ~2s of the
    #     100k-variant cohort's haplotypes phase.
    valid_lut = np.zeros(256, dtype=bool)
    valid_lut[list(args.valid_chars)] = True
    delete_tbl = bytes(args.valid_chars)
    bad_pos_cache: Dict[str, np.ndarray] = {}

    def bad_positions(chrom: str) -> np.ndarray:
        arr = bad_pos_cache.get(chrom)
        if arr is None:
            with trace.span("vartrix::haplotypes.invalid_index"):
                seq = fasta.fetch_upper(chrom, 0, fasta.chrom_len(chrom))
                arr = np.nonzero(~valid_lut[np.frombuffer(seq, np.uint8)])[0]
            bad_pos_cache[chrom] = arr
        return arr

    def padding_invalid(chrom: str, a1, b1, a2, b2) -> bool:
        bp = bad_positions(chrom)
        if not bp.size:
            return False
        return bool(np.searchsorted(bp, a1) < np.searchsorted(bp, b1)
                    or np.searchsorted(bp, a2) < np.searchsorted(bp, b2))

    # Records are processed GROUPED BY CHROMOSOME (row order preserved
    # in the output): haplotypes then come from three plain byte slices
    # per record off one resident uppercase chromosome instead of the
    # layered fetch/clamp call chain (construct_haplotypes stays as the
    # readable single-variant constructor; pure function-call overhead
    # was >60% of the 100k-variant cohort's haplotypes phase), and an
    # UNSORTED VCF costs one chromosome fill per chrom rather than one
    # per chrom switch (O(switches x chrom_len) I/O otherwise).
    by_chrom: Dict[str, List[int]] = {}
    for i, rec in enumerate(records):
        by_chrom.setdefault(rec.chrom, []).append(i)
    pad = args.padding
    works: List[Optional[VariantWork]] = [None] * len(records)
    for chrom, idxs in by_chrom.items():
        cu, clen = b"", 0
        for i in idxs:
            rec = records[i]
            locus = Locus(rec.chrom, rec.pos, rec.pos + len(rec.ref))
            w = works[i] = VariantWork(row=i, locus=locus)
            if row_range is not None and not (row_range[0] <= i < row_range[1]):
                w.skipped = True
                continue
            alleles = rec.alleles
            if len(alleles) > 2:
                log.info("Variant at %s:%d is multi-allelic. It will be "
                         "ignored.", rec.chrom, rec.pos)
                w.metrics.num_multiallelic_recs += 1
                w.skipped = True
                continue
            alt = alleles[1] if len(alleles) > 1 else b""
            if not cu:
                clen = fasta.chrom_len(chrom)
                cu = fasta.fetch_upper(chrom, 0, clen)
            s, e = locus.start, locus.end
            a1 = s - pad
            if a1 < 0:
                a1 = 0
            b2 = e + pad
            if b2 > clen:
                b2 = clen
            rref = cu[a1:b2]
            alt_hap = cu[a1:s] + alt + cu[e:b2]
            # NOTE: the reference checks valid chars on the FULL alt
            # haplotype (src/main.rs:675-684), i.e. including the
            # reference padding — an N in the padded reference sequence
            # also skips the record.
            invalid = bool(alt_hap) and (
                bool(alt.translate(None, delete_tbl))
                or padding_invalid(rec.chrom, a1, s, e, b2))
            if invalid:
                log.warning(
                    "Variant at %s:%d has invalid alternative characters. "
                    "This record will be ignored.", rec.chrom, rec.pos)
                w.metrics.num_invalid_recs += 1
                w.skipped = True
                continue
            w.rref = rref
            w.alt_hap = alt_hap
    return works


def _record_useful(rec, start: int, end: int) -> bool:
    """Reference useful_alignment (src/main.rs:790-806): an aligned base
    (M/=/X, or D; not N, not soft-clip) at any ref position in
    [start, end] INCLUSIVE."""
    try:
        hi = end + 1  # inclusive end -> half-open [start, end+1)
        for a, b in rec.aligned_ref_intervals(include_dels=True):
            if a < hi and b > start:
                return True
        return False
    except Exception:
        return False


def collect_reads(
    bam,
    works: List[VariantWork],
    cell_barcodes: Dict[bytes, int],
    args: PipelineArgs,
) -> None:
    """Stream the records of `bam` (io/bam.BamReader, io/bai.RegionStream,
    io/cram.CramReader, or anything with .tid_by_name and .records()) once
    and attach the surviving reads to each overlapping variant, with the
    filter-chain metrics of src/main.rs:829-894."""
    # group fetchable variant windows per tid
    by_tid: Dict[int, List[VariantWork]] = {}
    for w in works:
        if w.skipped:
            continue
        tid = bam.tid_by_name.get(w.locus.chrom)
        if tid is None:
            raise KeyError(f"chromosome {w.locus.chrom} not in BAM header")
        by_tid.setdefault(tid, []).append(w)
    index: Dict[int, Tuple[List[int], List[VariantWork], int]] = {}
    for tid, ws in by_tid.items():
        ws.sort(key=lambda w: (w.locus.start, w.row))
        starts = [w.locus.start for w in ws]
        max_span = max((w.locus.end - w.locus.start) for w in ws)
        index[tid] = (starts, ws, max_span)

    bam_tag = args.bam_tag.encode()
    for rec in bam.records():
        ent = index.get(rec.tid)
        if ent is None:
            continue
        starts, ws, max_span = ent
        rec_pos = rec.pos
        rec_end = rec.endpos()
        hi = bisect_left(starts, rec_end)
        lo = bisect_left(starts, rec_pos - max_span)
        if lo >= hi:
            continue
        seq: Optional[bytes] = None
        cb_parsed = False
        cb_val: Optional[bytes] = None
        umi_parsed = False
        umi_val: Optional[bytes] = None
        for k in range(lo, hi):
            w = ws[k]
            # htslib fetch overlap: rec.pos < end and endpos > start
            if not (rec_pos < w.locus.end and rec_end > w.locus.start):
                continue
            m = w.metrics
            m.num_reads += 1
            if rec.mapq < args.mapq:
                m.num_low_mapq += 1
                continue
            if args.primary and (rec.is_secondary() or rec.is_supplementary()):
                m.num_non_primary += 1
                continue
            if args.duplicates and rec.is_duplicate():
                m.num_duplicates += 1
                continue
            if not _record_useful(rec, w.locus.start, w.locus.end):
                m.num_not_useful += 1
                continue
            if not cb_parsed:
                cb_parsed = True
                cb_val = rec.aux_string(bam_tag)
            cell_index = cell_barcodes.get(cb_val) if cb_val is not None else None
            if cell_index is None:
                m.num_not_cell_bc += 1
                continue
            if not umi_parsed:
                umi_parsed = True
                umi_val = rec.aux_string(b"UB")
            if args.use_umi and umi_val is None:
                m.num_non_umi += 1
                continue
            umi = umi_val if args.use_umi else b"\x01"
            if seq is None:
                seq = rec.seq_bytes()
            w.read_seqs.append(seq)
            w.cell_indices.append(cell_index)
            w.umis.append(umi)
            w.qnames.append(rec.qname)


def score_all(
    works: List[VariantWork],
    score_batch_fn,
    lx_quantum: int = 16,
    ly_quantum: int = 32,
) -> List[np.ndarray]:
    """Score every (read, ref_hap) and (read, alt_hap) pair.

    score_batch_fn(x uint8 [B, Lx], y uint8 [B, Ly]) -> int32 [B]: the
    backend's plain-row entry (ops/sw_cuda.SwBackend or BandedSwBackend
    called). Pairs are bucketed by quantized (Lx, Ly), reads padded with 0
    and haplotypes with 1. Returns, per variant, an int32 [n_reads, 2]
    array of (ref_score, alt_score).

    Empty haplotypes (possible for empty-ALT deletion records at a
    chromosome edge) score 0 without invoking the backend, matching
    local SW on an empty sequence.
    """
    tasks: List[Tuple[int, int, int, bytes, bytes]] = []  # (w_idx, read_idx, which, x, y)
    for wi, w in enumerate(works):
        for ri, seq in enumerate(w.read_seqs):
            tasks.append((wi, ri, 0, seq, w.rref))
            tasks.append((wi, ri, 1, seq, w.alt_hap))

    results = [np.zeros((len(w.read_seqs), 2), dtype=np.int32) for w in works]

    def q(n: int, quantum: int) -> int:
        return max(quantum, ((n + quantum - 1) // quantum) * quantum)

    buckets: Dict[Tuple[int, int], List[int]] = {}
    for t_idx, (_, _, _, x, y) in enumerate(tasks):
        if len(x) == 0 or len(y) == 0:
            continue  # score stays 0
        buckets.setdefault((q(len(x), lx_quantum), q(len(y), ly_quantum)), []).append(t_idx)

    for (lx, ly), t_indices in sorted(buckets.items()):
        B = len(t_indices)
        xs = np.zeros((B, lx), dtype=np.uint8)       # pad byte 0
        ys = np.full((B, ly), 1, dtype=np.uint8)     # pad byte 1
        for b, t_idx in enumerate(t_indices):
            _, _, _, x, y = tasks[t_idx]
            xs[b, : len(x)] = np.frombuffer(x, dtype=np.uint8)
            ys[b, : len(y)] = np.frombuffer(y, dtype=np.uint8)
        scores = np.asarray(score_batch_fn(xs, ys), dtype=np.int32)
        for b, t_idx in enumerate(t_indices):
            wi, ri, which, _, _ = tasks[t_idx]
            results[wi][ri, which] = scores[b]
    return results
