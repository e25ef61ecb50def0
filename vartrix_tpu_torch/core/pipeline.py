"""Variant preparation: VCF records -> per-variant haplotypes and skip
flags, with the reference's semantics (reference src/main.rs:646-684).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..io.fasta import IndexedFasta
from ..io.vcf import VcfRecord
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
    and its filter metrics (created lazily: untouched rows carry none)."""

    __slots__ = ("row", "locus", "rref", "alt_hap", "skipped", "_metrics")

    def __init__(self, row: int, locus: Locus):
        self.row = row
        self.locus = locus
        self.rref = b""
        self.alt_hap = b""
        self.skipped = False
        self._metrics = None

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
