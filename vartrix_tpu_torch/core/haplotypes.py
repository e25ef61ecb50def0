"""Reference/alternate haplotype construction around a variant locus.

Semantics mirror the reference (reference src/main.rs:936-994):
  ref_hap = uppercase reference over [start-padding, end+padding] clamped
            to [0, chrom_len)
  alt_hap = uppercase ref[start-padding, start)  ++  ALT (raw bytes, NOT
            uppercased)  ++  uppercase ref[end, end+padding)

Byte-level comparison matters downstream: the aligner scores raw byte
equality, so a lowercase ALT allele (allowed by --valid-chars defaults)
mismatches uppercase read bases exactly as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..io.fasta import IndexedFasta


@dataclass
class Locus:
    chrom: str
    start: int  # 0-based
    end: int    # exclusive: start + len(REF)


def read_locus(fa: IndexedFasta, loc: Locus, pad_left: int, pad_right: int) -> tuple[bytes, int]:
    new_start = max(0, loc.start - pad_left)
    new_end = min(loc.end + pad_right, fa.chrom_len(loc.chrom))
    # fetch_upper: uppercase conversion amortized once per cached chrom
    seq = fa.fetch_upper(loc.chrom, new_start, new_end)
    return seq, new_start


def construct_haplotypes(fa: IndexedFasta, locus: Locus, alt: bytes, padding: int) -> tuple[bytes, bytes]:
    chrom_len = fa.chrom_len(locus.chrom)

    def get_range(s: int, e: int) -> bytes:
        seq, _ = read_locus(fa, Locus(locus.chrom, s, e), 0, 0)
        return seq

    alt_hap = (
        get_range(max(0, locus.start - padding), locus.start)
        + alt
        + get_range(locus.end, min(locus.end + padding, chrom_len))
    )
    ref_hap, _ = read_locus(fa, locus, padding, padding)
    return ref_hap, alt_hap
