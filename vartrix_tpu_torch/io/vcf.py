"""VCF parser.

Provides what the reference uses from rust-htslib's bcf reader
(reference src/main.rs:221-234,615-623): iterate records in file
order, exposing chrom, 0-based pos and the allele list
([REF] when the ALT column is '.', else [REF, ALT1, ...]).

Plain-text .vcf and gzip/bgzip-compressed .vcf.gz are supported, and
binary BCF (io/bcf.py), detected by content.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 0-based (matches rust-htslib rec.pos())
    ref: bytes
    alts: List[bytes]  # empty when ALT column is '.'

    @property
    def alleles(self) -> List[bytes]:
        return [self.ref] + self.alts


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def is_bcf(path: str) -> bool:
    """Detect binary BCF (possibly BGZF-compressed) by magic bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:3] == b"BCF":
        return True
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            return f.read(3) == b"BCF"
    return False


def read_vcf_records(path: str) -> List[VcfRecord]:
    """Read variant records from .vcf, .vcf.gz/.vcf.bgz, or binary .bcf
    (format detected by content, like htslib's bcf::Reader)."""
    if is_bcf(path):
        from .bcf import read_bcf_records
        return read_bcf_records(path)
    return list(iter_vcf_records(path))


def iter_vcf_records(path: str) -> Iterator[VcfRecord]:
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 5:
                raise ValueError(f"malformed VCF line: {line[:200]}")
            chrom, pos_s, _id, ref, alt = parts[:5]
            alts: List[bytes] = []
            if alt != "." and alt != "":
                alts = [a.encode() for a in alt.split(",")]
            yield VcfRecord(
                chrom=chrom,
                pos=int(pos_s) - 1,
                ref=ref.encode(),
                alts=alts,
            )
