"""Run metrics — the 9 counters of the reference (reference src/main.rs:449-459),
accumulated per variant and merged; part of observable behavior (logged at
info level, src/main.rs:350-379)."""

from __future__ import annotations

from dataclasses import dataclass


_FIELDS = ("num_reads", "num_low_mapq", "num_non_primary",
           "num_duplicates", "num_not_cell_bc", "num_not_useful",
           "num_non_umi", "num_invalid_recs", "num_multiallelic_recs")


@dataclass
class Metrics:
    num_reads: int = 0
    num_low_mapq: int = 0
    num_non_primary: int = 0
    num_duplicates: int = 0
    num_not_cell_bc: int = 0
    num_not_useful: int = 0
    num_non_umi: int = 0
    num_invalid_recs: int = 0
    num_multiallelic_recs: int = 0

    def add(self, other: "Metrics") -> None:
        # static field tuple, not dataclasses.fields(): the merge runs
        # once per variant and introspection was measurable at 100k rows
        for f in _FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in _FIELDS}


def log_metrics(log, m: Metrics) -> None:
    log.info("Number of alignments evaluated: %d", m.num_reads)
    log.info("Number of alignments skipped due to low mapping quality: %d", m.num_low_mapq)
    log.info("Number of alignments skipped due to not being primary: %d", m.num_non_primary)
    log.info("Number of alignments skipped due to being duplicates: %d", m.num_duplicates)
    log.info("Number of alignments skipped due to not being associated with a cell barcode: %d", m.num_not_cell_bc)
    log.info("Number of alignments skipped due to not intersecting variant: %d", m.num_not_useful)
    log.info("Number of alignments skipped due to not having a UMI: %d", m.num_non_umi)
    log.info("Number of VCF records skipped due to having invalid characters in the alternative haplotype: %d", m.num_invalid_recs)
    log.info("Number of VCF records skipped due to being multi-allelic: %d", m.num_multiallelic_recs)
