"""Per-read call logic and per-cell aggregation into matrix values.

Host-side exact implementation of the reference semantics
(reference src/main.rs:1019-1164):

  * evaluate_scores: both scores < MIN_SCORE -> read dropped; ref>alt -> 1;
    alt>ref -> 2; tie -> -1 (UNKNOWN).
  * A cell group exists for every cell with >= 1 read that survived the
    filter chain — even if all its reads were then dropped by MIN_SCORE
    (this produces explicit 0 entries in coverage mode and NaN in alt_frac,
    matching the goldens' stored zeros).
  * UMI mode: calls bucketed per UMI; a UMI is called REF/ALT when its
    ref/alt fraction (unknowns in the denominator) >= 0.75, else UNKNOWN.
  * consensus: ref&alt -> 3, alt -> 2, ref -> 1, else no entry.
  * alt_frac: alt/(ref+alt+unk); unknowns count in the denominator.
  * coverage: (alt_count, ref_count) pair of matrices, explicit zeros kept.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..constants import (
    ALT_VALUE,
    CONSENSUS_THRESHOLD,
    MIN_SCORE,
    REF_ALT_VALUE,
    REF_VALUE,
    UNKNOWN_VALUE,
)

log = logging.getLogger("vartrix")


@dataclass
class Scores:
    """Per-read outcome (reference src/main.rs:996-1001)."""
    cell_index: int
    umi: bytes
    ref_score: int
    alt_score: int


def evaluate_scores(ref_score: int, alt_score: int) -> Optional[int]:
    if ref_score < MIN_SCORE and alt_score < MIN_SCORE:
        return None
    if ref_score > alt_score:
        return REF_VALUE
    if alt_score > ref_score:
        return ALT_VALUE
    return UNKNOWN_VALUE


@dataclass
class CellCounts:
    ref_count: int = 0
    alt_count: int = 0
    unk_count: int = 0


def convert_to_counts(calls: List[int]) -> CellCounts:
    return CellCounts(
        ref_count=sum(1 for c in calls if c == REF_VALUE),
        alt_count=sum(1 for c in calls if c == ALT_VALUE),
        unk_count=sum(1 for c in calls if c == UNKNOWN_VALUE),
    )


def parse_scores(scores: List[Scores], umi: bool) -> List[Tuple[int, List[int]]]:
    """Group sorted scores by cell; returns [(cell_index, calls)].

    `scores` must be sorted (stably) by cell_index, as the reference sorts
    at src/main.rs:932."""
    out: List[Tuple[int, List[int]]] = []
    i, n = 0, len(scores)
    while i < n:
        cell = scores[i].cell_index
        j = i
        while j < n and scores[j].cell_index == cell:
            j += 1
        group = scores[i:j]
        i = j
        if umi:
            per_umi: Dict[bytes, List[int]] = {}
            for s in group:
                ev = evaluate_scores(s.ref_score, s.alt_score)
                if ev is None:
                    continue
                per_umi.setdefault(s.umi, []).append(ev)
            collapsed: List[int] = []
            for _u, calls in per_umi.items():
                c = convert_to_counts(calls)
                if log.isEnabledFor(logging.DEBUG):
                    log.debug(
                        "cell_index %d / UMI %s saw counts ref: %d alt: %d "
                        "unk: %d", cell,
                        _u.decode(errors="replace") if isinstance(_u, bytes)
                        else _u,
                        c.ref_count, c.alt_count, c.unk_count)
                tot = float(c.ref_count + c.alt_count + c.unk_count)
                ref_frac = c.ref_count / tot
                alt_frac_v = c.alt_count / tot
                if ref_frac < CONSENSUS_THRESHOLD and alt_frac_v < CONSENSUS_THRESHOLD:
                    collapsed.append(UNKNOWN_VALUE)
                elif alt_frac_v >= CONSENSUS_THRESHOLD:
                    collapsed.append(ALT_VALUE)
                else:
                    collapsed.append(REF_VALUE)
            out.append((cell, collapsed))
        else:
            calls = []
            for s in group:
                ev = evaluate_scores(s.ref_score, s.alt_score)
                if ev is not None:
                    calls.append(ev)
            out.append((cell, calls))
    return out


def _warn_unknowns(counts: CellCounts, i: int, cell_index: int) -> None:
    if counts.unk_count > 1:
        log.info(
            "Variant at index %d has multiple unknown reads at barcode index %d. "
            "Check this locus manually", i, cell_index,
        )


def consensus_scoring(scores: List[Scores], i: int, umi: bool) -> List[Tuple[int, float]]:
    result = []
    for cell, calls in parse_scores(scores, umi):
        c = convert_to_counts(calls)
        _warn_unknowns(c, i, cell)
        if c.ref_count > 0 and c.alt_count > 0:
            result.append((cell, float(REF_ALT_VALUE)))
        elif c.alt_count > 0:
            result.append((cell, float(ALT_VALUE)))
        elif c.ref_count > 0:
            result.append((cell, float(REF_VALUE)))
    return result


def alt_frac(scores: List[Scores], i: int, umi: bool) -> List[Tuple[int, float]]:
    result = []
    for cell, calls in parse_scores(scores, umi):
        c = convert_to_counts(calls)
        _warn_unknowns(c, i, cell)
        denom = float(c.ref_count + c.alt_count + c.unk_count)
        if denom == 0.0:
            # 0/0 in Rust f64 arithmetic -> NaN entry, preserved.
            result.append((cell, float("nan")))
        else:
            result.append((cell, c.alt_count / denom))
    return result


def coverage(scores: List[Scores], i: int, umi: bool):
    alt_result, ref_result = [], []
    for cell, calls in parse_scores(scores, umi):
        c = convert_to_counts(calls)
        _warn_unknowns(c, i, cell)
        alt_result.append((cell, float(c.alt_count)))
        ref_result.append((cell, float(c.ref_count)))
    return alt_result, ref_result
