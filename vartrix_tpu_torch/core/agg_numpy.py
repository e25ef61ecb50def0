"""Vectorized (NumPy) aggregation: per-read call codes -> per-(variant,
cell) ref/alt/unknown counts, with the reference's semantics
(reference src/main.rs:1019-1164):
  * every cell with >= 1 filter-surviving read forms a group, even if all
    its reads are MIN_SCORE-dropped (explicit zeros / NaN entries);
  * UMI consensus per (cell, umi) at the 0.75 threshold, f64 fractions,
    unknowns in denominators;
  * entry order per variant is ascending cell index (the reference's
    group_by over cell-sorted scores yields the same; comparisons are
    CSR-canonical anyway).
"""

from __future__ import annotations

import numpy as np

from ..constants import MIN_SCORE
from ..utils import trace


def _pack_shift(lo_vals, hi_vals, min_shift):
    """Bit width for packing ``hi << shift | lo`` into int64 without
    collisions: widens past ``min_shift`` when lo values exceed the default
    budget, and raises (instead of silently corrupting) when the combined
    key cannot fit 63 bits (cohorts past 2^24 barcodes or 2^30 UMI
    ids)."""
    lo_max = int(lo_vals.max()) if len(lo_vals) else 0
    hi_max = int(hi_vals.max()) if len(hi_vals) else 0
    if lo_max < 0 or hi_max < 0:
        raise ValueError("aggregation keys must be non-negative")
    shift = max(min_shift, lo_max.bit_length())
    if hi_max.bit_length() + shift > 63:
        raise ValueError(
            f"aggregation key overflow: {hi_max} groups x {lo_max} sub-keys "
            f"need {hi_max.bit_length() + shift} bits (> 63)")
    return shift


def codes_from_scores(scores2: np.ndarray) -> np.ndarray:
    """int32 [n, 2] (ref, alt) scores -> int8 call codes: 0 = dropped
    (both < MIN_SCORE), 1 = REF, 2 = ALT, 3 = UNKNOWN (tie). Host twin of
    the kernel's fused call reduction (reference src/main.rs:1019-1030)."""
    r, a = scores2[:, 0], scores2[:, 1]
    code = np.where(r > a, 1, np.where(a > r, 2, 3)).astype(np.int8)
    code[(r < MIN_SCORE) & (a < MIN_SCORE)] = 0
    return code


def as_codes(arr: np.ndarray) -> np.ndarray:
    """Normalize a per-variant scoring result — [n, 2] scores or [n]
    fused call codes — to int8 codes."""
    return arr if arr.ndim == 1 else codes_from_scores(arr)


def aggregate_flat(cells_l, umis_l, scores_l, use_umi):
    """Flat aggregation across ALL variants at once (no per-variant Python
    loop).

    scores_l entries are either [n, 2] int32 scores or [n] int8 fused
    call codes (the default kernel route returns codes; both normalize to
    codes here).

    -> (rows, cols, ref_count, alt_count, unk_count) sorted by (row, col),
    one entry per (variant, cell) group with >= 1 filter-surviving read.

    With UMIs, the vote (the (variant, cell, UMI) keys packed, np.unique
    over them, the 0.75 vote) is the span "vartrix::aggregate.umi".
    """
    n_reads = sum(len(c) for c in cells_l)
    if n_reads == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    rows = np.concatenate([np.full(len(c), i, np.int64)
                           for i, c in enumerate(cells_l)])
    cells = np.concatenate(cells_l).astype(np.int64)
    call = np.concatenate([as_codes(s) for s in scores_l])

    csh = _pack_shift(cells, rows, 24)
    cell_key = rows << csh | cells
    cg_uniq, cg = np.unique(cell_key, return_inverse=True)
    n_cg = len(cg_uniq)

    kept = call != 0
    kcg = cg[kept]
    kcall = call[kept]
    if use_umi:
        with trace.span("vartrix::aggregate.umi"):
            umis = np.concatenate(umis_l).astype(np.int64)[kept]
            ush = _pack_shift(umis, kcg, 30)
            ug_key = (kcg.astype(np.int64) << ush) | umis
            ug_uniq, ug = np.unique(ug_key, return_inverse=True)
            nu = len(ug_uniq)
            refc = np.bincount(ug, weights=(kcall == 1), minlength=nu)
            altc = np.bincount(ug, weights=(kcall == 2), minlength=nu)
            unkc = np.bincount(ug, weights=(kcall == 3), minlength=nu)
            tot = refc + altc + unkc
            # frac >= 0.75 as exact integer compare (4*c >= 3*tot)
            ucall = np.where(4 * altc >= 3 * tot, 2,
                             np.where(4 * refc >= 3 * tot, 1,
                                      3)).astype(np.int8)
            gcg = (ug_uniq >> ush).astype(np.int64)
    else:
        ucall = kcall
        gcg = kcg
    ref_c = np.bincount(gcg, weights=(ucall == 1), minlength=n_cg).astype(np.int64)
    alt_c = np.bincount(gcg, weights=(ucall == 2), minlength=n_cg).astype(np.int64)
    unk_c = np.bincount(gcg, weights=(ucall == 3), minlength=n_cg).astype(np.int64)
    return ((cg_uniq >> csh), (cg_uniq & ((1 << csh) - 1)),
            ref_c, alt_c, unk_c)
