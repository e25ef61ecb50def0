"""Plain affine-gap Smith-Waterman in PyTorch: the reference's scores.

VarTrix scores each read against a haplotype by local alignment with
rust-bio's scoring (reference src/main.rs:27-38): match +1, mismatch -5,
a gap of length L costs -5 - L, bytes compared raw. This module computes
the best local score of many pairs at once, row by row over the read: for
row i and haplotype column j,

    F[i, j] = max(H[i-1, j] - 6, F[i-1, j] - 1)
    T[i, j] = max(0, H[i-1, j-1] + s(x_i, y_j), F[i, j])
    E[i, j] = max over k < j of T[i, k] - 5 - (j - k)
    H[i, j] = max(T[i, j], E[i, j])

E in closed form (a running maximum along the row) is exact with T in
place of H: a gap that starts from a cell reached by another gap never
beats extending the first. Reads are padded with 0 and haplotypes with 1:
a pad never matches, so a padded cell never raises the best score.

`banded_scores` restricts the same recurrence to a band, an interval of
columns per read row: outside it H = 0 and E = F = -inf, the boundary of
rust-bio's banded aligner.

`bits` saturates every cell to a signed integer of that many bits; the
control is `bits=4` ([-8, 7]), the nearest precision below the int8 that
every score of a read of at most 127 bases fits (scores are at most the
read's length). Nothing else changes.
"""

from __future__ import annotations

from typing import Optional

import torch

MATCH = 1
MISMATCH = -5
GAP_OPEN = -5
GAP_EXTEND = -1
NEG = -(1 << 28)


def _clamp(t: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    if bits is None:
        return t
    lim = 1 << (bits - 1)
    return t.clamp(-lim, lim - 1)


def _scores(x, y, jlo, jhi, bits):
    B, lx = x.shape
    ly = y.shape[1]
    dev = x.device
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or lx == 0 or ly == 0:
        return best
    jj = torch.arange(ly, dtype=torch.int32, device=dev)[None, :]
    gap_from = GAP_OPEN + GAP_EXTEND * jj   # E[j] = max(T[k] - GE*k) + this
    lift = -GAP_EXTEND * jj
    neg = _clamp(torch.full((), NEG, dtype=torch.int32, device=dev), bits)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    h = torch.zeros((B, ly), dtype=torch.int32, device=dev)
    f = torch.full((B, ly), int(neg), dtype=torch.int32, device=dev)
    yi = y.to(torch.int32)
    xi = x.to(torch.int32)
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    ncol = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    for i in range(lx):
        s = torch.where(xi[:, i : i + 1] == yi, MATCH, MISMATCH)
        diag = torch.cat([zcol, h[:, :-1]], dim=1)
        f = _clamp(torch.maximum(h + (GAP_OPEN + GAP_EXTEND),
                                 f + GAP_EXTEND), bits)
        band = None
        if jlo is not None:
            band = (jj >= jlo[:, i : i + 1]) & (jj < jhi[:, i : i + 1])
            f = torch.where(band, f, neg)
        t = _clamp(torch.clamp_min(torch.maximum(diag + s, f), 0), bits)
        if band is not None:
            t = torch.where(band, t, zero)
        run = torch.cummax(t + lift, dim=1).values
        e = _clamp(torch.cat([ncol, run[:, :-1]], dim=1) + gap_from, bits)
        if band is not None:
            e = torch.where(band, e, neg)
        h = torch.maximum(t, e)
        if band is not None:
            h = torch.where(band, h, zero)
        best = torch.maximum(best, h.amax(dim=1))
    return best


def scores(x: torch.Tensor, y: torch.Tensor,
           bits: Optional[int] = None) -> torch.Tensor:
    """uint8 x [B, lx] (pad 0) and y [B, ly] (pad 1) -> int32 [B], the
    best local alignment score of each row pair."""
    return _scores(x, y, None, None, bits)


def banded_scores(x: torch.Tensor, y: torch.Tensor, jlo: torch.Tensor,
                  jhi: torch.Tensor, bits: Optional[int] = None
                  ) -> torch.Tensor:
    """As scores, with cell (i, j) in the band when jlo[b, i] <= j <
    jhi[b, i] (int32 [B, lx])."""
    return _scores(x, y, jlo.to(torch.int32), jhi.to(torch.int32), bits)
