"""Plain PyTorch version of the banded Smith-Waterman kernel.

The anti-diagonal recurrence of the JAX package's banded TPU kernel
(vartrix_tpu/ops/sw_pallas_v2.py `_sw_kernel_v4_banded`), written out over
the batch and the read rows of each diagonal. Cell (i, j) lies in the band
when jlo[i] <= j < jhi[i]; out of band, H = 0, E = NEG and F = NEG, the
boundary of the native banded aligner, so the score equals
`banded_sw_chained` on the bounds of ops/sw_native.band_bounds.

F is scanned diagonal by diagonal, not in the closed form of ops/sw_torch.py:
the band resets F at every out-of-band cell, where a running maximum down
the column would have to restart.

Same entry points and layouts as the kernel's wrappers (ops/sw_cuda.py):
bounds int32 [lx, P], one column per problem. Runs on whichever device its
tensors are on; the CPU tests use it and the GPU smoke check holds the
kernel against it on the card.
"""

from __future__ import annotations

import torch

from ..constants import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH
from .sw_torch import NEG, calls_from_scores


def banded_scores(x: torch.Tensor, y: torch.Tensor, jlo: torch.Tensor,
                  jhi: torch.Tensor) -> torch.Tensor:
    """uint8 x [B, lx] (pad 0), uint8 y [B, ly] (pad 1), int32 jlo/jhi
    [lx, B] band bounds -> int32 [B] best banded local scores."""
    B, lx = x.shape
    ly = y.shape[1]
    dev = x.device
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or lx == 0 or ly == 0:
        return best
    lo = jlo.T.to(torch.int64)
    hi = jhi.T.to(torch.int64)
    ii = torch.arange(lx, device=dev)
    # diagonals d = i + j holding an in-band cell; outside them every cell
    # is (H, E, F) = (0, NEG, NEG), the state the scan starts from
    inb = (hi > lo) & (lo < ly) & (hi > 0)
    if not bool(inb.any()):
        return best
    d_lo = int((ii + lo.clamp_min(0))[inb].min())
    d_hi = int((ii + hi.clamp_max(ly) - 1)[inb].max()) + 1
    xi = x.to(torch.int32)
    goe = GAP_OPEN + GAP_EXTEND
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg = torch.full((), NEG, dtype=torch.int32, device=dev)
    h1 = torch.zeros((B, lx), dtype=torch.int32, device=dev)  # diagonal d-1
    h2 = torch.zeros((B, lx), dtype=torch.int32, device=dev)  # diagonal d-2
    e = torch.full((B, lx), NEG, dtype=torch.int32, device=dev)
    f = torch.full((B, lx), NEG, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)

    def down(t, first):  # row i takes row i-1's value; row 0 the boundary
        return torch.cat([first, t[:, :-1]], dim=1)

    for d in range(d_lo, d_hi):
        jj = d - ii  # column of row i's cell on this diagonal
        band = (jj >= lo) & (jj < hi) & (jj >= 0) & (jj < ly)
        yj = y[:, jj.clamp(0, ly - 1)].to(torch.int32)
        s = torch.where(xi == yj, MATCH, MISMATCH)
        e = torch.maximum(h1 + goe, e + GAP_EXTEND)
        f = torch.maximum(down(h1, zero_col) + goe,
                          down(f, neg_col) + GAP_EXTEND)
        h = torch.clamp_min(torch.maximum(
            torch.maximum(down(h2, zero_col) + s, e), f), 0)
        h = torch.where(band, h, zero)
        e = torch.where(band, e, neg)
        f = torch.where(band, f, neg)
        best = torch.maximum(best, h.amax(dim=1))
        h2, h1 = h1, h
    return best


def banded_pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                       idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                       jlo: torch.Tensor, jhi: torch.Tensor) -> torch.Tensor:
    """Each read against its ref and alt haplotype rows -> int32 [2, R].
    reads: uint8 [R, lx] (pad 0); hap_mat: uint8 [H, ly] (pad 1); idx_ref,
    idx_alt: int32 [R]; jlo, jhi: int32 [lx, 2R], problem 2r the read's ref
    and 2r + 1 its alt."""
    idx = torch.stack([idx_ref, idx_alt], dim=1).reshape(-1).to(torch.int64)
    x = reads.repeat_interleave(2, dim=0)
    return banded_scores(x, hap_mat[idx], jlo, jhi).reshape(-1, 2).T


def banded_pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
                      idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                      jlo: torch.Tensor, jhi: torch.Tensor) -> torch.Tensor:
    """Fused call codes of each read's banded (ref, alt) scores -> int8
    [R] (0 dropped, 1 REF, 2 ALT, 3 tie)."""
    return calls_from_scores(
        banded_pair_scores(reads, hap_mat, idx_ref, idx_alt, jlo, jhi))
