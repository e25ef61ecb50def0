"""Plain PyTorch version of the Smith-Waterman pair kernel.

A column scan over the haplotype with the in-column F dependency in closed
form (counterpart of vartrix_tpu/ops/sw_xla.py:sw_scores_jax):

    F[i, j] = GE*i + max_{k<i}(Htmp[k, j] + GAP_OPEN - GE*k)

an exclusive running maximum (``torch.cummax``), exact because chaining F
through a second gap-open never beats extending the first gap.

Same entry points and output layouts as the CUDA kernel (ops/sw_cuda.py):
int32 scores [2, R], fused int8 call codes [R], dense, 2-bit or 4-bit
reads. It runs on whichever device its tensors are on; the CPU tests use
it, and the GPU smoke check holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..constants import GAP_EXTEND, GAP_OPEN, MATCH, MIN_SCORE, MISMATCH

NEG = -(1 << 28)

# 2-bit codes 0..3 -> ASCII, low bits first within each byte
# (gio_gather_padded_packed2)
PACK2_BASES = b"ACGT"
# 4-bit BAM nibble codes 0..15 -> ASCII, high nibble first within each
# byte (gio_gather_padded_packed)
SEQ_NT16 = b"=ACMGRSVTWYHKDBN"


def unpack2(xp: torch.Tensor, xlen: torch.Tensor, lx: int) -> torch.Tensor:
    """uint8 [R, lx//4] 2-bit codes + int32 [R] lengths -> uint8 [R, lx]
    ASCII bases, positions >= length set to the read pad byte 0."""
    pos = torch.arange(lx, device=xp.device)
    codes = (xp.to(torch.int32).repeat_interleave(4, dim=1)
             >> ((pos % 4) * 2)) & 3
    table = torch.tensor(list(PACK2_BASES), dtype=torch.uint8,
                         device=xp.device)
    x = table[codes]
    keep = pos[None, :] < xlen.to(torch.int64)[:, None]
    return torch.where(keep, x, torch.zeros((), dtype=torch.uint8,
                                            device=xp.device))


def unpack4(xp: torch.Tensor, xlen: torch.Tensor, lx: int,
            pad: int = 0) -> torch.Tensor:
    """uint8 [R, lx//2] 4-bit codes (high nibble first) + int32 [R]
    lengths -> uint8 [R, lx] SEQ_NT16 bytes, positions >= length set to
    `pad` (reads 0, haplotypes 1)."""
    R = xp.shape[0]
    codes = torch.stack([xp >> 4, xp & 15], dim=-1).reshape(R, lx)
    table = torch.tensor(list(SEQ_NT16), dtype=torch.uint8, device=xp.device)
    x = table[codes.to(torch.int64)]
    pos = torch.arange(lx, device=xp.device)
    keep = pos[None, :] < xlen.to(torch.int64)[:, None]
    return torch.where(keep, x, torch.full((), pad, dtype=torch.uint8,
                                           device=xp.device))


class PackedHaps:
    """A bucket's haplotype matrix in the 4-bit transfer form: `packed`
    uint8 [H, ly//2] nibbles and `lens` int32 [H], with the dense uint8
    [H, ly] matrix (pad byte 1) beside them. np.asarray gives the dense
    matrix, so a consumer that takes dense rows (the banded backend) keeps
    working; the full-SW backends ship `packed` and `lens` and unpack them
    on the device once per bucket (unpack4, pad 1)."""

    __slots__ = ("packed", "lens", "dense")

    def __init__(self, packed: np.ndarray, lens: np.ndarray,
                 dense: np.ndarray):
        self.packed = packed
        self.lens = lens
        self.dense = dense

    @property
    def shape(self):
        return self.dense.shape

    def __array__(self, dtype=None, copy=None):
        return self.dense if dtype is None else self.dense.astype(dtype)


def sw_scores(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """uint8 x [B, Lx] (pad 0), uint8 y [B, Ly] (pad 1) -> int32 [B] best
    local alignment scores."""
    B, lx = x.shape
    dev = x.device
    xi = x.to(torch.int32)
    yi = y.to(torch.int32)
    ii = torch.arange(lx, dtype=torch.int32, device=dev)[None, :]
    a_base = GAP_OPEN - GAP_EXTEND * ii
    H = torch.zeros((B, lx), dtype=torch.int32, device=dev)
    E = torch.full((B, lx), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for j in range(y.shape[1]):
        s = torch.where(xi == yi[:, j : j + 1], MATCH, MISMATCH)
        E = torch.maximum(H + (GAP_OPEN + GAP_EXTEND), E + GAP_EXTEND)
        h_diag = torch.cat([zero_col, H[:, :-1]], dim=1)
        h_tmp = torch.clamp_min(torch.maximum(h_diag + s, E), 0)
        cm = torch.cummax(h_tmp + a_base, dim=1).values
        F = torch.cat([neg_col, cm[:, :-1]], dim=1) + GAP_EXTEND * ii
        H = torch.maximum(h_tmp, F)
        best = torch.maximum(best, H.amax(dim=1))
    return best


READ_BITS = (2, 4)  # the packed read formats' code widths


def dense_reads(reads: torch.Tensor, read_lens: Optional[torch.Tensor],
                read_bits: int = 2) -> torch.Tensor:
    """uint8 [R, lx] reads (pad 0): `reads` itself without read_lens,
    else its read_bits-bit codes (READ_BITS) unpacked, lx = 8 x row bytes /
    read_bits."""
    if read_lens is None:
        return reads
    if read_bits not in READ_BITS:
        raise ValueError(f"read_bits must be one of {READ_BITS}, got "
                         f"{read_bits!r}")
    lx = 8 * reads.shape[1] // read_bits
    if read_bits == 2:
        return unpack2(reads, read_lens, lx)
    return unpack4(reads, read_lens, lx)


def pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                read_lens: Optional[torch.Tensor] = None,
                read_bits: int = 2) -> torch.Tensor:
    """Each read against its ref and alt haplotype rows -> int32 [2, R].
    reads: uint8 [R, lx] dense (pad 0), or with int32 read_lens [R] packed
    codes of read_bits bits: 2, [R, lx//4] A/C/G/T codes; 4, [R, lx//2]
    BAM nibble codes."""
    x = dense_reads(reads, read_lens, read_bits)
    idx = torch.stack([idx_ref, idx_alt]).to(torch.int64)
    xx = torch.cat([x, x])
    return sw_scores(xx, hap_mat[idx.reshape(-1)]).reshape(2, -1)


def calls_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """int32 [2, R] (ref, alt) -> int8 [R]: 0 when both are below
    MIN_SCORE, 1 if ref > alt, 2 if alt > ref, 3 on a tie."""
    ref, alt = scores[0], scores[1]
    code = torch.where(ref > alt, 1, torch.where(alt > ref, 2, 3))
    dropped = (ref < MIN_SCORE) & (alt < MIN_SCORE)
    return torch.where(dropped, 0, code).to(torch.int8)


def pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
               idx_ref: torch.Tensor, idx_alt: torch.Tensor,
               read_lens: Optional[torch.Tensor] = None,
               read_bits: int = 2) -> torch.Tensor:
    """Fused call codes of each read's (ref, alt) scores -> int8 [R].
    Arguments as pair_scores."""
    return calls_from_scores(
        pair_scores(reads, hap_mat, idx_ref, idx_alt, read_lens, read_bits))
