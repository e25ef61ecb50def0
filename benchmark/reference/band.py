"""The reference's band: rust-bio's chained k-mer band (k = 6, w = 20),
as VarTrix's banded aligner builds it (src/main.rs:898-901).

A frozen copy of the port's plain band builder (`ops/band_torch.py`:
`true_lengths`, `kmer_keys`, `band_bounds` and its chain DP, unchanged but
for the constants, which are stated here), which the repository's CPU
tests hold bit for bit to the JAX package's native band bounds and to the
host band reference `csrc/band_bounds.cpp`. The copy stays as it is when
the port changes: it is the yardstick.

Per problem, with the true lengths len_x (up to the read's last byte that
is not 0) and len_y (up to the haplotype's last byte that is not 1):
  * len_x or len_y 0: every row empty;
  * len_x or len_y < k: every read row gets [0, len_y);
  * else the matches (i, j), x[i:i+k] == y[j:j+k] as raw bytes, ordered
    by (i, j); none: every row empty. The chain DP visits the 64 matches
    before each match a (those with b.i >= a.i or b.j >= a.j skipped) and
    takes a predecessor only on a strictly greater score, so the nearest
    wins a tie; the chain ends at the first match of the strictly
    greatest score. The best chain's anchors widened by w, the boxes
    between consecutive anchors and the two corner diagonals give each
    row its interval, clamped to [0, len_x) x [0, len_y).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

MATCH = 1
GAP_OPEN = -5
GAP_EXTEND = -1
K = 6          # k-mer length of the seeds
W = 20         # half-width of the band around an anchor
MAX_PRED = 64  # matches before each match that the chain DP visits

_INT32_MAX = (1 << 31) - 1
_INT32_MIN = -(1 << 31)
# elements of one group's [problems, read k-mers, haplotype k-mers] mask
_GROUP_CELLS = {"cpu": 1 << 25, "cuda": 1 << 30}


def true_lengths(rows: torch.Tensor, pad: int) -> torch.Tensor:
    """int64 [B]: each row's length up to its last byte that is not pad."""
    B, n = rows.shape
    if n == 0:
        return torch.zeros(B, dtype=torch.int64, device=rows.device)
    pos = torch.arange(1, n + 1, device=rows.device)
    return ((rows != pad) * pos).amax(dim=1)


def kmer_keys(rows: torch.Tensor, lens: torch.Tensor,
              invalid: int) -> torch.Tensor:
    """int64 [B, n - K + 1]: the K bytes at each position packed into one
    key (byte t at bit 8t), `invalid` where the k-mer passes the row's
    true length."""
    B, n = rows.shape
    m = max(n - K + 1, 0)
    r = rows.to(torch.int64)
    key = torch.zeros((B, m), dtype=torch.int64, device=rows.device)
    for t in range(K):
        key |= r[:, t : t + m] << (8 * t)
    pos = torch.arange(m, device=rows.device)
    return torch.where(pos[None, :] + K <= lens[:, None], key, invalid)


@contextmanager
def _one_cpu_thread(device: torch.device):
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def band_bounds(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chained-band bounds of each read against its ref and alt haplotype
    rows. reads: uint8 [R, lx] (pad 0); hap_mat: uint8 [H, ly] (pad 1);
    idx_ref, idx_alt: int32 [R] rows of hap_mat. Returns (jlo, jhi), int32
    [lx, 2R]: column interval [jlo, jhi) of each read row, problem 2r the
    ref and 2r + 1 the alt of read r. Without idx_alt, int32 [lx, R]:
    problem r is read r against row idx_ref[r]."""
    with _one_cpu_thread(reads.device):
        return _band_bounds(reads, hap_mat, idx_ref, idx_alt)


def _band_bounds(reads, hap_mat, idx_ref, idx_alt):
    R, lx = reads.shape
    dev = reads.device
    per_read = 1 if idx_alt is None else 2
    P = per_read * R
    jlo = torch.zeros((P, lx), dtype=torch.int64, device=dev)
    jhi = torch.zeros((P, lx), dtype=torch.int64, device=dev)
    if P and lx:
        idx = (idx_ref.long() if idx_alt is None else
               torch.stack([idx_ref, idx_alt], dim=1).reshape(-1).long())
        read_len = true_lengths(reads, 0)
        hap_len = true_lengths(hap_mat, 1)
        len_x = read_len.repeat_interleave(per_read)
        len_y = hap_len[idx]
        some = (len_x > 0) & (len_y > 0)
        short = some & ((len_x < K) | (len_y < K))
        rows = torch.arange(lx, device=dev)
        jhi = torch.where(short[:, None] & (rows[None, :] < len_x[:, None]),
                          len_y[:, None], jhi)
        chained = torch.nonzero(some & ~short).flatten()
        if len(chained):
            read_keys = kmer_keys(reads, read_len, -1)
            hap_keys = kmer_keys(hap_mat, hap_len, -2)
            per = read_keys.shape[1] * hap_keys.shape[1]
            g = max(1, _GROUP_CELLS.get(dev.type, 1 << 25) // max(per, 1))
            for s in range(0, len(chained), g):
                p = chained[s : s + g]
                lo, hi = _chain_group(read_keys[p // per_read],
                                      hap_keys[idx[p]],
                                      len_x[p], len_y[p], lx)
                jlo[p], jhi[p] = lo, hi
    return (jlo.T.to(torch.int32).contiguous(),
            jhi.T.to(torch.int32).contiguous())


def _chain_group(kx: torch.Tensor, ky: torch.Tensor, len_x: torch.Tensor,
                 len_y: torch.Tensor, lx: int):
    """int64 (jlo, jhi) [g, lx] of g problems with both lengths >= K, from
    their read keys kx [g, nx] and haplotype keys ky [g, ny]."""
    dev = kx.device
    g = kx.shape[0]
    gp, mi, mj = torch.nonzero(kx[:, :, None] == ky[:, None, :],
                               as_tuple=True)  # ordered by (problem, i, j)
    counts = torch.bincount(gp, minlength=g)
    jlo = torch.zeros((g, lx), dtype=torch.int64, device=dev)
    jhi = torch.zeros_like(jlo)
    if len(gp) == 0:
        return jlo, jhi
    M = int(counts.max())
    rank = (torch.arange(len(gp), device=dev)
            - (torch.cumsum(counts, 0) - counts)[gp])
    # column MAX_PRED + a holds match a; the MAX_PRED columns before match
    # a are its candidate predecessors, b = a - 1 - off at column
    # a + MAX_PRED - 1 - off (I = -1: no match)
    I = torch.full((g, MAX_PRED + M), -1, dtype=torch.int64, device=dev)
    J = torch.full_like(I, -1)
    SC = torch.zeros_like(I)
    I[gp, MAX_PRED + rank] = mi
    J[gp, MAX_PRED + rank] = mj
    prev = torch.full((g, M), -1, dtype=torch.int64, device=dev)
    off = torch.arange(MAX_PRED, device=dev)
    start = K * MATCH
    for a in range(M):
        bi = I[:, a : a + MAX_PRED].flip(1)
        bj = J[:, a : a + MAX_PRED].flip(1)
        bs = SC[:, a : a + MAX_PRED].flip(1)
        ai = I[:, MAX_PRED + a, None]
        aj = J[:, MAX_PRED + a, None]
        di = ai - bi
        dj = aj - bj
        gap = (di - dj).abs()
        pen = torch.where(gap > 0, -(GAP_OPEN + gap * GAP_EXTEND), 0)
        overlap = (K - torch.minimum(di, dj)).clamp_min(0)
        sc = bs + (K - overlap) * MATCH - pen
        ok = (bi >= 0) & (bi < ai) & (bj < aj) & (sc > start)
        # greatest score, and among equal scores the nearest predecessor
        key = torch.where(ok, sc * MAX_PRED + (MAX_PRED - 1 - off), -1)
        best = key.amax(dim=1)
        take = best >= 0
        SC[:, MAX_PRED + a] = torch.where(take, best // MAX_PRED, start)
        prev[:, a] = torch.where(
            take, a - MAX_PRED + best % MAX_PRED, -1)
    # the chain ends at the first match of the strictly greatest score
    ar = torch.arange(M, device=dev)
    live = ar[None, :] < counts[:, None]
    end_key = torch.where(live, SC[:, MAX_PRED:] * (M + 1) + (M - ar), -1)
    end = M - end_key.amax(dim=1) % (M + 1)
    has = counts > 0
    rows = torch.arange(lx, device=dev)[None, :]
    lo = torch.full((g, lx), _INT32_MAX, dtype=torch.int64, device=dev)
    hi = torch.full((g, lx), _INT32_MIN, dtype=torch.int64, device=dev)
    lxp = len_x[:, None]
    lyp = len_y[:, None]

    def add_diag(on, i0, j0, length):
        t = rows - i0[:, None]
        m = (on[:, None] & (t >= -W) & (t < length[:, None] + W)
             & (rows < lxp))
        lo.copy_(torch.where(m, torch.minimum(
            lo, (j0[:, None] + t - W).clamp_min(0)), lo))
        hi.copy_(torch.where(m, torch.maximum(
            hi, torch.minimum(lyp, j0[:, None] + t + W + 1)), hi))

    def add_box(on, i0, i1, j0, j1):
        m = (on[:, None] & (rows >= i0.clamp_min(0)[:, None])
             & (rows < torch.minimum(i1[:, None], lxp)))
        lo.copy_(torch.where(m, torch.minimum(lo, j0.clamp_min(0)[:, None]),
                             lo))
        hi.copy_(torch.where(m, torch.maximum(hi, torch.minimum(
            lyp, j1[:, None])), hi))

    gi = torch.arange(g, device=dev)
    cur = torch.where(has, end, 0)
    back_i, back_j = I[gi, MAX_PRED + cur], J[gi, MAX_PRED + cur]
    front_i, front_j = back_i.clone(), back_j.clone()
    active = has.clone()
    six = torch.full((g,), K, dtype=torch.int64, device=dev)
    while bool(active.any()):
        ci, cj = I[gi, MAX_PRED + cur], J[gi, MAX_PRED + cur]
        add_diag(active, ci, cj, six)
        b = prev[gi, cur]
        step = active & (b >= 0)
        b = b.clamp_min(0)
        bi, bj = I[gi, MAX_PRED + b], J[gi, MAX_PRED + b]
        add_box(step, bi, ci + K, bj, cj + K)
        front_i = torch.where(active, ci, front_i)
        front_j = torch.where(active, cj, front_j)
        cur = torch.where(step, b, cur)
        active = step
    # corner extensions along the chain's end diagonals
    back = torch.minimum(front_i, front_j)
    add_diag(has, front_i - back, front_j - back, back)
    i1, j1 = back_i + K, back_j + K
    add_diag(has, i1, j1, torch.minimum(len_x - i1, len_y - j1))
    keep = (lo < hi) & has[:, None]
    return (torch.where(keep, lo, jlo), torch.where(keep, hi, jhi))
