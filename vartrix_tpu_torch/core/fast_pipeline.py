"""Vectorized host pipeline over the native columnar BAM decode, and the
scoring of every (read, haplotype) pair through the backend.

All per-read work is NumPy array operations over libgenomio's
structure-of-arrays buffers:

  * read<->variant join: searchsorted over coordinate-sorted positions
    with a max-span lower bound;
  * the 6-stage filter chain as boolean masks, with metrics counted in
    the reference's order (reference src/main.rs:829-894);
  * "useful" overlap: single-interval reads (no N in CIGAR) are useful
    iff they pass the htslib fetch overlap (proof: interval = [pos,
    ref_end), and pos < end => pos < end+1), so only multi-interval and
    empty-CIGAR reads need the interval walk;
  * scoring batches: reads bucketed by quantized (read, haplotype) widths,
    gathered from the decoded sequence pool chunk by chunk.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..io.bam_native import (ColumnarBam, gather_padded,
                             gather_padded_packed, gather_padded_packed2)
from ..ops.sw_torch import PackedHaps
from ..utils import trace
from ..utils.metrics import Metrics
from .pipeline import PipelineArgs, VariantWork

FLAG_SECSUP = 0x900
FLAG_DUP = 0x400


def _multi_interval_useful(cbam: ColumnarBam, idx: np.ndarray,
                           starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Interval test for reads whose aligned span is split by N, vectorized
    across all (candidate, interval) pairs: flatten every candidate's
    aligned-reference intervals, test overlap against the candidate's
    variant window ([start, end] INCLUSIVE, src/main.rs:794), and reduce
    per candidate with a bincount. Real 10x scRNA data is dominated by
    spliced (N-containing) reads, so this path must scale like the rest of
    the filter chain."""
    a = cbam.itv_off[idx].astype(np.int64)
    cnt = (cbam.itv_off[idx + 1] - cbam.itv_off[idx]).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(len(idx), dtype=bool)
    owner = np.repeat(np.arange(len(idx), dtype=np.int64), cnt)
    cum = np.cumsum(cnt) - cnt
    flat = np.arange(total, dtype=np.int64) - np.repeat(cum, cnt) + np.repeat(a, cnt)
    iv_beg = cbam.itv_pool[flat * 2].astype(np.int64)
    iv_end = cbam.itv_pool[flat * 2 + 1].astype(np.int64)
    hit = (iv_beg <= ends[owner]) & (iv_end > starts[owner])
    return np.bincount(owner[hit], minlength=len(idx)) > 0


def collect_reads_fast(
    cbam: ColumnarBam,
    works: List[VariantWork],
    cell_barcodes: Dict[bytes, int],
    args: PipelineArgs,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Fill per-variant metrics and return per-variant (read_idx, cells,
    umis) arrays for surviving reads.

    Fully vectorized ACROSS variants: candidate ranges come from two
    searchsorted calls over a composite (tid, pos) sort key, the flat
    (variant, read) candidate list is materialized with repeat/cumsum
    indexing, the filter chain runs as boolean masks over that flat list,
    and per-variant metrics are bincounts. Scales to 100k+ variants
    without per-variant Python work."""
    n = cbam.n
    V = len(works)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int64))
    act = [i for i, w in enumerate(works) if not w.skipped]
    if n == 0 or not act:
        return ([empty[0]] * V, [empty[1]] * V, [empty[2]] * V)

    # stable coordinate order (coordinate-sorted files keep their order)
    order = np.lexsort((cbam.pos[:n], cbam.tid[:n]))
    tid_s = cbam.tid[order].astype(np.int64)
    pos_s = cbam.pos[order].astype(np.int64)
    key_s = (tid_s << 34) | (pos_s + (1 << 32))  # pos may be small/0

    cb_idx = cbam.cb_indices(cell_barcodes)
    ub_id = cbam.ub_ids() if args.use_umi else None
    n_itv = np.diff(cbam.itv_off)
    max_span = int((cbam.ref_end[:n] - cbam.pos[:n]).max())

    tid_map = cbam.tid_by_name
    v_tid = np.fromiter(
        (tid_map.get(works[i].locus.chrom, -1) for i in act), np.int64,
        count=len(act))
    if (v_tid < 0).any():
        bad = works[act[int(np.argmax(v_tid < 0))]].locus.chrom
        raise KeyError(f"chromosome {bad} not in BAM header")
    v_start = np.fromiter((works[i].locus.start for i in act), np.int64,
                          count=len(act))
    v_end = np.fromiter((works[i].locus.end for i in act), np.int64,
                        count=len(act))

    lo = np.searchsorted(key_s, (v_tid << 34) | (v_start - max_span + (1 << 32)),
                         side="left")
    hi = np.searchsorted(key_s, (v_tid << 34) | (v_end + (1 << 32)), side="left")
    counts = hi - lo
    total = int(counts.sum())
    var_of = np.repeat(np.arange(len(act)), counts)
    cum = np.zeros(len(act) + 1, np.int64)
    np.cumsum(counts, out=cum[1:])
    flat = (np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], counts)
            + np.repeat(lo, counts))
    cand = order[flat]
    starts_f = v_start[var_of]
    ends_f = v_end[var_of]

    def count_per_var(mask):
        return np.bincount(var_of[mask], minlength=len(act)).astype(np.int64)

    # htslib fetch overlap: pos < end (by the hi bound) and ref_end > start
    alive = cbam.ref_end[cand] > starts_f
    num_reads = count_per_var(alive)

    drop = alive & (cbam.mapq[cand] < args.mapq)
    num_low_mapq = count_per_var(drop)
    alive &= ~drop

    num_non_primary = np.zeros(len(act), np.int64)
    if args.primary:
        drop = alive & ((cbam.flag[cand] & FLAG_SECSUP) != 0)
        num_non_primary = count_per_var(drop)
        alive &= ~drop
    num_duplicates = np.zeros(len(act), np.int64)
    if args.duplicates:
        drop = alive & ((cbam.flag[cand] & FLAG_DUP) != 0)
        num_duplicates = count_per_var(drop)
        alive &= ~drop

    ni = n_itv[cand]
    useful = ni == 1  # single aligned interval == fetch overlap window
    multi = np.nonzero(alive & (ni > 1))[0]
    if len(multi):
        useful[multi] = _multi_interval_useful(
            cbam, cand[multi], starts_f[multi], ends_f[multi])
    drop = alive & ~useful
    num_not_useful = count_per_var(drop)
    alive &= useful

    cells_f = cb_idx[cand]
    drop = alive & (cells_f < 0)
    num_not_cell_bc = count_per_var(drop)
    alive &= ~drop

    num_non_umi = np.zeros(len(act), np.int64)
    if args.use_umi:
        umis_f = ub_id[cand]
        drop = alive & (umis_f < 0)
        num_non_umi = count_per_var(drop)
        alive &= ~drop
    else:
        umis_f = np.ones(total, dtype=np.int64)

    # per-variant metrics write-back: .tolist() batches the numpy-scalar
    # conversions and fresh Metrics are constructed directly (the +=
    # attribute walk per variant was ~0.2s at 100k variants); a second
    # collect over the same works (tests do this) still accumulates
    for i, nr, lm, npr, dup, ncb, nu, nn in zip(
            act, num_reads.tolist(), num_low_mapq.tolist(),
            num_non_primary.tolist(), num_duplicates.tolist(),
            num_not_cell_bc.tolist(), num_not_useful.tolist(),
            num_non_umi.tolist()):
        w = works[i]
        m = w._metrics
        if m is None:
            w._metrics = Metrics(num_reads=nr, num_low_mapq=lm,
                                 num_non_primary=npr, num_duplicates=dup,
                                 num_not_cell_bc=ncb, num_not_useful=nu,
                                 num_non_umi=nn)
        else:
            m.num_reads += nr
            m.num_low_mapq += lm
            m.num_non_primary += npr
            m.num_duplicates += dup
            m.num_not_cell_bc += ncb
            m.num_not_useful += nu
            m.num_non_umi += nn

    # split survivors back per variant (flat list is var-major, pos-sorted)
    sel = np.nonzero(alive)[0]
    surv_var = var_of[sel]
    surv_cand = cand[sel]
    surv_cells = cells_f[sel].astype(np.int32)
    surv_umis = umis_f[sel]
    bounds = np.searchsorted(surv_var, np.arange(len(act) + 1)).tolist()

    read_idx_out = [empty[0]] * V
    cells_out = [empty[1]] * V
    umis_out = [empty[2]] * V
    for k, i in enumerate(act):
        a, b = bounds[k], bounds[k + 1]
        read_idx_out[i] = surv_cand[a:b]
        cells_out[i] = surv_cells[a:b]
        umis_out[i] = surv_umis[a:b]
    return read_idx_out, cells_out, umis_out


def _read_provider(cbam: ColumnarBam, rows: np.ndarray, lx: int):
    """Read source for one shape bucket: a chunk callable `(start, n) ->
    uint8 [n, lx]` with `.shape == (len(rows), lx)`, `.packed2(start, n)`,
    the 2-bit A/C/G/T gather, and `.packed(start, n)`, the 4-bit gather of
    BAM's 16 symbols (each None when a chunk holds another byte), so the
    backend gathers chunks ahead of the device and the bucket never
    materializes whole."""

    def x(start, n):
        return gather_reads(cbam, rows[start : start + n], lx)

    def packed(start, n):
        return gather_padded_packed(cbam.seq_pool, cbam.seq_off,
                                    rows[start : start + n], lx)

    def packed2(start, n):
        return gather_padded_packed2(cbam.seq_pool, cbam.seq_off,
                                     rows[start : start + n], lx)

    x.shape = (len(rows), lx)
    x.packed = packed
    x.packed2 = packed2
    return x


def gather_reads(cbam: ColumnarBam, read_ids: np.ndarray, lx: int) -> np.ndarray:
    """[B, lx] uint8 read matrix (pad byte 0) gathered from the seq pool."""
    return gather_padded(cbam.seq_pool, cbam.seq_off, read_ids, lx)


def _score_all_pairs(
    cbam: ColumnarBam,
    works: List[VariantWork],
    read_idx: List[np.ndarray],
    pair_fn,
    lx_quantum: int = 16,
    ly_quantum: int = 32,
) -> List[np.ndarray]:
    """Read-pair scoring: one task per (variant, read) carrying BOTH
    haplotype indices, so each read is gathered and shipped once and the
    device scores it against ref and alt. Empty haplotypes map to an
    all-pad row, which scores 0 exactly like the empty-sequence
    convention. pair_fn returns ONE int8 call code per read (0/1/2/3);
    results are per-variant [n] int8 arrays."""
    results = [np.zeros(len(r), dtype=np.int8) for r in read_idx]
    with trace.span("vartrix::score.prep"):
        prep = _pair_tasks(cbam, works, read_idx, lx_quantum, ly_quantum)
    if prep is None:
        return results
    t_read, t_var, blocks, keys, hap_pool, hap_off = prep
    flat = np.zeros(len(t_read), dtype=np.int8)
    for key in np.unique(keys):
        trace.count("score.buckets")
        with trace.span("vartrix::score.bucket"):
            sel = np.nonzero(keys == key)[0]
            lx = int(key >> 32)
            ly = int(key & 0xFFFFFFFF)
            with trace.span("vartrix::score.haps"):
                uniq_v, v_inv = np.unique(t_var[sel], return_inverse=True)
                hap_ids = np.empty(2 * len(uniq_v), np.int64)
                hap_ids[0::2] = 2 * uniq_v
                hap_ids[1::2] = 2 * uniq_v + 1
                hap_mat = _gather_padded_pool(hap_pool, hap_off, hap_ids, ly,
                                              pad_byte=1)
                hap_mat = _maybe_pack_haps(hap_pool, hap_off, hap_ids, ly,
                                           hap_mat)
            x = _read_provider(cbam, t_read[sel], lx)
            idx_ref = (2 * v_inv).astype(np.int32)
            idx_alt = (2 * v_inv + 1).astype(np.int32)
            flat[sel] = np.asarray(pair_fn(x, hap_mat, idx_ref, idx_alt),
                                   dtype=np.int8)
    for wi, start, count in blocks:
        results[wi][...] = flat[start : start + count]
    return results


def _pair_tasks(cbam: ColumnarBam, works: List[VariantWork],
                read_idx: List[np.ndarray], lx_quantum: int,
                ly_quantum: int):
    """The flat task list of _score_all_pairs: (each task's read and
    variant, the (variant, flat start, count) blocks, each task's shape
    bucket key, the haplotype pool and its offsets), or None without
    tasks."""
    t_read_l, blocks = [], []   # (variant, flat_start, count)
    cursor = 0
    act = []
    for wi, rids in enumerate(read_idx):
        if len(rids) == 0:
            continue
        t_read_l.append(rids)
        blocks.append((wi, cursor, len(rids)))
        act.append(wi)
        cursor += len(rids)
    if not t_read_l:
        return None
    t_read = np.concatenate(t_read_l)
    t_var = np.repeat(np.array(act, np.int64),
                      [len(read_idx[i]) for i in act])

    def q(v, quantum):
        return np.maximum(quantum, -(-v // quantum) * quantum)

    hap_len = np.array([max(len(w.rref), len(w.alt_hap)) for w in works],
                       dtype=np.int64)
    seq_lens = (cbam.seq_off[t_read + 1] - cbam.seq_off[t_read]).astype(np.int64)
    qlx = q(seq_lens, lx_quantum)
    qly = q(hap_len[t_var], ly_quantum)

    # one flat haplotype pool (row 2v = rref, 2v+1 = alt_hap); per-bucket
    # matrices come from a single padded gather — no per-variant Python in
    # the scoring path
    hap_pool = np.frombuffer(
        b"".join(b for w in works for b in (w.rref, w.alt_hap)), np.uint8)
    hap_off = np.zeros(2 * len(works) + 1, np.int64)
    np.cumsum([len(b) for w in works for b in (w.rref, w.alt_hap)],
              out=hap_off[1:])
    keys = qlx * (1 << 32) + qly
    return t_read, t_var, blocks, keys, hap_pool, hap_off


def _maybe_pack_haps(hap_pool: np.ndarray, hap_off: np.ndarray,
                     hap_ids: np.ndarray, ly: int, hap_mat: np.ndarray):
    """The bucket's haplotype matrix as a PackedHaps (4-bit rows and
    lengths beside the dense matrix) when ly is even and every haplotype
    byte lies in BAM's 16 symbols; else the dense matrix itself (a
    lowercase soft-masked base declines the whole bucket)."""
    got = gather_padded_packed(hap_pool, hap_off, hap_ids, ly)
    if got is None:
        return hap_mat
    return PackedHaps(got[0], got[1], hap_mat)


def _gather_padded_pool(pool: np.ndarray, off: np.ndarray, ids: np.ndarray,
                        width: int, pad_byte: int) -> np.ndarray:
    """[n, width] uint8 gather from a flat var-length pool; rows truncated
    or padded with pad_byte (gathered with pad 0, then patched: sequences
    never contain byte 0)."""
    out = gather_padded(pool, off, ids, width)
    if pad_byte:
        out[out == 0] = pad_byte
    return out


def score_all_fast(
    cbam: ColumnarBam,
    works: List[VariantWork],
    read_idx: List[np.ndarray],
    backend,
    lx_quantum: int = 16,
    ly_quantum: int = 32,
) -> List[np.ndarray]:
    """Score every (read, ref_hap) and (read, alt_hap) pair, bucketed by
    quantized shapes, through the backend's fused score->call route
    (`backend.pair_calls_chained`); returns per-variant [n] int8 call
    codes, which the aggregation consumes."""
    return _score_all_pairs(cbam, works, read_idx,
                            backend.pair_calls_chained, lx_quantum,
                            ly_quantum)
