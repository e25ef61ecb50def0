"""The benchmark's traffic generator: a seeded single-cell dataset (genome,
variants, barcodes and aligned reads) made in bulk with NumPy and held in
memory as columns.

A copy of the port's `utils/synth.generate_dataset` and `with_n_bases`
with the same distributions (reads drawn around each variant from
per-cell genotypes, sequencing errors, strand, duplicate, secondary and
supplementary flags, soft clips, spliced and deleting CIGARs, background
reads spread over the genome), with these changes:

  * every draw is one array call, so 1.4 M records take seconds, not
    minutes (sequencing errors: a Binomial count of positions, each set
    to a random base);
  * mapq is drawn as STAR writes it in a Cell Ranger BAM: 255 for a
    unique read, and 3, 1 or 0 for a multi-mapped one (a share
    `multimap_frac` of reads), where the copy drew 0-60 uniformly;
  * a share `n_read_frac` of reads (about 1 % on Illumina) carries one N;
  * barcodes are distinct, as in a whitelist (VarTrix drops a repeated
    barcode, which would shift every later column), and read names have
    a fixed width.

The same seed and parameters give the same dataset, bit for bit. The files
the program reads are written from these columns by an input kind
(inputs/bam.py); the plain reference (reference/) reads the columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
UMI_LEN = 10
BARCODE_LEN = 16

# CIGAR operation codes of the BAM format
OP_M, OP_D, OP_N, OP_S = 0, 2, 3, 4
REF_CONSUMING = (OP_M, OP_D, OP_N)

# STAR's MAPQ for a read with 2, 3-4 and 5+ loci, and the assumed share of
# multi-mapped reads at each
STAR_MULTI_MAPQ = np.array([3, 1, 0], dtype=np.uint8)
STAR_MULTI_SHARE = np.array([0.5, 0.3, 0.2])
STAR_UNIQUE_MAPQ = 255

DEFAULTS = dict(n_chroms=2, chrom_len=100_000, n_variants=100, n_cells=200,
                reads_per_variant=100, read_len=150, error_rate=0.005,
                indel_frac=0.1, max_indel=8, umi=True, background_reads=0,
                spliced_frac=0.04, n_read_frac=0.01, multimap_frac=0.08)


@dataclass
class Dataset:
    """A generated dataset. Records are in coordinate order, (tid, pos),
    ties in the order they were drawn."""

    params: dict
    chroms: List[str]
    genome: np.ndarray      # uint8 [n_chroms, chrom_len], ASCII A/C/G/T
    v_tid: np.ndarray       # int64 [V], variants sorted by (tid, pos)
    v_pos: np.ndarray       # int64 [V], 0-based
    v_ref: List[bytes]
    v_alt: List[bytes]
    barcodes: List[str]
    tid: np.ndarray         # int32 [N]
    pos: np.ndarray         # int64 [N], 0-based leftmost aligned base
    flag: np.ndarray        # uint16 [N]
    mapq: np.ndarray        # uint8 [N]
    cigar_ops: np.ndarray   # uint8 [N, 3], the first n_cigar are used
    cigar_lens: np.ndarray  # int64 [N, 3]
    n_cigar: np.ndarray     # int64 [N]
    seq: np.ndarray         # uint8 [N, read_len], ASCII A/C/G/T/N
    cell: np.ndarray        # int64 [N], index into barcodes (the CB tag)
    umi: np.ndarray         # uint8 [N, UMI_LEN] ASCII (the UB tag)
    qname_id: np.ndarray    # int64 [N], the draw order

    @property
    def n(self) -> int:
        return len(self.tid)

    @property
    def chrom_len(self) -> int:
        return int(self.genome.shape[1])

    def ref_span(self) -> np.ndarray:
        """int64 [N]: reference bases each record's CIGAR consumes."""
        used = np.arange(3)[None, :] < self.n_cigar[:, None]
        consumes = np.isin(self.cigar_ops, REF_CONSUMING) & used
        return (self.cigar_lens * consumes).sum(axis=1)

    def ref_end(self) -> np.ndarray:
        """int64 [N]: one past the last reference base (at least pos + 1)."""
        return self.pos + np.maximum(self.ref_span(), 1)


def _params(p: dict) -> dict:
    unknown = set(p) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown generator parameters: {sorted(unknown)}")
    out = {**DEFAULTS, **p}
    if out["read_len"] <= 60:
        raise ValueError("read_len must exceed 60 (spliced and deleting "
                         "CIGARs split a read 20 bases from its ends)")
    return out


def _variants(rng, p, genome):
    L, mi = p["read_len"], p["max_indel"]
    spacing = 2 * L + L // 2 + 2 * mi
    margin = L + mi
    per_chrom = np.arange(margin, p["chrom_len"] - margin - spacing, spacing)
    slots_c = np.repeat(np.arange(p["n_chroms"]), len(per_chrom))
    slots_p = np.tile(per_chrom, p["n_chroms"])
    V = p["n_variants"]
    if len(slots_c) < V:
        raise ValueError(f"genome too small for {V} variants "
                         f"({len(slots_c)} slots)")
    pick = rng.permutation(len(slots_c))[:V]
    ci = slots_c[pick].astype(np.int64)
    pos = slots_p[pick] + rng.integers(0, L // 2, V)
    kind = rng.random(V)
    snv_shift = rng.integers(1, 4, V)
    del_len = rng.integers(1, mi + 1, V)
    ins_len = rng.integers(1, mi + 1, V)
    ins_bases = BASES[rng.integers(0, 4, (V, mi))]
    base_idx = np.zeros(256, np.int64)
    base_idx[BASES] = np.arange(4)
    refs, alts = [], []
    snv_cut = 1 - p["indel_frac"]
    del_cut = 1 - p["indel_frac"] / 2
    for k in range(V):
        g, s = genome[ci[k]], int(pos[k])
        if kind[k] < snv_cut:
            ref = g[s : s + 1].tobytes()
            alt = bytes([BASES[(base_idx[g[s]] + snv_shift[k]) % 4]])
        elif kind[k] < del_cut:
            ref = g[s : s + del_len[k] + 1].tobytes()
            alt = ref[:1]
        else:
            ref = g[s : s + 1].tobytes()
            alt = ref + ins_bases[k, : ins_len[k]].tobytes()
        refs.append(ref)
        alts.append(alt)
    order = np.lexsort((pos, ci))
    return (ci[order], pos[order].astype(np.int64),
            [refs[k] for k in order], [alts[k] for k in order])


def _segments(genome, v_tid, v_pos, v_ref, v_alt, L, mi):
    """uint8 [V, S] reference and alternate segments around each variant
    (from pos - L - mi to L + mi past the allele), padded with 0."""
    V = len(v_tid)
    lens_r = [2 * (L + mi) + len(r) for r in v_ref]
    lens_a = [2 * (L + mi) + len(a) for a in v_alt]
    S = max(lens_r + lens_a)
    seg_r = np.zeros((V, S), np.uint8)
    seg_a = np.zeros((V, S), np.uint8)
    for k in range(V):
        g = genome[v_tid[k]]
        s = int(v_pos[k])
        lo, e = s - L - mi, s + len(v_ref[k])
        seg_r[k, : lens_r[k]] = g[lo : e + L + mi]
        seg_a[k, : lens_a[k]] = np.concatenate(
            [g[lo:s], np.frombuffer(v_alt[k], np.uint8), g[e : e + L + mi]])
    return seg_r, seg_a


def _gather_rows(src, row, start, L, block=1 << 16):
    """uint8 [n, L]: src[row[k], start[k] : start[k] + L], in blocks."""
    out = np.empty((len(row), L), np.uint8)
    cols = np.arange(L)
    for b in range(0, len(row), block):
        e = b + block
        out[b:e] = src[row[b:e, None], start[b:e, None] + cols]
    return out


def _barcodes(rng, n):
    """n distinct 16-base barcodes with 10x's "-1" suffix, in draw order
    (a whitelist holds each barcode once)."""
    codes = rng.integers(0, 4 ** BARCODE_LEN, 2 * n + 16)
    _, first = np.unique(codes, return_index=True)
    codes = codes[np.sort(first)[:n]]
    if len(codes) < n:
        raise ValueError("barcode draw collided too often")
    shifts = 2 * np.arange(BARCODE_LEN - 1, -1, -1)
    bases = BASES[(codes[:, None] >> shifts) & 3]
    return [b.tobytes().decode() + "-1" for b in bases]


def _mapq(rng, n, share):
    multi = rng.random(n) < share
    which = rng.choice(len(STAR_MULTI_MAPQ), n, p=STAR_MULTI_SHARE)
    return np.where(multi, STAR_MULTI_MAPQ[which],
                    STAR_UNIQUE_MAPQ).astype(np.uint8)


def _errors(rng, seq, rate):
    """Sets a Binomial(n * L, rate) number of positions to a random base
    (which may equal the old one, as in the copy)."""
    n_err = int(rng.binomial(seq.size, rate))
    where = rng.integers(0, seq.size, n_err)
    seq.reshape(-1)[where] = BASES[rng.integers(0, 4, n_err)]


def generate(params: dict, seed: int) -> Dataset:
    """The dataset of `params` (keys of DEFAULTS) drawn from `seed`."""
    p = _params(params)
    rng = np.random.default_rng(seed)
    L, mi, C = p["read_len"], p["max_indel"], p["n_cells"]
    chroms = [f"chr{i + 1}" for i in range(p["n_chroms"])]
    genome = BASES[rng.integers(0, 4, (p["n_chroms"], p["chrom_len"]))]
    v_tid, v_pos, v_ref, v_alt = _variants(rng, p, genome)
    V = len(v_tid)

    barcodes = _barcodes(rng, C)
    genotypes = rng.integers(0, 3, (V, C))

    # reads around the variants
    R = p["reads_per_variant"]
    n1 = V * R
    v_of = np.repeat(np.arange(V), R)
    cell1 = rng.integers(0, C, n1)
    alt_p = np.array([0.0, 0.5, 1.0])[genotypes[v_of, cell1]]
    is_alt = rng.random(n1) < alt_p
    start = rng.integers(mi + 1, L + mi + 1, n1)  # overlaps the allele
    seg_r, seg_a = _segments(genome, v_tid, v_pos, v_ref, v_alt, L, mi)
    seq1 = _gather_rows(seg_r, v_of, start, L)
    alt_rows = np.nonzero(is_alt)[0]
    seq1[alt_rows] = _gather_rows(seg_a, v_of[alt_rows], start[alt_rows], L)
    _errors(rng, seq1, p["error_rate"])
    pos1 = v_pos[v_of] - L - mi + start
    flag1 = np.where(rng.random(n1) < 0.5, 16, 0).astype(np.uint16)
    r2 = rng.random(n1)
    flag1 |= np.select([r2 < 0.05, r2 < 0.08, r2 < 0.10],
                       [0x400, 0x100, 0x800], 0).astype(np.uint16)
    r3 = rng.random(n1)
    clip = rng.integers(5, 20, n1)
    split = rng.integers(20, L - 20, n1)
    skip = rng.integers(10, 50, n1)
    dels = rng.integers(1, 6, n1)
    sf = p["spliced_frac"]
    kind = np.select([r3 < 0.06, r3 < 0.06 + sf, r3 < 0.10 + sf],
                     [1, 2, 3], 0)
    ops1 = np.zeros((n1, 3), np.uint8)
    lens1 = np.zeros((n1, 3), np.int64)
    ncig1 = np.ones(n1, np.int64)
    lens1[:, 0] = L
    k = kind == 1  # leading soft clip
    ops1[k, 0], ops1[k, 1] = OP_S, OP_M
    lens1[k, 0], lens1[k, 1] = clip[k], L - clip[k]
    ncig1[k] = 2
    pos1 = pos1 + np.where(k, clip, 0)
    for kk, op, gap in ((2, OP_N, skip), (3, OP_D, dels)):
        k = kind == kk
        ops1[k] = (OP_M, op, OP_M)
        lens1[k, 0], lens1[k, 1], lens1[k, 2] = split[k], gap[k], L - split[k]
        ncig1[k] = 3
    umi1 = BASES[rng.integers(0, 4, (n1, UMI_LEN))]
    mapq1 = _mapq(rng, n1, p["multimap_frac"])

    # background reads spread over the genome
    n2 = p["background_reads"]
    tid2 = rng.integers(0, p["n_chroms"], n2)
    pos2 = rng.integers(0, p["chrom_len"] - L, n2)
    seq2 = _gather_rows(genome, tid2, pos2, L)
    _errors(rng, seq2, p["error_rate"])
    cell2 = rng.integers(0, C, n2)
    umi2 = BASES[rng.integers(0, 4, (n2, UMI_LEN))]
    flag2 = np.where(rng.random(n2) < 0.5, 16, 0).astype(np.uint16)
    mapq2 = _mapq(rng, n2, p["multimap_frac"])
    ops2 = np.zeros((n2, 3), np.uint8)
    lens2 = np.zeros((n2, 3), np.int64)
    lens2[:, 0] = L

    seq = np.concatenate([seq1, seq2])
    n = len(seq)
    with_n = np.nonzero(rng.random(n) < p["n_read_frac"])[0]
    seq[with_n, rng.integers(0, L, n)[with_n]] = ord("N")

    tid = np.concatenate([v_tid[v_of], tid2]).astype(np.int32)
    pos = np.concatenate([pos1, pos2]).astype(np.int64)
    order = np.lexsort((pos, tid))
    umi = (np.concatenate([umi1, umi2]) if p["umi"]
           else np.zeros((n, 0), np.uint8))
    return Dataset(
        params=p, chroms=chroms, genome=genome, v_tid=v_tid, v_pos=v_pos,
        v_ref=v_ref, v_alt=v_alt, barcodes=barcodes,
        tid=tid[order], pos=pos[order],
        flag=np.concatenate([flag1, flag2])[order],
        mapq=np.concatenate([mapq1, mapq2])[order],
        cigar_ops=np.concatenate([ops1, ops2])[order],
        cigar_lens=np.concatenate([lens1, lens2])[order],
        n_cigar=np.concatenate([ncig1, np.ones(n2, np.int64)])[order],
        seq=seq[order],
        cell=np.concatenate([cell1, cell2]).astype(np.int64)[order],
        umi=umi[order], qname_id=order.astype(np.int64))
