"""The plain reference: VarTrix's result on a generated dataset, worked out
from the generator's columns (inputs/synth.Dataset) without the program.

It follows upstream VarTrix (10x Genomics, src/main.rs) step by step:

  * haplotypes (src/main.rs:936-994): ref = genome[start - padding,
    end + padding) clamped to the chromosome; alt = genome[start -
    padding, start) + ALT + genome[end, end + padding); a record whose
    haplotypes hold a byte outside --valid-chars' default, or that has
    more than one ALT, is skipped;
  * reads of a variant (src/main.rs:829-894): the records that overlap
    [start, end) as htslib's fetch does (pos < end and ref_end > start),
    then mapq >= --mapq, a useful alignment (an M or D block of the CIGAR on a reference base in
    [start, end], inclusive), a CB tag in the barcode list (indices in
    first-seen order), and with --umi a UB tag;
  * scores: each read against the ref and the alt haplotype, full
    Smith-Waterman or rust-bio's banded aligner (reference/sw.py,
    reference/band.py); a call per read (src/main.rs:1019-1030): both
    scores under 25, no call; ref > alt REF; alt > ref ALT; a tie UNKNOWN;
  * per (variant, cell) (src/main.rs:1032-1164): with --umi the calls of
    each UMI collapse to ALT when ALT is at least 0.75 of them, else REF
    when REF is, else UNKNOWN; then the cell's counts. A cell with a read
    that passed the filters has an entry even if no read was called.
    consensus: 3 with REF and ALT, 2 with ALT, 1 with REF, else none;
    coverage: the ALT count (matrix) and REF count (ref matrix), zeros
    kept.

Only what the configurations ask for is here: --primary-alignments,
--no-duplicates, another --valid-chars and alt_frac are not.

Everything runs over arrays (the scores in PyTorch on `device`, in blocks
of pairs); nothing of the program is imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import band, sw

MIN_SCORE = 25
VALID_CHARS = b"ATGCatgc"  # --valid-chars' default
OP_M, OP_D, OP_N, OP_EQ, OP_X = 0, 2, 3, 7, 8
READ_PAD, HAP_PAD = 0, 1


@dataclass
class Semantics:
    """What a configuration asks of VarTrix (its command-line flags)."""

    scoring_method: str = "consensus"
    umi: bool = False
    mapq: int = 0
    padding: int = 100
    sw_mode: str = "full"

    def argv(self) -> list:
        return (["-s", self.scoring_method, "--mapq", str(self.mapq),
                 "--padding", str(self.padding), "--sw-mode", self.sw_mode]
                + (["--umi"] if self.umi else []))


def haplotypes(ds, sem: Semantics):
    """(ref haplotypes, alt haplotypes, skipped) per variant."""
    valid = set(VALID_CHARS)
    refs, alts, skipped = [], [], []
    clen = ds.chrom_len
    for t, s, r, a in zip(ds.v_tid.tolist(), ds.v_pos.tolist(), ds.v_ref,
                          ds.v_alt):
        g = ds.genome[t]
        e = s + len(r)
        lo, hi = max(0, s - sem.padding), min(e + sem.padding, clen)
        rref = g[lo:hi].tobytes()
        alt = g[lo:s].tobytes() + a + g[e:hi].tobytes()
        bad = b"," in a or not set(alt) <= valid
        refs.append(rref)
        alts.append(alt)
        skipped.append(bad)
    return refs, alts, np.array(skipped, bool)


def read_pairs(ds, sem: Semantics, skipped: np.ndarray):
    """(variant, record) index pairs whose read survives the filters, in
    (variant, record) order."""
    ends = ds.ref_end()
    v_start = ds.v_pos
    v_end = ds.v_pos + np.array([len(r) for r in ds.v_ref], np.int64)
    max_span = int((v_end - v_start).max()) if len(v_end) else 1
    off = 1 << 33

    def key(t, p):
        return (t.astype(np.int64) << 36) | (p + off)

    vkey = key(ds.v_tid, v_start)
    lo = np.searchsorted(vkey, key(ds.tid, ds.pos - max_span + 1), "left")
    hi = np.searchsorted(vkey, key(ds.tid, ends), "left")
    cnt = hi - lo
    rec = np.repeat(np.arange(ds.n), cnt)
    var = (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
           + np.repeat(lo, cnt))
    # the htslib fetch overlap and live variants
    keep = (v_end[var] > ds.pos[rec]) & ~skipped[var]
    keep &= ds.mapq[rec] >= sem.mapq
    var, rec = var[keep], rec[keep]
    # a useful alignment: an M/D block on a base of [start, end]
    ops = ds.cigar_ops[rec]
    lens = ds.cigar_lens[rec]
    used = np.arange(ops.shape[1])[None, :] < ds.n_cigar[rec][:, None]
    consumes = np.isin(ops, (OP_M, OP_D, OP_N, OP_EQ, OP_X)) & used
    step = np.where(consumes, lens, 0)
    beg = ds.pos[rec][:, None] + np.cumsum(step, axis=1) - step
    block = np.isin(ops, (OP_M, OP_D, OP_EQ, OP_X)) & used
    hit = (block & (beg <= v_end[var][:, None])
           & (beg + lens > v_start[var][:, None]))
    keep = hit.any(axis=1)
    var, rec = var[keep], rec[keep]
    order = np.lexsort((rec, var))
    return var[order], rec[order]


def cell_index(ds) -> np.ndarray:
    """The barcode list's index of each record's CB tag: first-seen
    order, duplicates dropped (src/main.rs:697-735); -1 when the tag is
    not in the list."""
    first: Dict[str, int] = {}
    for bc in ds.barcodes:
        first.setdefault(bc, len(first))
    of_cell = np.array([first[bc] for bc in ds.barcodes], np.int64)
    return of_cell[ds.cell]


def _rows(mat_list, pad):
    """uint8 [n, width] of byte strings, padded with pad."""
    width = max((len(b) for b in mat_list), default=0)
    out = np.full((len(mat_list), max(width, 1)), pad, np.uint8)
    for k, b in enumerate(mat_list):
        out[k, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def score_pairs(ds, var, rec, refs, alts, sw_mode: str, device: str,
                bits: Optional[int] = None, block: int = 1 << 17):
    """int32 (ref scores, alt scores) of each (variant, record) pair, and
    the work the scores needed: {"pairs", "read_bases", "hap_bases",
    "cells"}: cells are read length x haplotype length over both
    haplotypes (full), or the cells of the band (banded)."""
    dev = torch.device(device)
    haps = _rows([h for pair in zip(refs, alts) for h in pair], HAP_PAD)
    hap_t = torch.from_numpy(haps).to(dev)
    hap_len = np.array([len(h) for pair in zip(refs, alts) for h in pair],
                       np.int64)
    read_len = ds.seq.shape[1]
    n = len(var)
    ref_s = np.zeros(n, np.int32)
    alt_s = np.zeros(n, np.int32)
    cells = 0
    for b in range(0, n, block):
        v = var[b : b + block]
        x = torch.from_numpy(ds.seq[rec[b : b + block]]).to(dev)
        idx = torch.from_numpy(np.stack([2 * v, 2 * v + 1], 1).reshape(-1)
                               ).to(dev)
        xx = x.repeat_interleave(2, dim=0)
        yy = hap_t[idx]
        if sw_mode == "full":
            got = sw.scores(xx, yy, bits)
            cells += int(read_len * (hap_len[2 * v] + hap_len[2 * v + 1]).sum())
        else:
            jlo, jhi = band.band_bounds(
                x, hap_t, torch.from_numpy(2 * v).to(dev).int(),
                torch.from_numpy(2 * v + 1).to(dev).int())
            jlo, jhi = jlo.T, jhi.T
            got = sw.banded_scores(xx, yy, jlo, jhi, bits)
            cells += int((jhi - jlo).clamp_min(0).sum())
        got = got.reshape(-1, 2).cpu().numpy()
        ref_s[b : b + block] = got[:, 0]
        alt_s[b : b + block] = got[:, 1]
    work = {"pairs": 2 * n, "read_bases": int(read_len * n),
            "hap_bases": int(hap_len.sum()), "cells": cells}
    return ref_s, alt_s, work


def call_codes(ref_s: np.ndarray, alt_s: np.ndarray) -> np.ndarray:
    """0 no call, 1 REF, 2 ALT, 3 UNKNOWN."""
    code = np.where(ref_s > alt_s, 1, np.where(alt_s > ref_s, 2, 3))
    return np.where((ref_s < MIN_SCORE) & (alt_s < MIN_SCORE), 0, code)


def _umi_keys(umi: np.ndarray) -> np.ndarray:
    """A distinct int64 per distinct UB string (base-5 digits of A, C, G,
    T and anything else)."""
    digit = np.full(256, 4, np.int64)
    digit[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    out = np.zeros(len(umi), np.int64)
    for k in range(umi.shape[1]):
        out = out * 5 + digit[umi[:, k]]
    return out


def counts(var, cell, umi_key, code, use_umi: bool):
    """(variant, cell, ref, alt) per (variant, cell) group with a filtered
    read, sorted by (variant, cell)."""
    g_key = var.astype(np.int64) * (1 << 32) + cell
    groups, g_of = np.unique(g_key, return_inverse=True)
    G = len(groups)
    called = code != 0
    if use_umi:
        u_key = np.stack([g_of[called], umi_key[called]], 1)
        u_groups, u_of = np.unique(u_key, axis=0, return_inverse=True)
        u_of = u_of.reshape(-1)
        c = code[called]
        nu = len(u_groups)
        ref = np.bincount(u_of, c == 1, nu)
        alt = np.bincount(u_of, c == 2, nu)
        tot = np.bincount(u_of, minlength=nu)
        u_code = np.where(alt / tot >= 0.75, 2,
                          np.where(ref / tot >= 0.75, 1, 3))
        owner, final = u_groups[:, 0], u_code
    else:
        owner, final = g_of[called], code[called]
    ref_c = np.bincount(owner, final == 1, G).astype(np.int64)
    alt_c = np.bincount(owner, final == 2, G).astype(np.int64)
    return groups >> 32, groups & 0xFFFFFFFF, ref_c, alt_c


def matrices(rows, cols, ref_c, alt_c, method: str):
    """{"matrix": (rows, cols, values)} and for coverage "ref_matrix"."""
    if method == "consensus":
        val = np.where((ref_c > 0) & (alt_c > 0), 3.0,
                       np.where(alt_c > 0, 2.0,
                                np.where(ref_c > 0, 1.0, 0.0)))
        k = val > 0
        return {"matrix": (rows[k], cols[k], val[k])}
    if method == "coverage":
        return {"matrix": (rows, cols, alt_c.astype(np.float64)),
                "ref_matrix": (rows, cols, ref_c.astype(np.float64))}
    raise ValueError(f"unknown scoring method {method!r}")


def expected(ds, sem: Semantics, device: str = "cpu",
             bits: Optional[int] = None) -> Tuple[dict, Tuple[int, int],
                                                  dict]:
    """The matrices VarTrix writes for the dataset (each as (rows, cols,
    values), 0-based), their shape, and the scoring work."""
    refs, alts, skipped = haplotypes(ds, sem)
    var, rec = read_pairs(ds, sem, skipped)
    cell = cell_index(ds)[rec]
    has_cb = cell >= 0
    var, rec, cell = var[has_cb], rec[has_cb], cell[has_cb]
    if sem.umi:
        has_ub = np.full(len(rec), ds.umi.shape[1] > 0)
        var, rec, cell = var[has_ub], rec[has_ub], cell[has_ub]
    umi_key = (_umi_keys(ds.umi[rec]) if sem.umi
               else np.zeros(len(rec), np.int64))
    ref_s, alt_s, work = score_pairs(ds, var, rec, refs, alts, sem.sw_mode,
                                     device, bits)
    code = call_codes(ref_s, alt_s)
    mats = matrices(*counts(var, cell, umi_key, code, sem.umi),
                    sem.scoring_method)
    n_cells = len(dict.fromkeys(ds.barcodes))
    return mats, (len(ds.v_tid), n_cells), work
