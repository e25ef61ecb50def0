"""The kernels' bounds: the work counted from the inputs, checked against
cells counted by hand, and the bound's arithmetic."""

import numpy as np
import pytest
import torch

from benchmark import peaks
from benchmark.counts import sw_banded, sw_pair
from benchmark.reference import band, sw
from benchmark.reference import vartrix as reference
from benchmark.inputs import synth


def test_peaks():
    assert peaks.INSTR_PER_S == pytest.approx(33.45e12, rel=1e-3)
    assert peaks.bound_seconds(33.45e12, 0) == pytest.approx(1.0, rel=1e-3)
    assert peaks.bound_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_sw_pair_bound_by_hand():
    work = {"full": {"pairs": 4, "read_bases": 2 * 150, "hap_bases": 800,
                     "cells": 150 * (201 + 203) + 150 * (199 + 201)}}
    cells = 150 * 404 + 150 * 400
    want = cells * 3.75 / (132 * 128 * 1.98e9)
    assert sw_pair.bound_seconds(work) == pytest.approx(want)
    assert sw_pair.bound_seconds({"banded": work["full"]}) is None
    assert sw_banded.bound_seconds(work) is None


def test_full_cells_are_read_times_haplotype_lengths():
    p = dict(n_chroms=1, chrom_len=5_000, n_variants=3, n_cells=5,
             reads_per_variant=4, indel_frac=1.0, multimap_frac=0.0)
    ds = synth.generate(p, 3)
    sem = reference.Semantics()
    refs, alts, skipped = reference.haplotypes(ds, sem)
    var, rec = reference.read_pairs(ds, sem, skipped)
    _, _, work = reference.score_pairs(ds, var, rec, refs, alts, "full",
                                       "cpu")
    by_hand = sum(150 * (len(refs[v]) + len(alts[v])) for v in var)
    assert work["cells"] == by_hand and work["pairs"] == 2 * len(var)


def test_banded_cells_are_the_bands_cells():
    # one read, one haplotype pair: the band's cells counted row by row
    rng = np.random.default_rng(1)
    hap = rng.choice(np.frombuffer(b"ACGT", np.uint8), 201)
    read = hap[30:180].copy()
    x = torch.from_numpy(read[None, :])
    y = torch.from_numpy(np.stack([hap, hap]))
    jlo, jhi = band.band_bounds(x, y, torch.tensor([0], dtype=torch.int32),
                                torch.tensor([1], dtype=torch.int32))
    by_hand = 0
    for p in range(2):
        for i in range(150):
            by_hand += max(0, int(jhi[i, p]) - int(jlo[i, p]))
    # the band around the read's own diagonal: 2 x 20 + 1 columns a row,
    # fewer where the band meets the haplotype's ends
    assert 2 * 150 * 30 < by_hand <= 2 * 150 * 41
    assert int((jhi - jlo).clamp_min(0).sum()) == by_hand
    s = sw.banded_scores(x.repeat(2, 1), y, jlo.T, jhi.T)
    assert s.tolist() == [150, 150]
