"""The port's band builder of --sw-mode banded: the plain PyTorch version
(ops/band_torch.py) against the JAX package's native band construction
(banded_bounds_batch_native) and the port's host copy (csrc/band_bounds.cpp
through ops/sw_native.band_bounds), exact int32 bounds; and a Python
transliteration of the banded kernel's strip loop (csrc/sw_banded.cu:
entry zone, core, exit zone) against the plain banded DP; and the problem
ranges the kernel's wrapper cuts its chain pass into.

Inputs are made with numpy from a seed. The case marked `cuda` holds the
CUDA band builder against the plain version on a GPU."""

import numpy as np
import pytest
import torch

from test_torch_banded import BOUND_FAMILIES, _seqs, family, pair_case, \
    wide_case
from vartrix_tpu.ops.sw_native import banded_bounds_batch_native
from vartrix_tpu_torch.ops import band_torch, sw_banded_torch, sw_cuda, \
    sw_native

BASES = np.frombuffer(b"ACGT", np.uint8)


def repetitive_case(seed=31, R=24, lx=48, ly=80):
    """Low-complexity reads and haplotypes (runs and short repeats over a
    two- or three-letter alphabet): up to (len_x - 5)(len_y - 5) matches
    per problem."""
    rng = np.random.default_rng(seed)
    units = [b"A", b"AC", b"ACG", b"AAC", b"CA"]
    x = np.zeros((R, lx), np.uint8)
    haps = np.ones((2 * R, ly), np.uint8)
    for r in range(R):
        unit = np.frombuffer(units[r % len(units)], np.uint8)
        n = int(rng.integers(lx // 2, lx + 1))
        x[r, :n] = np.resize(unit, n)
        for h in (2 * r, 2 * r + 1):
            m = int(rng.integers(ly // 2, ly + 1))
            haps[h, :m] = np.resize(unit, m)
            if h % 2:  # the alt: a few substitutions
                pos = rng.integers(0, m, 3)
                haps[h, pos] = rng.choice(BASES, 3)
    idx = np.arange(R, dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


def short_case(seed=37, R=64):
    """Reads and haplotypes shorter than k, and some of k exactly."""
    rng = np.random.default_rng(seed)
    x = np.zeros((R, 12), np.uint8)
    haps = np.ones((2 * R, 12), np.uint8)
    for r in range(R):
        n = int(rng.integers(1, 9))
        x[r, :n] = rng.choice(BASES, n)
        for h in (2 * r, 2 * r + 1):
            m = int(rng.integers(0, 10))
            haps[h, :m] = rng.choice(BASES, m)
            if m >= n and rng.random() < 0.5:
                haps[h, :n] = x[r, :n]
    idx = np.arange(R, dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


def rows_case(name):
    """test_torch_banded.py's plain-row families as pair problems: read i
    against haplotype row i as both its ref and its alt."""
    x, y = family(name)
    ident = np.arange(len(x), dtype=np.int32)
    return x, y, ident, ident


def unseeded_pairs(seed=41, R=40, lx=40, ly=56):
    rng = np.random.default_rng(seed)
    x = rng.choice(np.frombuffer(b"AC", np.uint8), (R, lx))
    x[:, ::5] = ord("C")
    haps = rng.choice(np.frombuffer(b"AG", np.uint8), (2 * R, ly))
    idx = np.arange(R, dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


CASES = {
    **{f"rows_{n}": (lambda n=n: rows_case(n)) for n in BOUND_FAMILIES},
    "rows_odd_bytes": lambda: rows_case("odd_bytes"),
    "pairs_indels_empty_hap": lambda: pair_case(R=300),
    "repetitive": repetitive_case,
    "shorter_than_k": short_case,
    "unseeded_pairs": unseeded_pairs,
    "wide_40000": wide_case,
}


def _jax_bounds(x, haps, idx):
    """The JAX package's native bounds of each read against haps[idx],
    [lx, R] in its own type (int16: a column past 32,767 wraps, as it
    does in the TPU kernel's input)."""
    xs, _ = _seqs(x, x)
    _, ys = _seqs(haps[idx], haps[idx])
    lo, hi = banded_bounds_batch_native(xs, ys, x.shape[1], 2)
    return lo.T, hi.T


@pytest.mark.parametrize("name", list(CASES))
def test_plain_band_builder_matches_host_and_jax(name):
    x, haps, idx_ref, idx_alt = CASES[name]()
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (x, haps, idx_ref, idx_alt)]
    # the wrapper's CPU route is the plain builder
    jlo, jhi = (t.numpy() for t in sw_cuda.band_bounds(*args))
    assert jlo.dtype == np.int32 and jlo.shape == (x.shape[1], 2 * len(x))
    hlo, hhi = sw_native.band_bounds(x, haps, idx_ref, idx_alt, 2)
    np.testing.assert_array_equal(jlo, hlo)
    np.testing.assert_array_equal(jhi, hhi)
    for which, idx in enumerate((idx_ref, idx_alt)):
        elo, ehi = _jax_bounds(x, haps, idx)
        np.testing.assert_array_equal(jlo[:, which::2].astype(elo.dtype),
                                      elo)
        np.testing.assert_array_equal(jhi[:, which::2].astype(ehi.dtype),
                                      ehi)
    if name == "wide_40000":
        assert jhi.max() > 32_767
    if name == "unseeded_pairs":
        assert not jhi.any()


def test_repetitive_case_has_thousands_of_matches():
    # the case that exercises exact scratch sizing in the kernel
    x, haps, idx_ref, _ = repetitive_case()
    lens_x = (x != 0).sum(1)
    lens_y = (haps[idx_ref] != 1).sum(1)
    keys_x = [{bytes(x[r, i : i + 6]) for i in range(lens_x[r] - 5)}
              for r in range(len(x))]
    counts = [sum(bytes(haps[idx_ref[r], j : j + 6]) in keys_x[r]
                  for j in range(lens_y[r] - 5)) for r in range(len(x))]
    assert max(counts) > 20  # distinct haplotype positions that match
    assert (lens_x.max() - 5) * (lens_y.max() - 5) > 1000


# ----------------------------------------------- the kernel's strip loop

NEG = -6


STRIP = 8  # the kernel's kStrip


def strip_loop(x, y, jlo, jhi):
    """Python transliteration of csrc/sw_banded.cu `sw_banded_problem` for
    one problem: uint8 x [lx], y [ly], int32 jlo/jhi [lx] -> (best score,
    visited cells, core cells). Each strip of STRIP rows visits [c0, c1)
    (its in-band rows' union) as an entry zone [c0, a), a core [a, b)
    where every row below the read's true length is in band (no test per
    cell) and an exit zone [b, c1); rows at or past the true length are
    computed freely in the core (their read byte 0 matches nothing)."""
    lx, ly = len(x), len(y)
    len_x = lx
    while len_x and x[len_x - 1] == 0:
        len_x -= 1
    col_h = [0] * ly
    col_f = [NEG] * ly
    best = visited = core_cells = 0
    pv_lo = pv_hi = 0
    n_strips = (lx + STRIP - 1) // STRIP
    for s in range(n_strips):
        rows = range(s * STRIP, s * STRIP + STRIP)
        lo = [int(jlo[i]) if i < lx else 0 for i in rows]
        hi = [int(jhi[i]) if i < lx else 0 for i in rows]
        live = [r for r in range(STRIP) if lo[r] < hi[r]]
        if not live:
            pv_lo = pv_hi = 0
            continue
        c0 = max(min(lo[r] for r in live), 0)
        c1 = min(max(hi[r] for r in live), ly)
        if c0 >= c1:
            pv_lo = pv_hi = 0
            continue
        core_lo, core_hi = 0, ly
        for r, i in enumerate(rows):
            if i < len_x:
                core_lo = max(core_lo, lo[r])
                core_hi = min(core_hi, hi[r])
        a = max(c0, min(core_lo, c1))
        b = max(a, min(core_hi, c1))
        xs = [int(x[i]) if i < lx else 0 for i in rows]
        hl = [0] * STRIP
        e = [NEG] * STRIP
        h_up_prev = col_h[c0 - 1] if c0 > 0 and pv_lo <= c0 - 1 < pv_hi \
            else 0
        for j in range(c0, c1):
            masked = j < a or j >= b
            h, f = (col_h[j], col_f[j]) if pv_lo <= j < pv_hi else (0, NEG)
            diag, h_up_prev = h_up_prev, h
            for r in range(STRIP):
                f = max(h - 6, f - 1)
                en = max(hl[r] - 6, e[r] - 1)
                sc = 1 if xs[r] == y[j] else -5
                h = max(diag + sc, en, f, 0)
                if masked and not lo[r] <= j < hi[r]:
                    h, f = 0, NEG  # E needs no select
                e[r] = en
                diag, hl[r] = hl[r], h
                best = max(best, h)
            col_h[j], col_f[j] = h, f
            visited += STRIP
            core_cells += 0 if masked else STRIP
        pv_lo, pv_hi = c0, c1
    return best, visited, core_cells


def _plain_scores(x, y, jlo, jhi):
    return sw_banded_torch.banded_scores(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(jlo),
        torch.from_numpy(jhi)).numpy()


def bending_bands(seed=43, B=48, lx=40, ly=64):
    """Reads with indels against their haplotypes, bounds from the band
    builder: diagonal bands that bend, start late and end early."""
    x, haps, idx_ref, _ = pair_case(seed=seed, R=B, lx=lx, ly=ly)
    y = haps[idx_ref]
    ident = np.arange(B, dtype=np.int32)
    jlo, jhi = sw_native.band_bounds(x, y, ident, ident, 1)
    return x, y, jlo[:, 0::2].copy(), jhi[:, 0::2].copy()


def box_bands(seed=47, B=48, lx=40, ly=64):
    """Random boxes and staircases, rows left empty at the top, the middle
    and the bottom of the read, rows reaching past the haplotype."""
    rng = np.random.default_rng(seed)
    x = rng.choice(BASES, (B, lx))
    y = rng.choice(BASES, (B, ly))
    for b in range(B):
        x[b, int(rng.integers(lx // 2, lx + 1)):] = 0
        y[b, int(rng.integers(ly // 2, ly + 1)):] = 1
        y[b, : lx // 2] = x[b, : lx // 2]
    jlo = rng.integers(-3, ly, (lx, B)).astype(np.int32)
    jhi = (jlo + rng.integers(-5, 30, (lx, B))).astype(np.int32)
    jlo[: lx // 3, ::3] = np.arange(lx // 3)[:, None]  # staircase
    jhi[: lx // 3, ::3] = np.arange(lx // 3)[:, None] + 12
    jlo[:, 1::5] = 0   # full box
    jhi[:, 1::5] = ly + 4
    jhi[5:9, 2::5] = 0  # empty rows inside the read
    jlo[:4, 4::5] = jhi[:4, 4::5] = 0  # empty top rows
    return x, y, jlo, jhi


def empty_bands(B=8, lx=24, ly=32):
    rng = np.random.default_rng(53)
    x = rng.choice(BASES, (B, lx))
    y = rng.choice(BASES, (B, ly))
    z = np.zeros((lx, B), np.int32)
    return x, y, z, z.copy()


@pytest.mark.parametrize("bands", ["bending", "box", "empty"])
def test_strip_loop_transliteration_matches_plain_dp(bands):
    x, y, jlo, jhi = {"bending": bending_bands, "box": box_bands,
                      "empty": empty_bands}[bands]()
    exp = _plain_scores(x, y, jlo, jhi)
    got, core = [], 0
    for b in range(len(x)):
        score, _, c = strip_loop(x[b], y[b], jlo[:, b], jhi[:, b])
        got.append(score)
        core += c
    np.testing.assert_array_equal(np.array(got), exp)
    if bands == "bending":
        assert core > 0 and exp.max() > 0  # the core zone ran


# ------------------------------- the chain pass's problem ranges

@pytest.mark.parametrize("counts, lx, budget", [
    ([0] * 7, 10, 1 << 30),                 # no matches: one range
    ([5, 0, 3, 9, 1, 2, 0, 4], 4, 200),     # several ranges
    ([1, 1000, 1, 1], 2, 100),              # one problem over the budget
    ([20] * 9, 3, 12 * 20 + 24),            # exactly one problem per range
])
def test_band_ranges_cover_problems_within_budget(counts, lx, budget):
    ends = np.cumsum(np.array(counts, np.int64))
    ranges = sw_cuda.band_ranges(ends, lx, budget)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(counts)
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0  # in order, no gap, no overlap
    need = [12 * c + 8 * lx for c in counts]
    for p0, p1 in ranges:
        assert p1 > p0
        assert p1 - p0 == 1 or sum(need[p0:p1]) <= budget
        if p1 < len(counts):  # greedy: the next problem would not fit
            assert sum(need[p0:p1 + 1]) > budget


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["repetitive", "pairs_indels_empty_hap",
                                  "wide_40000", "shorter_than_k"])
def test_band_build_kernel_matches_plain_on_card(cuda_device, name):
    x, haps, idx_ref, idx_alt = CASES[name]()
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (x, haps, idx_ref, idx_alt)]
    exp = band_torch.band_bounds(*args)
    got = sw_cuda.band_bounds(*(a.to(cuda_device) for a in args))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.numpy())


@pytest.mark.cuda
def test_band_build_kernel_exact_over_several_chain_ranges(cuda_device,
                                                          monkeypatch):
    # a scratch budget of a few problems cuts the chain pass into ranges
    x, haps, idx_ref, idx_alt = repetitive_case()
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (x, haps, idx_ref, idx_alt)]
    exp = band_torch.band_bounds(*args)
    monkeypatch.setattr(sw_cuda, "BAND_SCRATCH_BYTES", 1 << 15)
    got = sw_cuda.band_bounds(*(a.to(cuda_device) for a in args))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.numpy())
