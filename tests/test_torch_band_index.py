"""The band builder's k-mer index and the scratch budgets of the port's
kernels, on the CPU.

  * the plain index (ops/band_torch.band_index) against a numpy brute
    force: each row's 6-mer keys sorted by (key, j);
  * a Python transliteration of the index kernel's merge passes
    (csrc/band_build.cu index_kernel) against the same brute force, over
    lengths around powers of two;
  * a Python transliteration of the kernels' lookups (two binary searches
    per read 6-mer, then the run in order), which must yield every (i, j)
    match in exactly the order of the all-pairs enumeration: the chain DP
    breaks ties by that order;
  * the DP kernels' read-range planner (sw_cuda.read_ranges) and scratch
    word choice (sw_cuda.wide_word).

Inputs are made with numpy from seeds stated in each test (hypothesis
draws the seeds and lengths, derandomized). Cases marked `cuda` hold the
index kernel and the ranged DP launches against their plain versions on a
GPU."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_band_build import repetitive_case, short_case
from vartrix_tpu_torch.ops import band_torch, sw_banded_torch, sw_cuda, \
    sw_torch

K = 6
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None)


def row_keys(row, pad):
    """The 6-mer keys (byte t at bit 8t) of one row up to its true length
    (its last byte that is not `pad`), a list in j order."""
    nz = np.nonzero(row != pad)[0]
    n = int(nz[-1]) + 1 if len(nz) else 0
    r = row[:n].astype(np.int64)
    return [int(sum(int(r[j + t]) << (8 * t) for t in range(K)))
            for j in range(n - K + 1)]


def brute_index(keys):
    """(sorted keys, positions) of one row by (key, j)."""
    pairs = sorted((k, j) for j, k in enumerate(keys))
    return [k for k, _ in pairs], [j for _, j in pairs]


def search(a, base, n, v, or_equal):
    """csrc/band_build.cu `search`: the first index of a[base, base + n)
    whose key is not below v (or_equal: above v), relative to base."""
    lo = 0
    while n > 0:
        half = n >> 1
        k = a[base + lo + half]
        if (k <= v) if or_equal else (k < v):
            lo += half + 1
            n -= half + 1
        else:
            n = half
    return lo


def merge_index(keys):
    """Python transliteration of index_kernel's sort: runs of 1, 2, 4, ...
    merged, each element placed by a binary search in the other run (the
    left run's elements first on equal keys)."""
    n = len(keys)
    ka, pa = list(keys), list(range(n))
    w = 1
    while w < n:
        kb, pb = [None] * n, [None] * n
        for e in range(n):
            start = e & ~(2 * w - 1)
            v = ka[e]
            if e & w == 0:
                m = max(0, min(w, n - start - w))
                at = e + search(ka, start + w, m, v, False)
            else:
                at = e - w + search(ka, start, w, v, True)
            kb[at], pb[at] = v, pa[e]
        ka, pa = kb, pb
        w <<= 1
    return ka, pa


def walk(read_keys, keys, pos):
    """The kernels' match enumeration: per read position i in order, its
    run [lo, hi) of the sorted keys, then the run's positions in order."""
    n = len(keys)
    out = []
    for i, kx in enumerate(read_keys):
        lo = search(keys, 0, n, kx, False)
        hi = lo + search(keys, lo, n - lo, kx, True)
        out += [(i, pos[e]) for e in range(lo, hi)]
    return out


def all_pairs(read_keys, hap_keys):
    return [(i, j) for i, kx in enumerate(read_keys)
            for j, ky in enumerate(hap_keys) if kx == ky]


def random_rows(seed=61, H=40, ly=90, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    haps = rng.choice(np.frombuffer(alphabet, np.uint8), (H, ly))
    for h in range(H):
        haps[h, int(rng.integers(0, ly + 1)):] = 1
    return haps


INDEX_CASES = {
    "random": random_rows,
    "two_letter": lambda: random_rows(seed=67, alphabet=b"AC"),
    "repetitive": lambda: repetitive_case()[1],
    "short": lambda: short_case()[1],
    "pad_rows": lambda: np.ones((8, 30), np.uint8),
}


@pytest.mark.parametrize("name", list(INDEX_CASES))
def test_plain_index_matches_brute_force(name):
    haps = INDEX_CASES[name]()
    # the wrapper's CPU route is the plain index
    index = sw_cuda.band_index(torch.from_numpy(haps))
    keys, pos = index.keys.numpy(), index.pos.numpy()
    assert keys.shape == pos.shape == haps.shape
    for h, row in enumerate(haps):
        rk = row_keys(row, 1)
        exp_k, exp_p = brute_index(rk)
        n = len(rk)
        nz = np.nonzero(row != 1)[0]
        assert int(index.hap_len[h]) == (int(nz[-1]) + 1 if len(nz) else 0)
        assert keys[h, :n].tolist() == exp_k
        assert pos[h, :n].tolist() == exp_p
        assert (pos[h, n:] == -1).all()
    if name == "pad_rows":
        assert not index.hap_len.any()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("alphabet", [b"A", b"AC", b"ACGT"])
def test_merge_passes_sort_like_brute_force(n, alphabet):
    # seed 71 + n; lengths on both sides of the passes' powers of two
    rng = np.random.default_rng(71 + n)
    row = rng.choice(np.frombuffer(alphabet, np.uint8), n + K - 1) \
        if n else np.ones(4, np.uint8)
    keys = row_keys(row, 1)
    assert len(keys) == n
    assert merge_index(keys) == tuple(map(list, brute_index(keys)))


@SETTINGS
@given(seed=st.integers(0, 2 ** 32 - 1),
       len_x=st.integers(0, 40),
       len_y=st.one_of(st.integers(0, 80),
                       st.sampled_from([K - 1 + 2 ** k for k in range(7)])),
       alphabet=st.sampled_from([b"A", b"AC", b"ACG", b"ACGT"]))
def test_index_walk_yields_matches_in_all_pairs_order(seed, len_x, len_y,
                                                      alphabet):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(alphabet, np.uint8)
    x = np.zeros(48, np.uint8)
    x[:len_x] = rng.choice(bases, len_x)
    y = np.ones(96, np.uint8)
    y[:len_y] = rng.choice(bases, len_y)
    if len_x and len_y > len_x and rng.random() < 0.5:  # a shared stretch
        o = int(rng.integers(0, len_y - len_x + 1))
        y[o : o + len_x] = x[:len_x]
    rk, hk = row_keys(x, 0), row_keys(y, 1)
    exp = all_pairs(rk, hk)
    # the kernel's own sort, and the plain index
    assert walk(rk, *merge_index(hk)) == exp
    index = band_torch.band_index(torch.from_numpy(y[None, :]))
    n = len(hk)
    assert walk(rk, index.keys[0, :n].tolist(),
                index.pos[0, :n].tolist()) == exp


# ------------------------------------------- the DP kernels' scratch

@SETTINGS
@given(n_reads=st.integers(0, 3000),
       lx=st.sampled_from([1, 8, 9, 16, 17, 160, 65536, 70000]),
       ly=st.sampled_from([1, 224, 4032, 65535, 65536, 100000]),
       per_read=st.sampled_from([1, 2]),
       banded=st.booleans(),
       budget=st.integers(0, 1 << 31))
def test_read_ranges_cover_reads_within_budget(n_reads, lx, ly, per_read,
                                               banded, budget):
    ranges = sw_cuda.read_ranges(n_reads, lx, ly, per_read, budget, banded)
    if n_reads == 0:
        assert ranges == []
        return
    assert ranges[0][0] == 0 and ranges[-1][1] == n_reads
    for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0  # in order, no gap, no overlap
    need = per_read * sw_cuda.dp_scratch_bytes(lx, ly, banded)
    for r0, r1 in ranges:
        assert r1 > r0
        assert r1 - r0 == 1 or (r1 - r0) * need <= budget
        if r1 < n_reads:  # the next read would not fit
            assert (r1 - r0 + 1) * need > budget


@pytest.mark.parametrize("lx, ly, wide", [
    (32842, 32840, False),   # chip_smoke's near_limit family
    (65535, 100000, False),
    (160, 100000, False),    # a read against a 100 kb haplotype
    (65536, 65536, True),
    (65604, 70000, True),
])
def test_wide_word_only_from_65536(lx, ly, wide):
    assert sw_cuda.wide_word(lx, ly) is wide
    word = 8 if wide else 4
    assert sw_cuda.dp_scratch_bytes(lx, ly) == ly * word
    assert sw_cuda.dp_scratch_bytes(lx, ly, banded=True) == 2 * ly * word


def test_one_strip_reads_need_no_scratch():
    assert sw_cuda.dp_scratch_bytes(16, 224) == 0
    assert sw_cuda.dp_scratch_bytes(8, 224, banded=True) == 0
    assert sw_cuda.dp_scratch_bytes(9, 224, banded=True) == 2 * 224 * 4
    assert sw_cuda.read_ranges(5, 16, 224, 2, 0) == [(0, 5)]


def test_banded_backend_builds_no_index_on_plain_route(monkeypatch):
    # the plain route compares every pair; only the kernel route indexes
    x, haps, idx_ref, idx_alt = repetitive_case(R=8)
    monkeypatch.setattr(sw_cuda, "band_index", None)
    be = sw_cuda.BandedSwBackend("cpu", kernel=False)
    codes = be.pair_calls_chained(x, haps, idx_ref, idx_alt)
    assert codes.shape == (8,) and codes.dtype == np.int8


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INDEX_CASES))
def test_index_kernel_matches_plain_on_card(cuda_device, name):
    haps = torch.from_numpy(INDEX_CASES[name]())
    exp = band_torch.band_index(haps)
    got = sw_cuda.band_index(haps.to(cuda_device))
    assert torch.equal(got.hap_len.cpu(), exp.hap_len)
    n = (exp.hap_len - K + 1).clamp_min(0)
    valid = torch.arange(haps.shape[1])[None, :] < n[:, None]
    assert torch.equal(got.keys.cpu()[valid], exp.keys[valid])
    assert torch.equal(got.pos.cpu()[valid], exp.pos[valid])


@pytest.mark.cuda
def test_dp_kernels_exact_over_several_read_ranges(cuda_device,
                                                   monkeypatch):
    # a scratch budget of a few reads cuts each DP launch into ranges
    x, haps, idx_ref, idx_alt = repetitive_case()
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (x, haps, idx_ref, idx_alt)]
    bounds = band_torch.band_bounds(*args)
    exp = sw_torch.pair_scores(*args)
    exp_banded = sw_banded_torch.banded_pair_scores(*args, *bounds)
    monkeypatch.setattr(sw_cuda, "DP_SCRATCH_BYTES", 3 * 2 * 80 * 4)
    dev = [a.to(cuda_device) for a in args]
    n0 = sw_cuda.LAUNCHES
    got = sw_cuda.pair_scores(*dev)
    assert sw_cuda.LAUNCHES - n0 == 8  # 24 reads, 3 per range
    got_banded = sw_cuda.banded_pair_scores(
        *dev, *(b.to(cuda_device) for b in bounds))
    assert torch.equal(got.cpu(), exp)
    assert torch.equal(got_banded.cpu(), exp_banded)
