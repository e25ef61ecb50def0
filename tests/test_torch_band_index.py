"""The band builder's k-mer index and the scratch budgets of the port's
kernels, on the CPU.

  * the plain index (ops/band_torch.band_index) against a numpy brute
    force: each row's 6-mer keys sorted by (key, j);
  * a Python transliteration of the global route's merge passes
    (csrc/band_build.cu index_kernel) against the same brute force, over
    lengths around powers of two;
  * a numpy transliteration of the shared route (index_shared_kernel):
    the block's rows as aligned words from any byte offset, keys by
    funnel shifts, the bitonic network over composite words in its
    thread, shuffle and shared-memory steps, rows per block as
    sw_cuda.index_shape gives them; against the brute force and the
    plain index, hypothesis over widths up to the route's limit;
  * the route picker (sw_cuda.index_route), the shared route's launch
    shape and the buffers the wrapper allocates on each route;
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
from vartrix_tpu_torch.utils import trace

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


SENTINEL = np.uint64(2 ** 64 - 1)


def funnel_r(lo, hi, s):
    """__funnelshift_r on uint64 arrays holding 32-bit words."""
    return ((hi << np.uint64(32)) | lo) >> s.astype(np.uint64) \
        & np.uint64(0xffffffff)


def shared_index_block(mem, base, H, ly, block):
    """Python transliteration of index_shared_kernel for block `block` of
    an [H, ly] matrix that starts at byte `base` of `mem`: {row: (hap_len,
    keys, pos)} of the block's rows, keys and pos their first n entries as
    the kernel writes them."""
    sort, group, rows_per_block = sw_cuda.index_shape(ly)
    E = sw_cuda.INDEX_SORT_PER_THREAD
    stride = group + 1
    h0 = block * rows_per_block
    rows = min(rows_per_block, H - h0)
    span = base + h0 * ly
    a = span & 3
    n_words = (rows_per_block * ly + 3) // 4 + 5
    s_bytes = np.zeros(4 * n_words, np.uint8)
    s_bytes[a : a + rows * ly] = mem[span : span + rows * ly]
    s_words = s_bytes.view("<u4").astype(np.uint64)
    t = np.arange(group)
    i0 = t * E
    out = {}
    for rho in range(rows):
        row = s_bytes[a + rho * ly : a + (rho + 1) * ly]
        nz = np.nonzero(row != 1)[0]
        length = int(nz[-1]) + 1 if len(nz) else 0
        n = length - K + 1
        if n <= 0:
            out[h0 + rho] = (length, [], [])
            continue
        # each thread's 8 keys from 5 words, aligned to its first byte o
        live = i0 < n
        o = a + rho * ly + np.where(live, i0, 0)
        w = [s_words[(o >> 2) + q] for q in range(5)]
        u = [funnel_r(w[q], w[q + 1], 8 * (o & 3)) for q in range(4)]
        v = np.full((group, E), SENTINEL, np.uint64)
        for r in range(E):
            q, sh = r >> 2, np.full(group, 8 * (r & 3))
            lo = funnel_r(u[q], u[q + 1], sh)
            hi = funnel_r(u[q + 1], u[q + 2], sh) & np.uint64(0xffff)
            comp = (((hi << np.uint64(32)) | lo) << np.uint64(16)) \
                | (i0 + r).astype(np.uint64)
            v[:, r] = np.where(live & (i0 + r < n), comp, SENTINEL)
        size = 1
        while size < n:
            size *= 2
        s_row = np.zeros(E * stride, np.uint64)
        k = 2
        while k <= size:
            j = k // 2
            while j >= E:  # across threads: partner t ^ m, the same slot
                m = j // E
                keep_min = ((t & m) == 0) == ((i0 & k) == 0)
                if m < 32:  # a shuffle
                    other = v[t ^ m]
                else:  # through shared memory
                    other = np.empty_like(v)
                    for r in range(E):
                        s_row[r * stride + t] = v[:, r]
                    for r in range(E):
                        other[:, r] = s_row[r * stride + (t ^ m)]
                v = np.where((v < other) == keep_min[:, None], v, other)
                j //= 2
            jj = E // 2
            while jj > 0:  # within a thread
                if jj < k:
                    for r in range(E):
                        if r & jj == 0:
                            asc = ((i0 + r) & k) == 0
                            x, y = v[:, r].copy(), v[:, r | jj].copy()
                            swap = (x > y) == asc
                            v[:, r] = np.where(swap, y, x)
                            v[:, r | jj] = np.where(swap, x, y)
                jj //= 2
            k *= 2
        for r in range(E):
            s_row[r * stride + t] = v[:, r]
        e = np.arange(n)
        c = s_row[(e % E) * stride + e // E]
        out[h0 + rho] = (length, (c >> np.uint64(16)).astype(np.int64)
                         .tolist(),
                         (c & np.uint64(0xffff)).astype(np.int64).tolist())
    return out


def shared_index(haps, base=0):
    """The shared route over every block of `haps`, the matrix at byte
    `base` of a buffer: {row: (hap_len, keys, pos)}."""
    H, ly = haps.shape
    mem = np.zeros(base + H * ly, np.uint8)
    mem[base:] = haps.reshape(-1)
    rows = sw_cuda.index_shape(ly)[2]
    out = {}
    for block in range(-(-H // rows)):
        out.update(shared_index_block(mem, base, H, ly, block))
    return out


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


def assert_index_exact(haps, got):
    """got ({row: (hap_len, keys, pos)}) against the brute force and the
    plain index of haps."""
    plain = band_torch.band_index(torch.from_numpy(haps))
    assert sorted(got) == list(range(len(haps)))
    for h, row in enumerate(haps):
        rk = row_keys(row, 1)
        exp_k, exp_p = brute_index(rk)
        length, keys, pos = got[h]
        assert length == int(plain.hap_len[h])
        assert keys == exp_k and pos == exp_p
        assert keys == plain.keys[h, :len(rk)].tolist()
        assert pos == plain.pos[h, :len(rk)].tolist()


@pytest.mark.parametrize("name", list(INDEX_CASES))
def test_shared_route_matches_brute_force(name):
    haps = INDEX_CASES[name]()
    assert_index_exact(haps, shared_index(haps))


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       ly=st.one_of(st.integers(1, 300),
                    st.sampled_from([517, 1029, 2053, 4101, 4032,
                                     sw_cuda.INDEX_SHARED_LY])),
       alphabet=st.sampled_from([b"A", b"AC", b"ACGT"]),
       base=st.integers(0, 3),
       n_rows=st.integers(1, 10))
def test_shared_route_sorts_rows_of_any_length(seed, ly, alphabet, base,
                                               n_rows):
    # rows of several lengths in one block (8 rows a block up to 261
    # bytes), among them full rows and empty ones, the matrix at any byte
    # offset from a word
    rng = np.random.default_rng(seed)
    H = n_rows if ly <= 261 else min(n_rows, 3)
    haps = rng.choice(np.frombuffer(alphabet, np.uint8), (H, ly))
    lens = rng.integers(0, ly + 1, H)
    lens[0] = ly
    for h in range(H):
        haps[h, lens[h]:] = 1
    assert_index_exact(haps, shared_index(haps, base))


def test_shared_route_one_repeated_base_at_the_limit():
    # every key equal: only the j order is left, at the route's widest row
    ly = sw_cuda.INDEX_SHARED_LY
    haps = np.full((2, ly), ord("A"), np.uint8)
    haps[1, ly // 3:] = 1
    got = shared_index(haps, base=1)
    assert got[0][2] == list(range(ly - K + 1))
    assert_index_exact(haps, got)


@pytest.mark.parametrize("ly, route", [
    (1, "shared"), (224, "shared"), (4032, "shared"),
    (sw_cuda.INDEX_SHARED_LY, "shared"),
    (sw_cuda.INDEX_SHARED_LY + 1, "global"), (100_000, "global"),
])
def test_index_route_by_width(ly, route):
    assert sw_cuda.index_route(ly) == route
    if route == "global":
        with pytest.raises(ValueError):
            sw_cuda.index_shape(ly)


@pytest.mark.parametrize("ly, shape", [
    (1, (256, 32, 8)), (224, (256, 32, 8)), (261, (256, 32, 8)),
    (262, (512, 64, 1)), (4032, (4096, 512, 1)),
    (sw_cuda.INDEX_SHARED_LY, (8192, 1024, 1)),
])
def test_index_shape_by_width(ly, shape):
    # a warp per row and 8 rows a block up to 256 keys, then 8 keys a
    # thread and one row a block, 1,024 threads at the limit
    assert sw_cuda.index_shape(ly) == shape


@pytest.mark.parametrize("route", sw_cuda.INDEX_ROUTES)
def test_index_buffers_by_route(route):
    H, ly = 5, 40
    index, (tmp_keys, tmp_pos) = sw_cuda.index_buffers(H, ly, route, "cpu")
    assert index.keys.shape == index.pos.shape == (H, ly)
    assert index.hap_len.shape == (H,)
    assert (index.keys.dtype, index.pos.dtype, index.hap_len.dtype) == (
        torch.int64, torch.int32, torch.int32)
    assert all(t.is_contiguous() for t in index)
    if route == "shared":
        assert tmp_keys is None and tmp_pos is None
    else:
        assert tmp_keys.shape == tmp_pos.shape == (H, ly)
        assert (tmp_keys.dtype, tmp_pos.dtype) == (torch.int64, torch.int32)
    # no two buffers share memory
    ptrs = {t.untyped_storage().data_ptr() for t in (*index, tmp_keys,
                                                     tmp_pos)
            if t is not None}
    assert len(ptrs) == (3 if route == "shared" else 5)


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


CARD_INDEX_CASES = dict(
    INDEX_CASES,
    at_limit=lambda: random_rows(seed=73, H=5, ly=sw_cuda.INDEX_SHARED_LY),
    past_limit=lambda: random_rows(seed=79, H=3,
                                   ly=sw_cuda.INDEX_SHARED_LY + 1),
    one_base=lambda: random_rows(seed=83, H=12, alphabet=b"A"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sw_cuda.INDEX_ROUTES)
@pytest.mark.parametrize("name", list(CARD_INDEX_CASES))
def test_index_kernel_matches_plain_on_card(cuda_device, name, route):
    haps = torch.from_numpy(CARD_INDEX_CASES[name]())
    if route == "shared" and haps.shape[1] > sw_cuda.INDEX_SHARED_LY:
        with pytest.raises(RuntimeError):
            sw_cuda.band_index(haps.to(cuda_device), route=route)
        return
    exp = band_torch.band_index(haps)
    got = sw_cuda.band_index(haps.to(cuda_device), route=route)
    torch.cuda.synchronize()
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
    n0 = trace.counters().get("launch.sw_pair.pair", 0)
    got = sw_cuda.pair_scores(*dev)
    # 24 reads, 3 per range
    assert trace.counters()["launch.sw_pair.pair"] - n0 == 8
    got_banded = sw_cuda.banded_pair_scores(
        *dev, *(b.to(cuda_device) for b in bounds))
    assert torch.equal(got.cpu(), exp)
    assert torch.equal(got_banded.cpu(), exp_banded)
