"""sw_pair's packed route (csrc/sw_pair.cu, two problems per thread in the
int16 halves of 32-bit words, 16x2 DPX), on the CPU.

The CUDA kernel does not run here, so its loop is transliterated to numpy:
every thread of a launch at once, the strips, the columns, the scratch that
hands a strip's bottom row to the next, and each 16x2 DPX intrinsic
emulated half by half with int16 wrap-around. The transliteration is held
exact against the plain version (ops/sw_torch.py) and against the JAX
package's production kernel K3 (`_sw_pair_quad`, its codes and its 2-bit
entry, Pallas in interpret mode as tests/test_torch_sw.py runs it).
Inputs are made with numpy from seeds (hypothesis draws seeds and lengths,
derandomized); the tolerance is exact equality. Also here: the emulated
intrinsics at the edges of the int16 range, the route selector
(sw_cuda.pair_route) and the scratch of the packed route. The card-marked
case holds the kernel's routes against each other on a GPU."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.ops.sw_pallas_v2 import (_sw_pair_chained, _sw_pair_quad,
                                          _sw_pair_quad_calls,
                                          _sw_pair_quad_calls_p2)
from vartrix_tpu_torch.ops import sw_cuda, sw_torch

BASES = np.frombuffer(b"ACGT", np.uint8)
STRIP = 32            # kPackedStrip of csrc/sw_pair.cu
COLS = 2              # kCols: columns per step, the pair's rounded up to it
NEG = -30000          # kNeg
MIN_SCORE = 25
SETTINGS = settings(max_examples=30, deadline=None, derandomize=True,
                    database=None)


# ------------------------------------------------ the 16x2 DPX intrinsics
#
# A 32-bit word of two int16 halves is held as an int64 array [2, ...]:
# row 0 the low half (problem 2k), row 1 the high half (problem 2k + 1).
# Each intrinsic works half by half and wraps as an int16 does.

def wrap(v):
    """An int16 half's value after wrap-around."""
    return (np.asarray(v, np.int64) + 0x8000) % 0x10000 - 0x8000


def halves(a, b):
    """The word whose low half is a and high half b."""
    return wrap(np.stack(np.broadcast_arrays(np.asarray(a, np.int64),
                                             np.asarray(b, np.int64))))


def splat(v):
    return halves(v, v)


def to_u32(w):
    """Halves -> the uint32 word the kernel stores."""
    return ((w[0] & 0xFFFF) | ((w[1] & 0xFFFF) << 16)).astype(np.uint32)


def from_u32(u):
    u = np.asarray(u, np.int64)
    return halves(u & 0xFFFF, u >> 16)


def viaddmax_s16x2(a, b, c):
    """__viaddmax_s16x2: per half max(a + b, c), the sum in int16."""
    return np.maximum(wrap(a + b), c)


def viaddmax_s16x2_relu(a, b, c):
    """__viaddmax_s16x2_relu: per half max(a + b, c, 0)."""
    return np.maximum(np.maximum(wrap(a + b), c), 0)


def vimax3_s16x2(a, b, c):
    """__vimax3_s16x2: per half max(a, b, c)."""
    return np.maximum(np.maximum(a, b), c)


P1, P8, PM1, PM6, PNEG = (splat(v) for v in (1, 8, -1, -6, NEG))
P1, P8, PM1, PM6, PNEG = (w[:, None] for w in (P1, P8, PM1, PM6, PNEG))


def cell(x, y, g_diag, g_left, e, f):
    """One packed cell, as the kernel's row step: (E, G = H - 6, the next
    row's F) from the read and haplotype words, G of the diagonal and of
    the left cell, E of the left cell and F of this one. ~ of a half that
    holds a byte shifted left by 3 (x ^ y, 0 to 2040) is -(x ^ y) - 1, as
    the kernel's 32-bit ~ leaves it in each half."""
    e = viaddmax_s16x2(e, PM1, g_left)
    q = viaddmax_s16x2(~(x ^ y), P8, P1)
    t = viaddmax_s16x2_relu(g_diag, q, e)
    t6 = viaddmax_s16x2(t, PM6, PM6)
    g = viaddmax_s16x2(f, PM6, t6)
    f = viaddmax_s16x2(f, PM1, t6)
    return e, g, f


# ------------------------------------------------ the kernel's loop

def read_base(rows, lens, i, packed2):
    """read_base of every thread's row at read row i: the byte, or 0 past
    the read's length."""
    n = rows.shape[0]
    if packed2:
        if i // 4 >= rows.shape[1]:
            return np.zeros(n, np.int64)
        code = (rows[:, i >> 2].astype(np.int64) >> ((i & 3) * 2)) & 3
        b = BASES[code].astype(np.int64)
    else:
        if i >= rows.shape[1]:
            return np.zeros(n, np.int64)
        b = rows[:, i].astype(np.int64)
    return np.where(i < lens, b, 0)


def true_lengths(rows, pad):
    nz = rows != pad
    return np.where(nz.any(1), rows.shape[1] - np.argmax(nz[:, ::-1], 1), 0)


def packed_launch(reads, haps, idx_ref, idx_alt, per_read, codes,
                  read_lens=None):
    """sw_pair16x2_kernel over one launch, every thread at once: int32
    scores [per_read, R] or int8 codes [R]. reads: uint8 [R, lx] dense or
    [R, lx // 4] 2-bit codes with read_lens; haps uint8 [H, ly]. A pair
    runs to its longer haplotype rounded up to COLS columns, the pad byte
    1 past it. A thread past its columns or strips computes on, as a
    warp's idle lane would, but stores nothing and leaves its best
    alone."""
    packed2 = read_lens is not None
    R = reads.shape[0]
    lx = 4 * reads.shape[1] if packed2 else reads.shape[1]
    ly = haps.shape[1]
    n_prob = R * per_read
    n_pairs = (n_prob + 1) // 2
    k = np.arange(n_pairs)
    shared = per_read == 2
    read0 = k if shared else 2 * k
    has1 = np.full(n_pairs, True) if shared else 2 * k + 1 < n_prob
    read1 = read0 if shared else np.where(has1, read0 + 1, read0)
    if packed2:
        lens = np.clip(read_lens.astype(np.int64), 0, lx)
    else:
        lens = true_lengths(reads, 0)
    len0 = lens[read0]
    len1 = len0 if shared else np.where(has1, lens[read1], 0)
    h0 = idx_ref[read0]
    h1 = idx_alt[read0] if shared else idx_ref[read1]
    hap_len = true_lengths(haps, 1)
    n_x = np.maximum(len0, len1)
    n_y = np.maximum(hap_len[h0], np.where(has1, hap_len[h1], 0))
    live = (n_x > 0) & (n_y > 0)
    n_strips = np.where(live, (n_x + STRIP - 1) // STRIP, 0)
    n_cols = (n_y + COLS - 1) // COLS * COLS
    scratch = np.zeros((-(-ly // COLS) * COLS, n_pairs, 2),
                       np.uint32)  # [column][thread]
    best = np.repeat(PM6, n_pairs, 1)
    rows0, rows1 = reads[read0], reads[read1]
    for s in range(int(n_strips.max(initial=0))):
        in_strip = s < n_strips
        xs = []
        for r in range(STRIP):
            b0 = read_base(rows0, len0, s * STRIP + r, packed2)
            b1 = b0 if shared else read_base(rows1, len1, s * STRIP + r,
                                             packed2)
            xs.append(halves(b0 << 3, b1 << 3))
        g = [np.repeat(PM6, n_pairs, 1) for _ in range(STRIP)]
        e = [np.repeat(PNEG, n_pairs, 1) for _ in range(STRIP)]
        first = s == 0
        last = s == n_strips - 1
        g_up_prev = np.repeat(PM6, n_pairs, 1)
        for j in range(int(n_cols[in_strip].max(initial=0))):
            act = in_strip & (j < n_cols)
            jj = min(j, ly - 1)
            y = halves(np.where(j < n_y, haps[h0, jj], 1).astype(np.int64)
                       << 3,
                       np.where(j < n_y, haps[h1, jj], 1).astype(np.int64)
                       << 3)
            if first:
                g_up = np.repeat(PM6, n_pairs, 1)
                f = np.repeat(PNEG, n_pairs, 1)
            else:
                g_up = from_u32(scratch[j, :, 0])
                f = from_u32(scratch[j, :, 1])
            diag = g_up_prev
            g_up_prev = g_up
            b = best
            for r in range(STRIP):
                e[r], g_r, f = cell(xs[r], y, diag, g[r], e[r], f)
                diag = g[r]
                g[r] = g_r
                if r & 1:
                    b = vimax3_s16x2(b, g[r - 1], g[r])
            best = np.where(act, b, best)
            keep = act & ~last
            scratch[j, keep, 0] = to_u32(g[STRIP - 1])[keep]
            scratch[j, keep, 1] = to_u32(f)[keep]
    s0, s1 = best + 6
    if codes:
        code = np.where(s0 > s1, 1, np.where(s1 > s0, 2, 3))
        return np.where((s0 < MIN_SCORE) & (s1 < MIN_SCORE), 0,
                        code).astype(np.int8)
    if shared:
        return np.stack([s0, s1]).astype(np.int32)
    out = np.empty((1, R), np.int32)
    out[0, read0] = s0
    out[0, read1[has1]] = s1[has1]
    return out


# ------------------------------------------------ inputs

def pair_case(seed, R, lx, ly, n_haps=None):
    """R reads of 1..lx bases; haplotypes of 0..ly bases, about half of
    them holding a read (with an edit or two), ref and alt of a read drawn
    independently, so their lengths differ."""
    rng = np.random.default_rng(seed)
    H = n_haps or 2 * R
    x = np.zeros((R, lx), np.uint8)
    lens = rng.integers(1, lx + 1, R)
    for i in range(R):
        x[i, : lens[i]] = rng.choice(BASES, lens[i])
    haps = np.ones((H, ly), np.uint8)
    for h in range(H):
        n = int(rng.integers(0, ly + 1))
        haps[h, :n] = rng.choice(BASES, n)
        r = int(rng.integers(0, R))
        if rng.random() < 0.5 and n:
            m = min(n, int(lens[r]))
            s = int(rng.integers(0, n - m + 1))
            seg = x[r, :m].copy()
            if m > 4 and rng.random() < 0.5:  # an indel in the copy
                p = int(rng.integers(1, m - 2))
                seg = np.concatenate([seg[:p], seg[p + 1 :], BASES[:1]])
            haps[h, s : s + m] = seg[:m]
            if rng.random() < 0.3:
                haps[h, s + int(rng.integers(0, m))] = BASES[
                    int(rng.integers(0, 4))]
    idx_ref = rng.integers(0, H, R).astype(np.int32)
    idx_alt = rng.integers(0, H, R).astype(np.int32)
    return x, haps, idx_ref, idx_alt


def pack2(x):
    codes = np.searchsorted(BASES, np.where(x == 0, 65, x))
    out = np.zeros((x.shape[0], x.shape[1] // 4), np.uint8)
    for k in range(4):
        out |= (codes[:, k::4] << (2 * k)).astype(np.uint8)
    return out, (x != 0).sum(1).astype(np.int32)


def plain(x, haps, idx_ref, idx_alt):
    t = sw_cuda.from_numpy(x, haps, idx_ref, idx_alt, "cpu")
    scores = sw_torch.pair_scores(*t)
    return scores.numpy(), sw_torch.calls_from_scores(scores).numpy()


# ------------------------------------------------ the loop, exact

@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), R=st.integers(1, 9),
       lx4=st.integers(1, 20), ly=st.integers(1, 80))
def test_packed_loop_matches_plain(seed, R, lx4, ly):
    # true lengths 1..80 (read buckets a multiple of 4 for the 2-bit
    # entry), strip edges included; odd read counts; ref and alt of
    # different lengths; dense and 2-bit reads; scores and codes
    x, haps, ir, ia = pair_case(seed, R, 4 * lx4, ly)
    exp, exp_codes = plain(x, haps, ir, ia)
    np.testing.assert_array_equal(packed_launch(x, haps, ir, ia, 2, False),
                                  exp)
    np.testing.assert_array_equal(packed_launch(x, haps, ir, ia, 2, True),
                                  exp_codes)
    xp, lens = pack2(x)
    np.testing.assert_array_equal(
        packed_launch(xp, haps, ir, ia, 2, True, read_lens=lens), exp_codes)
    # one problem per read (batch_scores): two reads per thread
    rows = torch.from_numpy(haps[ir])
    np.testing.assert_array_equal(
        packed_launch(x, haps, ir, ir, 1, False)[0],
        sw_torch.sw_scores(torch.from_numpy(x), rows).numpy())


@pytest.mark.parametrize("lx, ly", [(16, 20), (32, 80), (48, 64), (80, 80)])
@pytest.mark.parametrize("seed", [3, 4])
def test_packed_loop_matches_jax_k3(lx, ly, seed):
    # K3, the production TPU kernel, in interpret mode: 256 reads (two
    # per lane of its 128), read lengths across 32-row strip edges
    x, haps, ir, ia = pair_case(100 * seed + lx + ly, 256, lx, ly,
                                n_haps=96)
    idx2 = np.stack([ir, ia], 1).reshape(-1)
    exp = np.asarray(_sw_pair_quad(x, haps, idx2, lx=lx, ly=ly,
                                   interpret=True))
    np.testing.assert_array_equal(packed_launch(x, haps, ir, ia, 2, False),
                                  exp)
    exp_codes = np.asarray(_sw_pair_quad_calls(x, haps, idx2, lx=lx, ly=ly,
                                               interpret=True))
    np.testing.assert_array_equal(packed_launch(x, haps, ir, ia, 2, True),
                                  exp_codes)
    xp, lens = pack2(x)
    exp_p2 = np.asarray(_sw_pair_quad_calls_p2(xp, lens, haps, idx2, lx=lx,
                                               ly=ly, interpret=True))
    np.testing.assert_array_equal(exp_p2, exp_codes)
    np.testing.assert_array_equal(
        packed_launch(xp, haps, ir, ia, 2, True, read_lens=lens), exp_p2)


@pytest.mark.parametrize("seed", [5, 6])
def test_packed_loop_matches_jax_k2_read_longer(seed):
    # lx > ly, where the JAX package runs the chained kernel K2
    # (`_sw_pair_chained`) in place of K3
    x, haps, ir, ia = pair_case(seed, 128, 80, 20, n_haps=64)
    idx2 = np.stack([ir, ia], 1).reshape(-1)
    exp = np.asarray(_sw_pair_chained(x, haps, idx2, lx=80, ly=20,
                                      interpret=True))
    np.testing.assert_array_equal(packed_launch(x, haps, ir, ia, 2, False),
                                  exp)


def test_packed_loop_empty_and_one_strip_problems():
    # empty haplotypes, one-base reads, a lone last read of per_read == 1
    x = np.zeros((3, 16), np.uint8)
    x[0, :1] = BASES[:1]
    x[1, :16] = np.resize(BASES, 16)
    x[2, :5] = BASES[[1, 2, 3, 0, 1]]
    haps = np.ones((3, 24), np.uint8)
    haps[1, :16] = np.resize(BASES, 16)
    haps[2, :3] = BASES[[2, 3, 0]]
    ir = np.array([1, 1, 2], np.int32)
    ia = np.array([0, 0, 0], np.int32)
    got = packed_launch(x, haps, ir, ia, 2, False)
    np.testing.assert_array_equal(got, plain(x, haps, ir, ia)[0])
    assert got[:, 1].tolist() == [16, 0]
    np.testing.assert_array_equal(
        packed_launch(x, haps, ir, ir, 1, False)[0],
        sw_torch.sw_scores(torch.from_numpy(x),
                           torch.from_numpy(haps[ir])).numpy())


# ------------------------------------------------ the int16 edges

def test_emulated_add_wraps_within_its_half():
    # the emulation wraps as an int16 half does, and no borrow or carry
    # crosses halves: so a wrap in the loop would show as a wrong score
    w = viaddmax_s16x2(halves(32767, -32768), halves(1, -1), splat(-32768))
    assert w.tolist() == [-32768, 32767]
    w = viaddmax_s16x2(halves(0, 5), halves(-6, 0), splat(-32768))
    assert w.tolist() == [-6, 5]
    assert from_u32(to_u32(halves(-30006, 32767))).tolist() == [-30006,
                                                                32767]


def word(a, b=None):
    """One thread's word [2, 1]: low half a, high half b (default a)."""
    return halves(a, a if b is None else b)[:, None]


def values(w):
    return tuple(int(v) for v in np.ravel(w))


@pytest.mark.parametrize("h_diag, match, expect", [
    (32766, True, 32767),   # H = 32,767, the largest the route holds
    (32767, False, 32762),
    (0, False, 0),          # a diag of 0 plus -5, below the zero floor
    (0, True, 1),
    (5, False, 0),
    (6, False, 1),
])
def test_cell_exact_at_int16_edges(h_diag, match, expect):
    # one cell with no gap open: H = max(H_diag + s, 0) in both halves
    x = word(ord("A") << 3)
    y = word((ord("A") if match else ord("C")) << 3)
    e, g, f = cell(x, y, word(h_diag - 6), PM6, PNEG, PNEG)
    assert values(g + 6) == (expect, expect)
    assert values(e) == (-6, -6)                 # max(kNeg - 1, -6)
    assert values(f) == (expect - 6,) * 2        # max(kNeg - 1, H - 6)


def test_cell_gaps_at_int16_edges():
    # E and F from H near 32,767 to the left and above, and kNeg - 1
    x, y = word(ord("A") << 3), word(ord("C") << 3)
    e, g, f = cell(x, y, PM6, word(32761), word(32700), word(32760))
    assert values(e) == (32761, 32761)           # H_left - 6
    assert values(g) == (32755, 32755)           # H = 32,761
    assert values(f) == (32759, 32759)           # F - 1
    e, g, f = cell(x, y, PM6, PM6, PNEG, PNEG)
    assert values(e) + values(g) + values(f) == (-6,) * 6
    e, g, _ = cell(x, y, PM6, word(NEG), PNEG, PNEG)
    assert values(e) == (NEG, NEG)               # max(kNeg - 1, kNeg)
    assert values(g) == (-6, -6)                 # max(kNeg - 6, -6)


def test_low_and_high_half_stay_apart():
    # a match in one half and a mismatch in the other, at H = 0 and near
    # the top: no borrow or carry between the two problems
    x = word(ord("A") << 3)
    y = word(ord("A") << 3, ord("G") << 3)
    _, g, _ = cell(x, y, word(32760), PM6, PNEG, PNEG)
    assert values(g + 6) == (32767, 32761)
    _, g, _ = cell(x, y, PM6, PM6, PNEG, PNEG)
    assert values(g + 6) == (1, 0)


# ------------------------------------------------ routes and scratch

@pytest.mark.parametrize("lx, ly, route", [
    (32767, 32767, "packed"),
    (32767, 100000, "packed"),
    (160, 224, "packed"),
    (32768, 32768, "word32"),
    (32842, 32840, "word32"),    # chip_smoke's near_limit family
    (65535, 65535, "word32"),
    (65535, 100000, "word32"),
    (65536, 65536, "word64"),
    (65604, 70000, "word64"),    # chip_smoke's wide_full_family
])
def test_pair_route_by_width(lx, ly, route):
    assert sw_cuda.pair_route(lx, ly) == route
    assert sw_cuda.pair_route(ly, lx) == route
    assert sw_cuda.wide_word(lx, ly) is (route == "word64")


@SETTINGS
@given(n_reads=st.integers(1, 3000),
       lx=st.sampled_from([17, 32, 33, 160, 32767, 32768, 65536]),
       ly=st.sampled_from([1, 223, 224, 4032, 32767, 100000]),
       per_read=st.sampled_from([1, 2]),
       budget=st.integers(0, 1 << 31))
def test_packed_scratch_within_budget(n_reads, lx, ly, per_read, budget):
    # the scratch a launch allocates: the first range's problems (pairs on
    # the packed route) x the bytes of one problem; within the budget
    # unless one read alone exceeds it, plus the empty half of an odd
    # range's last pair of plain rows
    route = sw_cuda.pair_route(lx, ly)
    per_problem = sw_cuda.dp_scratch_bytes(lx, ly)
    packed = route == "packed"
    columns = ly + ly % sw_cuda.PACKED_COLS if packed else ly
    one_strip = lx <= (sw_cuda.PACKED_STRIP if packed else sw_cuda.PAIR_STRIP)
    assert per_problem == (0 if one_strip else
                           columns * (8 if route == "word64" else 4))
    ranges = sw_cuda.read_ranges(n_reads, lx, ly, per_read, budget)
    for r0, r1 in ranges:
        n = (r1 - r0) * per_read
        held = sw_cuda.pair_scratch_problems([(r0, r1)], per_read, route)
        assert held == (n + n % 2 if route == "packed" else n)
        if r1 - r0 > 1:
            assert n * per_problem <= budget
            assert held * per_problem <= budget + per_problem
    first = sw_cuda.pair_scratch_problems(ranges, per_read, route)
    assert first == max(sw_cuda.pair_scratch_problems([r], per_read, route)
                        for r in ranges)


def test_packed_scratch_pairs_of_reads():
    # per_read == 2: a thread's pair is one read, 8 bytes per column
    ranges = sw_cuda.read_ranges(65536, 160, 224, 2, sw_cuda.DP_SCRATCH_BYTES)
    assert ranges == [(0, 65536)]
    n = sw_cuda.pair_scratch_problems(ranges, 2, "packed")
    assert n * sw_cuda.dp_scratch_bytes(160, 224) == 65536 * 224 * 8
    assert sw_cuda.pair_scratch_problems([(0, 301)], 1, "packed") == 302
    assert sw_cuda.pair_scratch_problems([(0, 301)], 1, "word32") == 301


def test_forced_route_must_be_known():
    t = sw_cuda.from_numpy(np.zeros((1, 16), np.uint8),
                           np.ones((1, 16), np.uint8),
                           np.zeros(1, np.int32), np.zeros(1, np.int32),
                           "cpu")
    with pytest.raises(ValueError):
        sw_cuda._launch(*t[:1], None, *t[1:], 2, False, route="int16")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
def test_kernel_routes_agree_on_card(cuda_device):
    x, haps, ir, ia = pair_case(9, 2048, 80, 96, n_haps=64)
    exp, exp_codes = plain(x, haps, ir, ia)
    t = sw_cuda.from_numpy(x, haps, ir, ia, cuda_device)
    for route in sw_cuda.PAIR_ROUTES:
        np.testing.assert_array_equal(
            sw_cuda.pair_scores(*t, route=route).cpu().numpy(), exp)
        np.testing.assert_array_equal(
            sw_cuda.pair_calls(*t, route=route).cpu().numpy(), exp_codes)
    with pytest.raises(RuntimeError):
        sw_cuda.pair_scores(*sw_cuda.from_numpy(
            np.zeros((1, 32768), np.uint8), np.ones((1, 32768), np.uint8),
            np.zeros(1, np.int32), np.zeros(1, np.int32), cuda_device),
            route="packed")
