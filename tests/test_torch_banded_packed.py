"""sw_banded's packed route (csrc/sw_banded.cu, two banded problems per
thread in the int16 halves of 32-bit words, 16x2 DPX), on the CPU.

The CUDA kernel does not run here, so its loop is transliterated to numpy:
every thread of a launch at once, its 8-row strips over the union of both
problems' bands, the zones (entry and exit masked per half from int16
column offsets, the core free) in steps of two columns that a warp's
lanes take together, the scratch that hands a strip's bottom row to the
next at offsets from the strip's first column (one buffer while a strip
starts at or right of the one above), and each 16x2 DPX intrinsic
emulated half by half with int16 wrap-around
(tests/test_torch_sw_packed.py). The kernel's haplotype window only
changes how a row's bytes are loaded, so the loop reads them byte by
byte. The transliteration is held exact against the plain version
(ops/sw_banded_torch.py), the JAX package's banded TPU kernel K4 (Pallas
in interpret mode) and its native banded aligner, in both layouts of
problems: a read's (ref, alt) pair and plain rows. Inputs are made with
numpy from seeds; the tolerance is exact equality. Also here: the route
selector (sw_cuda.banded_route), the scratch of the packed route and
chip_smoke.py's count of the cells the loops visit. The card-marked case
holds the kernel's routes against the plain version on a GPU."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from test_torch_band_build import box_bands, strip_loop
from test_torch_banded import _seqs, family, pair_case
from test_torch_sw_packed import (P1, P8, PM1, PM6, from_u32, halves,
                                  splat, to_u32, true_lengths,
                                  viaddmax_s16x2, viaddmax_s16x2_relu,
                                  vimax3_s16x2)
from vartrix_tpu.ops.sw_native import banded_sw_chained_batch_native
from vartrix_tpu.ops.sw_pallas_v2 import make_banded_tpu_scorer
from vartrix_tpu_torch.ops import (band_torch, sw_banded_torch, sw_cuda,
                                   sw_native, sw_torch)

BASES = np.frombuffer(b"ACGT", np.uint8)
STRIP = 8     # kStrip of csrc/sw_banded.cu
COLS = 2      # kCols: columns per step of the packed loop
PMIN = splat(-32768)[:, None]
SETTINGS = settings(max_examples=25, deadline=None, derandomize=True,
                    database=None)


# ------------------------------------------------ the kernel's loop

def warp_steps(run, c0, a, b, c1):
    """The packed loop's zones of each thread's strip, in steps of COLS
    columns from c0, taken by the warp's running lanes together (32
    threads per warp): (entry steps, the step the core ends at, all
    steps), those of a thread's warp."""
    warp = np.arange(len(c0)) // 32

    def reduce(v, ufunc, init):
        out = np.full(warp[-1] + 1, init, np.int64)
        ufunc.at(out, warp[run], v[run])
        return out[warp]

    n_entry = reduce(-(-(a - c0) // COLS), np.maximum, 0)
    n_core = np.maximum(reduce((b - c0) // COLS, np.minimum, 1 << 40),
                        n_entry)
    return n_entry, n_core, reduce(-(-(c1 - c0) // COLS), np.maximum, 0)


def packed_banded_launch(reads, haps, idx_ref, idx_alt, jlo, jhi, per_read,
                         codes=False, cells=None):
    """sw_banded16x2_kernel over one launch, every thread at once: int32
    scores [per_read, R] or int8 codes [R]. reads uint8 [R, lx], haps
    uint8 [H, ly], jlo/jhi int32 [lx, per_read * R] (problem p in column
    p; thread k owns problems 2k and 2k + 1). A thread whose strip runs no
    step computes on, as a warp's idle lane would, but stores nothing and
    leaves its best alone. cells: a dict that gets the problem cells the
    threads visit ("visited") and compute in their cores ("core")."""
    R, lx = reads.shape
    ly = haps.shape[1]
    n_prob = per_read * R
    n_pairs = (n_prob + 1) // 2
    k = np.arange(n_pairs)
    shared = per_read == 2
    read0 = k if shared else 2 * k
    has1 = np.full(n_pairs, True) if shared else 2 * k + 1 < n_prob
    read1 = read0 if shared else np.where(has1, read0 + 1, read0)
    lens = true_lengths(reads, 0)
    len0 = lens[read0]
    len1 = len0 if shared else np.where(has1, lens[read1], 0)
    h0 = idx_ref[read0]
    h1 = idx_alt[read0] if shared else idx_ref[read1]
    p1 = np.minimum(2 * k + 1, n_prob - 1)
    buffer = -(-ly // COLS) * COLS
    scratch = np.zeros((2, buffer, n_pairs, 2), np.uint32)  # [column][k]
    best = np.repeat(PM6, n_pairs, 1)
    pv_lo = np.zeros(n_pairs, np.int64)
    pv_w = np.zeros(n_pairs, np.int64)
    in_buf = np.zeros(n_pairs, np.int64)  # the buffer the strip above wrote
    n_strips = -(-lx // STRIP)
    for s in range(n_strips):
        rows = s * STRIP + np.arange(STRIP)
        ic = np.minimum(rows, lx - 1)[:, None]
        in_lx = (rows < lx)[:, None]

        def load(b):  # [2, STRIP, n_pairs]: each half's bounds, 0 outside
            return np.stack([np.where(in_lx, b[ic, 2 * k], 0),
                             np.where(in_lx & has1, b[ic, p1], 0)]
                            ).astype(np.int64)

        lo, hi = load(jlo), load(jhi)
        band = lo < hi
        live = rows[None, :, None] < np.stack([len0, len1])[:, None, :]
        c0 = np.maximum(np.where(band, lo, ly).min((0, 1)), 0)
        c1 = np.minimum(np.where(band, hi, 0).max((0, 1)), ly)
        run = c0 < c1
        core_lo = np.where(live, lo, 0).max((0, 1))
        core_hi = np.where(live, hi, ly).min((0, 1))
        a = np.maximum(c0, np.minimum(core_lo, c1))
        b = np.maximum(a, np.minimum(core_hi, c1))
        n_entry, n_core, n_steps = warp_steps(run, c0, a, b, c1)
        # the masks' bounds: offsets from c0, lo - 1 and -hi in halves
        lo1 = halves(*(np.clip(lo - c0, 0, 32767) - 1))
        nhi = halves(*(-np.maximum(np.minimum(hi, ly) - c0, 0)))
        xs = []
        for r in rows:
            b0 = np.where(r < len0, reads[read0, min(r, lx - 1)], 0)
            b1 = b0 if shared else np.where(r < len1,
                                            reads[read1, min(r, lx - 1)], 0)
            xs.append(halves(b0.astype(np.int64) << 3,
                             b1.astype(np.int64) << 3))
        g = [np.repeat(PM6, n_pairs, 1) for _ in range(STRIP)]
        e = [np.repeat(PM6, n_pairs, 1) for _ in range(STRIP)]
        last = s == n_strips - 1
        # the strip writes over the words it reads when it starts at or
        # right of the strip above, else into the other buffer
        out_buf = np.where(c0 >= pv_lo, in_buf, in_buf ^ 1)

        def above(j):  # (G, F) of the strip above at column j
            off = j - pv_lo
            ok = (off >= 0) & (off < pv_w)
            off = np.clip(off, 0, buffer - 1)
            return (np.where(ok, from_u32(scratch[in_buf, off, k, 0]), PM6),
                    np.where(ok, from_u32(scratch[in_buf, off, k, 1]), PM6))

        g_up_prev = np.where(c0 > 0, above(c0 - 1)[0], PM6)
        width = np.where(run, COLS * n_steps, 0)
        if cells is not None:
            core = np.where(run, COLS * (n_core - n_entry), 0)
            cells["visited"] = (cells.get("visited", 0)
                                + 2 * STRIP * int(width.sum()))
            cells["core"] = cells.get("core", 0) + 2 * STRIP * int(core.sum())
        for t in range(0, int(width.max(initial=0)), COLS):
            m = t // COLS
            for d in range(COLS):
                j = c0 + t + d
                act = t + d < width
                masked = (m < n_entry) | (m >= n_core)
                jc = np.minimum(j, ly - 1)
                y = halves(np.where(j < ly, haps[h0, jc], 1).astype(np.int64)
                           << 3,
                           np.where(j < ly, haps[h1, jc], 1).astype(np.int64)
                           << 3)
                g_up, f = above(j)
                diag, g_up_prev = g_up_prev, g_up
                bb = best
                for r in range(STRIP):
                    e[r] = viaddmax_s16x2(e[r], PM1, g[r])
                    q = viaddmax_s16x2(~(xs[r] ^ y), P8, P1)
                    tt = viaddmax_s16x2_relu(diag, q, e[r])
                    t6 = viaddmax_s16x2(tt, PM6, PM6)
                    diag = g[r]
                    gn = viaddmax_s16x2(f, PM6, t6)
                    f = viaddmax_s16x2(f, PM1, t6)
                    v = viaddmax_s16x2(lo1[:, r], splat(-(j - c0)),
                                       viaddmax_s16x2(splat(j - c0),
                                                      nhi[:, r], PMIN))
                    keep = ~masked | (v < 0)
                    g[r] = np.where(keep, gn, PM6)
                    f = np.where(keep, f, PM6)
                    if r & 1:
                        bb = vimax3_s16x2(bb, g[r - 1], g[r])
                best = np.where(act, bb, best)
                if not last:
                    st_k = k[act]
                    off = (j - c0)[act]
                    scratch[out_buf[act], off, st_k, 0] = to_u32(
                        g[STRIP - 1])[act]
                    scratch[out_buf[act], off, st_k, 1] = to_u32(f)[act]
        pv_lo = np.where(run, c0, 0)
        pv_w = width
        in_buf = np.where(run, out_buf, in_buf)
    s0, s1 = best + 6
    if codes:
        code = np.where(s0 > s1, 1, np.where(s1 > s0, 2, 3))
        return np.where((s0 < 25) & (s1 < 25), 0, code).astype(np.int8)
    if shared:
        return np.stack([s0, s1]).astype(np.int32)
    out = np.empty((1, R), np.int32)
    out[0, read0] = s0
    out[0, read1[has1]] = s1[has1]
    return out


# ------------------------------------------------ inputs

def plain(x, haps, ir, ia, jlo, jhi):
    t = [torch.from_numpy(np.ascontiguousarray(v))
         for v in (x, haps, ir, ia, jlo, jhi)]
    scores = sw_banded_torch.banded_pair_scores(*t)
    return scores.numpy(), sw_torch.calls_from_scores(scores).numpy()


def bounds(x, haps, ir, ia=None):
    """Band bounds from the plain band builder: [lx, 2R] for a read's
    pair, [lx, R] for plain rows (ia None)."""
    t = [torch.from_numpy(np.ascontiguousarray(v)) for v in (x, haps, ir)]
    alt = None if ia is None else torch.from_numpy(ia)
    return tuple(v.numpy() for v in band_torch.band_bounds(*t, alt))


def parted_case(seed=71, R=48, lx=48, ly=160, indel=48):
    """Reads of a haplotype and its alt, the same with `indel` bases
    deleted (even seeds) or inserted (odd) at its middle, each read across
    the indel: on one side of it the read's ref and alt bands lie `indel`
    columns apart, more than a band's width (~41), so a thread's two bands
    part."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(BASES, ly - indel)
    mid = len(ref) // 2
    if seed % 2:
        alt = np.concatenate([ref[:mid], rng.choice(BASES, indel),
                              ref[mid:]])
    else:
        alt = np.concatenate([ref[:mid], ref[mid + indel :]])
    haps = np.ones((2, ly), np.uint8)
    haps[0, : len(ref)] = ref
    haps[1, : len(alt)] = alt
    x = np.zeros((R, lx), np.uint8)
    for r in range(R):
        src = (ref, alt)[r % 2]
        n = int(rng.integers(lx - 6, lx + 1))
        o = int(np.clip(mid - int(rng.integers(8, n - 8)), 0, len(src) - n))
        x[r, :n] = src[o : o + n]
    idx = np.zeros(R, np.int32)
    return x, haps, idx, idx + 1


def short_reads_case(seed=73, R=33, ly=40):
    """Reads of one strip or less (1 to 8 bases), some copied from their
    haplotypes; haplotypes of 0 to ly bases."""
    rng = np.random.default_rng(seed)
    x = np.zeros((R, 8), np.uint8)
    haps = np.ones((2 * R, ly), np.uint8)
    for r in range(R):
        for h in (2 * r, 2 * r + 1):
            m = int(rng.integers(0, ly + 1))
            haps[h, :m] = rng.choice(BASES, m)
        n = int(rng.integers(1, 9))
        m = int((haps[2 * r] != 1).sum())
        if m >= n and rng.random() < 0.6:
            o = int(rng.integers(0, m - n + 1))
            x[r, :n] = haps[2 * r, o : o + n]
        else:
            x[r, :n] = rng.choice(BASES, n)
    idx = np.arange(R, dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


PAIR_CASES = {
    "snv_indel_reads": lambda: pair_case(seed=79, R=64, lx=40, ly=72),
    "parted_deletion": lambda: parted_case(seed=70),
    "parted_insertion": lambda: parted_case(seed=71),
    "one_strip_reads": short_reads_case,
    "empty_haps": lambda: pair_case(seed=83, R=40, H=8, lx=24, ly=48),
}


# ------------------------------------------------ the loop, exact

@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_packed_loop_pairs_match_plain_and_native(name):
    # per_read 2: a read's ref (low half) and alt (high half), their bases
    # shared; scores and codes
    x, haps, ir, ia = PAIR_CASES[name]()
    jlo, jhi = bounds(x, haps, ir, ia)
    exp, exp_codes = plain(x, haps, ir, ia, jlo, jhi)
    np.testing.assert_array_equal(
        packed_banded_launch(x, haps, ir, ia, jlo, jhi, 2), exp)
    np.testing.assert_array_equal(
        packed_banded_launch(x, haps, ir, ia, jlo, jhi, 2, codes=True),
        exp_codes)
    xs, _ = _seqs(x, x)
    native = np.stack([banded_sw_chained_batch_native(
        xs, _seqs(haps[i], haps[i])[1], 2) for i in (ir, ia)])
    np.testing.assert_array_equal(exp, native)
    assert exp.max() > 0
    if name.startswith("parted"):
        # rows whose ref and alt bands do not meet
        gap = np.maximum(jlo[:, 1::2] - jhi[:, 0::2],
                         jlo[:, 0::2] - jhi[:, 1::2])
        assert (gap > 0).any()


@pytest.mark.parametrize("name", ["seed17", "short", "unseeded",
                                  "empty_haps", "odd_bytes"])
def test_packed_loop_plain_rows_match_k4(name):
    # per_read 1: two unrelated plain rows per thread, an odd count (the
    # last row paired with an empty problem), against K4 in interpret mode
    x, y = family(name, B=129)
    ident = np.arange(len(x), dtype=np.int32)
    jlo, jhi = bounds(x, y, ident)
    got = packed_banded_launch(x, y, ident, ident, jlo, jhi, 1)[0]
    np.testing.assert_array_equal(got, make_banded_tpu_scorer(2)(x, y))
    np.testing.assert_array_equal(
        got, sw_banded_torch.banded_scores(
            *(torch.from_numpy(v) for v in (x, y, jlo, jhi))).numpy())


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), R=st.integers(1, 9),
       lx=st.integers(1, 40), ly=st.integers(20, 60),
       per_read=st.sampled_from([1, 2]))
def test_packed_loop_arbitrary_bounds_match_plain(seed, R, lx, ly,
                                                  per_read):
    # bounds of any kind (box_bands: negative, past ly, empty rows inside
    # and above the read, staircases, full boxes) in both layouts: the
    # masks and zones alone keep the kernel exact
    x, y, jlo, jhi = box_bands(seed=seed, B=per_read * R, lx=lx, ly=ly)
    if per_read == 2:
        x = x[::2].copy()
        ir = np.arange(0, 2 * R, 2, dtype=np.int32)
        ia = ir + 1
        exp = plain(x, y, ir, ia, jlo, jhi)[0]
    else:
        ir = ia = np.arange(R, dtype=np.int32)
        exp = sw_banded_torch.banded_scores(
            *(torch.from_numpy(v) for v in (x, y, jlo, jhi))).numpy()[None]
    np.testing.assert_array_equal(
        packed_banded_launch(x, y, ir, ia, jlo, jhi, per_read), exp)


def limit_case(seed=97, ly=32767):
    """Reads against a haplotype of ly = 32,767 bases, the packed route's
    limit: copies of its last 40 bases (bounds near 32,767), one with an
    indel, and reads shorter than k = 6, whose band is every column (a
    strip as wide as the haplotype)."""
    rng = np.random.default_rng(seed)
    hap = rng.choice(BASES, ly)
    alt = hap.copy()
    alt[ly - 20] = BASES[(np.searchsorted(BASES, alt[ly - 20]) + 1) % 4]
    reads = [hap[-40:], np.concatenate([hap[-40:-25], hap[-24:]]),
             hap[-5:], hap[100:104], rng.choice(BASES, 40)]
    x = np.zeros((len(reads), 40), np.uint8)
    for i, r in enumerate(reads):
        x[i, : len(r)] = r
    idx = np.zeros(len(reads), np.int32)
    return x, np.stack([hap, alt]), idx, idx + 1


@pytest.mark.parametrize("per_read", [1, 2])
def test_packed_loop_at_the_haplotype_limit(per_read):
    # offsets from a strip's first column up to 32,767 and bounds at
    # 32,767 fit the int16 halves; a column past ly takes the scalar route
    x, haps, ir, ia = limit_case()
    assert sw_cuda.banded_route(x.shape[1], haps.shape[1]) == "packed"
    assert sw_cuda.banded_route(x.shape[1], haps.shape[1] + 1) == "word32"
    jlo, jhi = sw_native.band_bounds(x, haps, ir, ia, 2)
    assert jhi.max() == 32_767 and (jhi - jlo).max() == 32_767
    exp = plain(x, haps, ir, ia, jlo, jhi)[0]
    assert exp[0, 0] == 40 and exp[0, 2] == 5
    if per_read == 2:
        got = packed_banded_launch(x, haps, ir, ia, jlo, jhi, 2)
    else:  # three plain rows of the ref problems, an odd count, bounds
        # near 32,767 (the full-band strip, 32,767 columns, is the pair
        # mode's: one such case is enough for the numpy loop's time)
        rows = [0, 1, 4]
        ident = np.arange(len(rows), dtype=np.int32)
        got = packed_banded_launch(x[rows], haps[ir[rows]], ident, ident,
                                   np.ascontiguousarray(jlo[:, 0::2][:, rows]),
                                   np.ascontiguousarray(jhi[:, 0::2][:, rows]),
                                   1)
        exp = exp[:1, rows]
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("name", ["parted_deletion", "snv_indel_reads"])
def test_smoke_zone_counts_are_the_loops(name):
    # chip_smoke.py's strip_stats, which phase 4 reports, counts the cells
    # the packed loop visits and computes in its cores, and those of the
    # scalar loop (test_torch_band_build's transliteration); a parted
    # pair's union costs the packed route core cells
    x, haps, ir, ia = PAIR_CASES[name]()
    jlo, jhi = bounds(x, haps, ir, ia)
    lens = np.repeat(true_lengths(x, 0), 2)
    ly = haps.shape[1]
    cells = {}
    packed_banded_launch(x, haps, ir, ia, jlo, jhi, 2, cells=cells)
    assert chip_smoke.strip_stats(lens, jlo, jhi, ly, packed=True)[:2] == (
        cells["visited"], cells["core"])
    h = np.stack([ir, ia], 1).reshape(-1)
    scalar = np.array([strip_loop(x[p // 2], haps[h[p]], jlo[:, p],
                                  jhi[:, p])[1:] for p in range(len(h))])
    assert chip_smoke.strip_stats(lens, jlo, jhi, ly)[:2] == tuple(
        int(v) for v in scalar.sum(0))
    in_band = int((jhi.astype(np.int64) - jlo).sum())
    assert cells["core"] < in_band < cells["visited"]
    if name.startswith("parted"):
        ref = [np.ascontiguousarray(b[:, 0::2].repeat(2, 1))
               for b in (jlo, jhi)]
        assert chip_smoke.strip_stats(lens, *ref, ly, packed=True)[1] > \
            cells["core"]


# ------------------------------------------------ routes and scratch

@pytest.mark.parametrize("lx, ly, route", [
    (160, 224, "packed"),
    (40000, 224, "packed"),      # H <= 224: a long read stays packed
    (32768, 32767, "packed"),    # the packed limit family
    (160, 32768, "word32"),      # a column offset past an int16
    (160, 40000, "word32"),      # bounds past an int16
    (160, 100000, "word32"),     # chip_smoke's long haplotype family
    (65535, 65535, "word32"),
    (65536, 65536, "word64"),
    (65604, 70000, "word64"),    # chip_smoke's wide_full_family
])
def test_banded_route_by_width(lx, ly, route):
    # packed while ly fits an int16; past it a scalar route by the width
    # of its scratch word
    assert sw_cuda.banded_route(lx, ly) == route
    if route != "packed":
        assert sw_cuda.wide_word(lx, ly) is (route == "word64")


@SETTINGS
@given(n_reads=st.integers(1, 3000),
       lx=st.sampled_from([8, 9, 160, 32767, 32768, 65536]),
       ly=st.sampled_from([1, 223, 224, 4032, 32767, 100000]),
       per_read=st.sampled_from([1, 2]),
       budget=st.integers(0, 1 << 31))
def test_packed_banded_scratch_within_budget(n_reads, lx, ly, per_read,
                                             budget):
    # two buffers of 8-byte pair words per column (half per problem) over
    # ly rounded up to two columns; ranges within the budget unless one
    # read alone exceeds it, plus the empty half of an odd range's last
    # pair of plain rows
    route = sw_cuda.banded_route(lx, ly)
    per_problem = sw_cuda.dp_scratch_bytes(lx, ly, banded=True)
    packed = route == "packed"
    columns = ly + ly % 2 if packed else ly
    word = 8 if route == "word64" else 4
    assert per_problem == (0 if lx <= STRIP else 2 * columns * word)
    ranges = sw_cuda.read_ranges(n_reads, lx, ly, per_read, budget,
                                 banded=True)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_reads
    for r0, r1 in ranges:
        n = (r1 - r0) * per_read
        held = sw_cuda.pair_scratch_problems([(r0, r1)], per_read, route)
        assert held == (n + n % 2 if packed else n)
        if r1 - r0 > 1:
            assert n * per_problem <= budget
            assert held * per_problem <= budget + per_problem


def test_packed_banded_scratch_of_the_main_shape():
    # 65,536 reads of 160 against 224: one launch, two buffers of 224
    # columns of one (G, F) pair per read
    ranges = sw_cuda.read_ranges(65536, 160, 224, 2, sw_cuda.DP_SCRATCH_BYTES,
                                 banded=True)
    assert ranges == [(0, 65536)]
    n = sw_cuda.pair_scratch_problems(ranges, 2, "packed")
    assert n * sw_cuda.dp_scratch_bytes(160, 224, True) == 2 * 224 * 8 * 65536
    assert sw_cuda.banded_scratch_bytes(160, 223, "packed") == 8 * 224
    assert sw_cuda.banded_scratch_bytes(160, 223, "word32") == 2 * 223 * 4


def test_forced_banded_route_must_be_known():
    x, haps, ir, ia = short_reads_case(R=2)
    t = sw_cuda.from_numpy(x, haps, ir, ia, "cpu")
    z = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        sw_cuda._launch_banded(*t, z, z, False, route="int16")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
def test_banded_kernel_routes_agree_on_card(cuda_device):
    x, haps, ir, ia = pair_case(seed=89, R=2047, lx=160, ly=224)
    jlo, jhi = sw_native.band_bounds(x, haps, ir, ia, 2)
    exp, exp_codes = plain(x, haps, ir, ia, jlo, jhi)
    t = [torch.from_numpy(v).to(cuda_device)
         for v in (x, haps, ir, ia, jlo, jhi)]
    rows_lo, rows_hi = (torch.from_numpy(np.ascontiguousarray(b[:, 0::2]))
                        .to(cuda_device) for b in (jlo, jhi))
    y = t[1][t[2].long()]
    for route in sw_cuda.PAIR_ROUTES:
        np.testing.assert_array_equal(
            sw_cuda.banded_pair_scores(*t, route=route).cpu().numpy(), exp)
        np.testing.assert_array_equal(
            sw_cuda.banded_pair_calls(*t, route=route).cpu().numpy(),
            exp_codes)
        np.testing.assert_array_equal(  # 2,047 plain rows: an odd count
            sw_cuda.banded_scores(t[0], y, rows_lo, rows_hi,
                                  route=route).cpu().numpy(), exp[0])
    z = torch.zeros((16, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError):  # a column offset past an int16
        sw_cuda.banded_pair_scores(*sw_cuda.from_numpy(
            np.zeros((1, 16), np.uint8), np.ones((1, 32768), np.uint8),
            np.zeros(1, np.int32), np.zeros(1, np.int32), cuda_device),
            z, z, route="packed")
