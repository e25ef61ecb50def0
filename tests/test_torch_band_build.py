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


# ------------------------------------- the band builder's chain pass

K, W, MAX_PRED = 6, 20, 64
RING = 8  # chunks of matches a warp keeps in shared memory (kRing)
INT32_MAX, INT32_MIN = 2**31 - 1, -2**31
LANES = np.arange(32)


def link_keys(link, near, i, j):
    """The kernel's `link_key` over 32 lanes: each lane's link (i, j, sc;
    i = INT32_MAX: none) as a candidate for match (i, j), score x 64 +
    nearness when the link lies before (i, j) in both coordinates and
    beats the start score, else 0; kK - overlap as a three-way minimum,
    the gap penalty as g + 5 min(g, 1)."""
    li, lj, lsc = (a.astype(np.int64) for a in link)
    di, dj = i - li, j - lj
    step = np.minimum(np.minimum(di, dj), K)
    g = np.abs(di - dj)
    sc = lsc + step - (g + 5 * np.minimum(g, 1))
    return np.where((step > 0) & (sc > K), sc * MAX_PRED + near, 0)


def lookup_run(x, keys, i, n_j):
    """The kernel's `lookup`: the run [lo, hi) of keys (uint64 [n_j],
    sorted) matching read position i: its start by a binary search, its
    end by galloping from there and a binary search within the last
    gallop."""
    kx = sum(int(x[i + t]) << (8 * t) for t in range(K))
    lo = hi = int(np.searchsorted(keys, kx, "left"))
    if lo < n_j and keys[lo] == kx:  # keys[hi] == kx
        step = 1
        while hi + step < n_j and keys[hi + step] == kx:
            hi += step
            step *= 2
        end = min(hi + step, n_j)
        hi += 1 + int(np.searchsorted(keys[hi + 1 : end], kx, "right"))
    return lo, hi


def chain_pass(x, y, hkeys, hpos):
    """Python transliteration of csrc/band_build.cu's chain pass for one
    problem: uint8 read x [lx] against haplotype y [ly] with its index
    (hkeys, hpos: its 6-mer keys sorted by (key, j) and their positions)
    -> int32 (jlo, jhi) [lx]. chain_dp: the runs of 32 read positions
    (lookup_run), their matches laid into the chunk's 32 lanes by a search
    over the runs' starts, one warp step per match (each lane's two links, cur and prev, at nearness
    (lane - t) & 63 and that ^ 32; the warp maximum of the keys; lane t's
    link and key), the chunk's first match of its greatest score if above
    the best, the chunk kept in the ring of the last RING chunks with each
    match's predecessor distance (the chunk it displaces to the scratch),
    cur and prev swapped. chain_fill: the traceback over the chunks from
    the best match, read from the ring or the scratch (a chunk's anchors:
    the ancestors of its entry lane, every lane's found by doubling; each
    anchor's diagonal trimmed where the next anchor on its diagonal takes
    over and its box left out within 15 rows of it), then the corner
    diagonals; the rows' min/max in the order the lanes apply them. Then
    the kernel's bounds of each row."""
    lx = len(x)
    len_x = int(np.flatnonzero(x != 0)[-1]) + 1 if (x != 0).any() else 0
    len_y = int(np.flatnonzero(y != 1)[-1]) + 1 if (y != 1).any() else 0
    jlo, jhi = np.zeros(lx, np.int32), np.zeros(lx, np.int32)
    if len_x and len_y and (len_x < K or len_y < K):  # a short pair
        jhi[:len_x] = len_y
        return jlo, jhi
    n_i, n_j = len_x - K + 1, len_y - K + 1
    if n_i <= 0 or n_j <= 0:
        return jlo, jhi
    keys = hkeys[:n_j].astype(np.uint64)
    cur = [np.full(32, INT32_MAX, np.int64), np.zeros(32, np.int64),
           np.zeros(32, np.int64)]
    prev = [a.copy() for a in cur]
    ci, cj, ck = (np.zeros(32, np.int64) for _ in range(3))
    ring, scratch = [None] * RING, []  # chunks: 32 of (i, j, distance)
    st = dict(filled=0, base=0, best_sc=-1, best_a=0)

    def dp_chunk(n):
        for t in range(n):
            i, j = ci[t], cj[t]
            near = (LANES - t) & (MAX_PRED - 1)
            key = int(np.maximum(link_keys(cur, near, i, j),
                                 link_keys(prev, near ^ 32, i, j)).max())
            sc = max(key // MAX_PRED, K)
            cur[0][t], cur[1][t], cur[2][t] = ci[t], cj[t], sc
            ck[t] = key
        # the chunk's first match of its greatest score, if above the best
        top = int(cur[2][:n].max())
        if top > st["best_sc"]:
            st["best_sc"] = top
            st["best_a"] = st["base"] + int(np.flatnonzero(cur[2][:n] ==
                                                           top)[0])
        # the ring's slot hands its chunk, RING back, to the scratch
        slot = (st["base"] // 32) % RING
        if st["base"] >= 32 * RING:
            scratch.extend(ring[slot])
        ring[slot] = list(zip(
            ci.tolist(), cj.tolist(),
            np.where(ck > 0, MAX_PRED - ck % MAX_PRED, 0).tolist()))[:n]

    for i0 in range(0, n_i, 32):
        lo, hi = np.zeros(32, np.int64), np.zeros(32, np.int64)
        for lane in range(min(32, n_i - i0)):
            lo[lane], hi[lane] = lookup_run(x, keys, i0 + lane, n_j)
        incl = np.cumsum(hi - lo)
        excl = incl - (hi - lo)
        total, m0 = int(incl[31]), 0
        while m0 < total:
            filled = st["filled"]
            take = min(32 - filled, total - m0)
            for lane in range(filled, filled + take):
                m, src = m0 + lane - filled, 0
                for b in (16, 8, 4, 2, 1):
                    if excl[src + b] <= m:
                        src += b
                ci[lane] = i0 + src
                cj[lane] = hpos[lo[src] + m - excl[src]]
            st["filled"] = filled + take
            m0 += take
            if st["filled"] == 32:
                dp_chunk(32)
                cur, prev = prev, cur
                st["base"] += 32
                st["filled"] = 0
    if st["filled"]:
        dp_chunk(st["filled"])
    count = st["base"] + st["filled"]
    if count == 0:  # no band
        return jlo, jhi
    rlo = np.full(len_x, INT32_MAX, np.int64)
    rhi = np.full(len_x, INT32_MIN, np.int64)

    def widen(r, a, b):
        rlo[r] = min(rlo[r], a)
        rhi[r] = max(rhi[r], b)

    def diag(r0, r1, d):
        for r in range(r0, r1):
            widen(r, max(0, r + d - W), min(len_y, r + d + W + 1))

    c, has_next = st["best_a"], False
    next_i = next_j = back_i = back_j = 0
    in_ring = (count + 31) // 32 - RING  # the first chunk in the ring
    while c >= 0:
        chunk = c & ~31
        held = (ring[(chunk // 32) % RING] if chunk // 32 >= in_ring
                else scratch[chunk : chunk + 32])
        ai, aj, ad = (list(v) + [0] * (32 - len(held)) for v in zip(*held))
        t = c - chunk
        if c == st["best_a"]:
            back_i, back_j = ai[t], aj[t]
        # each lane's ancestors in the chunk by doubling: a mask, and the
        # 2^k-th ancestor (itself when it has none in the chunk)
        up = [l - ad[l] if 0 < ad[l] <= l else l for l in range(32)]
        anc = [1 << l for l in range(32)]
        for _ in range(5):
            anc = [anc[l] | anc[up[l]] for l in range(32)]
            up = [up[up[l]] for l in range(32)]
        on = anc[t]
        first = (on & -on).bit_length() - 1
        c = chunk + first - ad[first] if ad[first] else -1
        for lane in range(32):
            if not (on >> lane) & 1:
                continue
            above = [l for l in range(lane + 1, 32) if (on >> l) & 1]
            succ = bool(above) or has_next
            si, sj = ((ai[above[0]], aj[above[0]]) if above
                      else (next_i, next_j))
            d = aj[lane] - ai[lane]
            r1 = min(ai[lane] + K + W, len_x)
            box = succ
            if succ and sj - si == d:
                r1 = min(r1, si - W)
                box = si - ai[lane] > W - K + 1
            diag(max(ai[lane] - W, 0), r1, d)
            if box:
                for r in range(max(0, ai[lane]), min(len_x, si + K)):
                    widen(r, max(0, aj[lane]), min(len_y, sj + K))
        next_i, next_j, has_next = ai[first], aj[first], True
    back = min(next_i, next_j)
    diag(max(next_i - back - W, 0), min(next_i + W, len_x), next_j - next_i)
    i1, j1 = back_i + K, back_j + K
    diag(max(i1 - W, 0), min(i1 + min(len_x - i1, len_y - j1) + W, len_x),
         j1 - i1)
    band = rlo < rhi
    jlo[:len_x] = np.where(band, rlo, 0)
    jhi[:len_x] = np.where(band, rhi, 0)
    return jlo, jhi


CHAIN_CASES = {**{n: (lambda n=n: rows_case(n)) for n in BOUND_FAMILIES},
               "repetitive": repetitive_case,
               "indels": lambda: pair_case(seed=67, R=120)}


@pytest.mark.parametrize("per_read", [1, 2])
@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_chain_pass_transliteration_matches_plain_and_host(name, per_read):
    x, haps, idx_ref, idx_alt = CHAIN_CASES[name]()
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (x, haps, idx_ref, idx_alt)]
    index = band_torch.band_index(t[1])
    hkeys, hpos = index.keys.numpy(), index.pos.numpy()
    P = per_read * len(x)
    got = np.zeros((2, x.shape[1], P), np.int32)
    for p, read, which in kernel_problems(len(x), per_read):
        h = (idx_ref, idx_alt)[which][read]
        got[0, :, p], got[1, :, p] = chain_pass(x[read], haps[h], hkeys[h],
                                                hpos[h])
    plain = band_torch.band_bounds(*t[:3], t[3] if per_read == 2 else None)
    host = sw_native.band_bounds(x, haps, idx_ref,
                                 idx_alt if per_read == 2 else idx_ref, 2)
    for k in range(2):
        np.testing.assert_array_equal(got[k], plain[k].numpy())
        np.testing.assert_array_equal(
            got[k], host[k] if per_read == 2 else host[k][:, 0::2])
    assert got[1].any() != (name == "unseeded")  # bands, but unseeded


# ------------------------------- the kernels' two layouts of problems

def kernel_problems(n_reads, per_read):
    """Python transliteration of the problem mapping of csrc/band_build.cu
    `load_problem` and csrc/sw_banded.cu `sw_banded_kernel` (sw_pair.cu's
    convention): a launch over n_reads reads has per_read * n_reads
    problems; per_read == 2, problem p is read p >> 1 against idx_ref (p
    even) or idx_alt (p odd); per_read == 1, read p against idx_ref[p].
    Yields (p, read, which): which 0 idx_ref, 1 idx_alt; the score goes to
    row `which`, column `read` of the [per_read, n_reads] output."""
    for p in range(per_read * n_reads):
        pair = per_read == 2
        yield p, p >> 1 if pair else p, (p & 1) if pair else 0


@pytest.mark.parametrize("per_read", [1, 2])
def test_problem_mapping_transliteration_matches_plain(per_read):
    x, haps, idx_ref, idx_alt = pair_case(seed=59, R=24, lx=40, ly=64)
    t = [torch.from_numpy(a) for a in (x, haps, idx_ref, idx_alt)]
    alt = t[3] if per_read == 2 else None
    jlo, jhi = (b.numpy() for b in band_torch.band_bounds(*t[:3], alt))
    assert jlo.shape == (x.shape[1], per_read * len(x))
    got = np.zeros((per_read, len(x)), np.int32)
    for p, read, which in kernel_problems(len(x), per_read):
        h = (idx_ref, idx_alt)[which][read]
        lo, hi = band_torch.band_bounds(t[0][read : read + 1],
                                        t[1][h : h + 1],
                                        torch.zeros(1, dtype=torch.int32))
        np.testing.assert_array_equal(jlo[:, p], lo[:, 0].numpy())
        np.testing.assert_array_equal(jhi[:, p], hi[:, 0].numpy())
        got[which, read], _, _ = strip_loop(x[read], haps[h], jlo[:, p],
                                            jhi[:, p])
    if per_read == 2:
        exp = sw_banded_torch.banded_pair_scores(
            *t, torch.from_numpy(jlo), torch.from_numpy(jhi)).numpy()
    else:
        exp = _plain_scores(x, haps[idx_ref], jlo, jhi)[None]
    np.testing.assert_array_equal(got, exp)
    assert exp.max() > 0


def test_plain_row_codes_refused():
    # a call code fuses a read's (ref, alt) pair: plain rows have none
    x, haps, idx_ref, _ = pair_case(seed=61, R=8, lx=24, ly=32)
    t = [torch.from_numpy(a) for a in (x, haps, idx_ref)]
    z = torch.zeros((24, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="call codes"):
        sw_cuda._launch_banded(*t, None, z, z, True)


# ------------------------------- the chain pass's problem ranges

@pytest.mark.parametrize("route", ["global", "shared"])
@pytest.mark.parametrize("counts, lx, budget", [
    ([0] * 7, 10, 1 << 30),                 # no matches: one range
    ([5, 0, 3, 9, 1, 2, 0, 4], 4, 200),     # several ranges
    ([1, 1000, 1, 1], 2, 100),              # one problem over the budget
    ([20] * 9, 3, 12 * 20 + 24),            # exactly one problem per range
])
def test_band_ranges_cover_problems_within_budget(counts, lx, budget, route):
    ends = np.cumsum(np.array(counts, np.int64))
    ranges = sw_cuda.band_ranges(ends, lx, budget, route)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(counts)
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0  # in order, no gap, no overlap
    # the global route's work rows take 8 bytes per read row; the shared
    # route keeps them on the chip
    need = [12 * c + (8 * lx if route == "global" else 0) for c in counts]
    for p0, p1 in ranges:
        assert p1 > p0
        assert p1 - p0 == 1 or sum(need[p0:p1]) <= budget
        if p1 < len(counts):  # greedy: the next problem would not fit
            assert sum(need[p0:p1 + 1]) > budget


def test_band_route_by_width():
    assert sw_cuda.band_route(160) == "shared"
    assert sw_cuda.band_route(sw_cuda.BAND_SHARED_LX) == "shared"
    assert sw_cuda.band_route(sw_cuda.BAND_SHARED_LX + 1) == "global"
    assert sw_cuda.band_route(65_602) == "global"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("name", ["repetitive", "pairs_indels_empty_hap",
                                  "wide_40000", "shorter_than_k"])
def test_band_build_kernel_matches_plain_on_card(cuda_device, name, route,
                                                 monkeypatch):
    # the global route is forced on these narrow reads by its width limit
    if route == "global":
        monkeypatch.setattr(sw_cuda, "BAND_SHARED_LX", 0)
    x, haps, idx_ref, idx_alt = CASES[name]()
    assert sw_cuda.band_route(x.shape[1]) == route
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
