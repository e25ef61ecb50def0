"""The port's Smith-Waterman pair scoring (vartrix_tpu_torch/ops) against
the JAX package's kernel entries, run as the JAX tests run them (Pallas in
interpret mode on the CPU). Inputs are made with numpy from a seed and fed
to both sides as the same arrays; the tolerance is exact equality.

On the CPU the port's wrappers take the plain PyTorch version; the cases
marked `cuda` hold the CUDA kernel against it on a GPU."""

import numpy as np
import pytest
import torch

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.core.agg_numpy import codes_from_scores
from vartrix_tpu.ops.sw_numpy import sw_score_single
from vartrix_tpu.ops.sw_pallas import _on_tpu, sw_scores_batch_tpu
from vartrix_tpu.ops.sw_pallas_v2 import (_sw_pair_chained, _sw_pair_chainN,
                                          _sw_pair_quad,
                                          _sw_pair_quad_calls, _unpack2,
                                          sw_calls_pair_quad_tpu,
                                          sw_scores_batch_tpu_v2,
                                          sw_scores_pair_quad_tpu)
from vartrix_tpu_torch.ops import sw_cuda, sw_torch

BASES = np.frombuffer(b"ACGT", np.uint8)


def port_pair(x, haps, idx_ref, idx_alt, codes=False, device="cpu"):
    t = sw_cuda.from_numpy(x, haps, idx_ref, idx_alt, device)
    fn = sw_cuda.pair_calls if codes else sw_cuda.pair_scores
    return fn(*t).cpu().numpy()


def quad_case(seed=31, R=256, lx=32, ly=48, empty=(7, 1)):
    """tests/test_sw.py's quad-chain family: random reads, haplotypes with
    embedded reads, one empty alt haplotype."""
    rng = np.random.default_rng(seed)
    x = np.zeros((R, lx), np.uint8)
    haps = np.ones((2 * R, ly), np.uint8)
    for i in range(R):
        xl = int(rng.integers(1, lx + 1))
        x[i, :xl] = rng.choice(BASES, xl)
        for w in range(2):
            if (i, w) == empty:
                continue  # empty haplotype -> score 0
            yl = int(rng.integers(1, ly + 1))
            hap = rng.choice(BASES, yl)
            if rng.random() < 0.5 and yl > xl:
                s = int(rng.integers(0, yl - xl + 1))
                hap[s : s + xl] = x[i, :xl]
            haps[2 * i + w, :yl] = hap
    idx2 = np.arange(2 * R, dtype=np.int32)
    return x, haps, idx2


def mixed_gap_cases():
    cases = []
    for flank in (6, 10, 14):
        for ins in (1, 2, 3):
            x = b"A" * flank + b"C" + b"G" * flank
            y = b"A" * flank + b"T" * (ins + 1) + b"G" * flank
            cases.append((x, y))
            cases.append((y, x))
    return cases


def pack_rows(rows, width, pad):
    out = np.full((len(rows), width), pad, np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = np.frombuffer(r, np.uint8)
    return out


def test_quad_scores_match_jax():
    x, haps, idx2 = quad_case()
    exp = np.asarray(_sw_pair_quad(x, haps, idx2, lx=32, ly=48,
                                   interpret=not _on_tpu()))
    got = port_pair(x, haps, idx2[0::2], idx2[1::2])
    np.testing.assert_array_equal(got, exp)
    assert got[1, 7] == 0  # the empty haplotype


def test_quad_calls_match_jax():
    x, haps, idx2 = quad_case(seed=5)
    exp = np.asarray(_sw_pair_quad_calls(x, haps, idx2, lx=32, ly=48,
                                         interpret=not _on_tpu()))
    got = port_pair(x, haps, idx2[0::2], idx2[1::2], codes=True)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, exp)


def test_chained_scores_read_longer_than_haplotype():
    # lx > ly: the bucket family where the JAX quad kernel is infeasible
    # and the chained v5 kernel runs
    rng = np.random.default_rng(13)
    R, lx, ly = 128, 64, 32
    x = np.zeros((R, lx), np.uint8)
    haps = np.ones((2 * R, ly), np.uint8)
    for i in range(R):
        xl = int(rng.integers(20, lx + 1))
        x[i, :xl] = rng.choice(BASES, xl)
        for w in range(2):
            yl = int(rng.integers(1, ly + 1))
            hap = rng.choice(BASES, yl)
            if rng.random() < 0.5:
                s = int(rng.integers(0, xl - yl + 1)) if xl > yl else 0
                hap[: min(yl, xl)] = x[i, s : s + min(yl, xl)]
            haps[2 * i + w, :yl] = hap
    idx2 = np.arange(2 * R, dtype=np.int32)
    exp = np.asarray(_sw_pair_chained(x, haps, idx2, lx=lx, ly=ly,
                                      interpret=not _on_tpu()))
    got = port_pair(x, haps, idx2[0::2], idx2[1::2])
    np.testing.assert_array_equal(got, exp)


def test_batch_rows_match_jax():
    rng = np.random.default_rng(7)
    rows_x, rows_y = [], []
    for _ in range(48):
        lx, ly = int(rng.integers(1, 49)), int(rng.integers(1, 73))
        xb = rng.choice(BASES, lx)
        yb = rng.choice(BASES, ly)
        if rng.random() < 0.3 and ly > 10:
            s = int(rng.integers(0, ly - 5))
            m = min(lx, ly - s)
            yb[s : s + m] = xb[:m]
        rows_x.append(xb.tobytes())
        rows_y.append(yb.tobytes())
    xs, ys = pack_rows(rows_x, 48, 0), pack_rows(rows_y, 72, 1)
    exp = sw_scores_batch_tpu_v2(xs, ys)
    got = sw_cuda.batch_scores(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_array_equal(got.numpy(), exp)


def test_k6_plain_rows_match_jax_v1_kernel():
    # K6, the v1 kernel of plain (x, y) rows (sw_pallas.py `_sw_kernel`):
    # its counterpart is batch_scores, the pair kernel with identity indices
    rng = np.random.default_rng(11)
    rows_x, rows_y = [], []
    for _ in range(40):
        lx, ly = int(rng.integers(1, 41)), int(rng.integers(1, 57))
        xb = rng.choice(BASES, lx)
        yb = rng.choice(BASES, ly)
        if rng.random() < 0.4 and ly > 8:
            s = int(rng.integers(0, ly - 4))
            m = min(lx, ly - s)
            yb[s : s + m] = xb[:m]
        rows_x.append(xb.tobytes())
        rows_y.append(yb.tobytes())
    xs, ys = pack_rows(rows_x, 40, 0), pack_rows(rows_y, 56, 1)
    exp = sw_scores_batch_tpu(xs, ys)
    got = sw_cuda.batch_scores(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_array_equal(got.numpy(), exp)


def test_k5_chain_n_matches_jax():
    # K5, the nr-read chain kernel (sw_pallas_v2.py `_sw_kernel_v7`) on
    # tests/test_sw.py's family: interleaved (ref, alt) rows idx2 are the
    # pair entry's idx_ref = idx2[0::2], idx_alt = idx2[1::2]
    lx, ly, nr, R = 16, 48, 4, 512
    rng = np.random.default_rng(41)
    x = np.zeros((R, lx), np.uint8)
    haps = np.ones((2 * R, ly), np.uint8)
    for i in range(R):
        xl = int(rng.integers(1, lx + 1))
        x[i, :xl] = rng.choice(BASES, xl)
        for w in range(2):
            yl = int(rng.integers(1, ly + 1))
            hap = rng.choice(BASES, yl)
            if rng.random() < 0.5 and yl > xl:
                s = int(rng.integers(0, yl - xl + 1))
                hap[s : s + xl] = x[i, :xl]
            haps[2 * i + w, :yl] = hap
    idx2 = rng.permutation(2 * R).astype(np.int32)
    exp = np.asarray(_sw_pair_chainN(x, haps, idx2, lx=lx, ly=ly, nr=nr,
                                     interpret=not _on_tpu()))
    np.testing.assert_array_equal(
        port_pair(x, haps, idx2[0::2], idx2[1::2]), exp)


def test_mixed_gap_adversarial_exact():
    cases = mixed_gap_cases()
    lxp = max(len(x) for x, _ in cases)
    lyp = max(len(y) for _, y in cases)
    xs = pack_rows([x for x, _ in cases], lxp, 0)
    ys = pack_rows([y for _, y in cases], lyp, 1)
    exp = sw_scores_batch_tpu_v2(xs, ys)
    assert exp.tolist() == [sw_score_single(x, y) for x, y in cases]
    got = sw_cuda.batch_scores(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_array_equal(got.numpy(), exp)
    # as both segments of a pair
    idx = np.arange(len(cases), dtype=np.int32)
    np.testing.assert_array_equal(port_pair(xs, ys, idx, idx),
                                  np.stack([exp, exp]))


def test_read_switch_no_leak():
    # read 2 embedded in read 1's alt haplotype (and vice versa): each read
    # scores only against its own haplotypes
    lx, ly = 32, 48
    r1 = (b"ACGT" * 8)[:lx]
    r2 = (b"TTGGCCAA" * 4)[:lx]
    cases = [b"A" * ly, (b"G" * 16 + r2[:lx])[:ly], (r1[16:] + b"C" * 32)[:ly],
             b"C" * ly]
    x = np.zeros((256, lx), np.uint8)
    haps = np.ones((512, ly), np.uint8)
    x[0] = np.frombuffer(r1, np.uint8)
    x[1] = np.frombuffer(r2, np.uint8)
    for w, h in enumerate(cases):
        haps[w, : len(h)] = np.frombuffer(h, np.uint8)
    idx2 = np.zeros(512, np.int32)
    idx2[:4] = [0, 1, 2, 3]
    exp = np.asarray(_sw_pair_quad(x, haps, idx2, lx=lx, ly=ly,
                                   interpret=not _on_tpu()))
    got = port_pair(x, haps, idx2[0::2], idx2[1::2])
    np.testing.assert_array_equal(got, exp)
    assert got[:, 0].tolist() == [sw_score_single(r1, cases[0]),
                                  sw_score_single(r1, cases[1])]


def test_unpack2_matches_jax():
    rng = np.random.default_rng(3)
    R, lx = 37, 48
    xp = rng.integers(0, 256, size=(R, lx // 4), dtype=np.uint8)
    xlen = rng.integers(0, lx + 1, size=R).astype(np.int32)
    exp = np.asarray(_unpack2(xp, xlen, lx))
    got = sw_torch.unpack2(torch.from_numpy(xp), torch.from_numpy(xlen), lx)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_two_bit_reads_match_dense():
    x, haps, idx2 = quad_case(seed=9)
    lens = (x != 0).sum(1).astype(np.int32)
    codes = np.zeros_like(x)
    for c, b in enumerate(b"ACGT"):
        codes[x == b] = c
    packed = np.zeros((x.shape[0], x.shape[1] // 4), np.uint8)
    for k in range(4):
        packed |= codes[:, k::4] << (2 * k)
    t = sw_cuda.from_numpy(x, haps, idx2[0::2], idx2[1::2], "cpu")
    dense = sw_cuda.pair_calls(*t)
    two_bit = sw_cuda.pair_calls(torch.from_numpy(packed), *t[1:],
                                 read_lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(two_bit.numpy(), dense.numpy())


@pytest.mark.parametrize("R", [1, 301])
def test_odd_read_count_calls_match_jax(R):
    rng = np.random.default_rng(37)
    H, lx, ly = 24, 32, 48
    x = np.zeros((R, lx), np.uint8)
    for i in range(R):
        n = int(rng.integers(8, lx + 1))
        x[i, :n] = rng.choice(BASES, n)
    haps = rng.choice(BASES, size=(H, ly)).astype(np.uint8)
    for i in range(0, R, 3):
        haps[i % H, 4 : 4 + lx - 8] = x[i, : lx - 8]
    idx_ref = rng.integers(0, H, size=R).astype(np.int32)
    idx_alt = rng.integers(0, H, size=R).astype(np.int32)
    exp = sw_calls_pair_quad_tpu(x, haps, idx_ref, idx_alt)
    np.testing.assert_array_equal(
        port_pair(x, haps, idx_ref, idx_alt, codes=True), exp)
    np.testing.assert_array_equal(
        codes_from_scores(port_pair(x, haps, idx_ref, idx_alt).T), exp)


def test_backend_chunks_and_two_bit_decline(monkeypatch):
    # the backend's chunk loop: several chunks, 2-bit reads until a chunk
    # holds a non-ACGT byte, dense from then on; same codes and scores as
    # the JAX quad entries
    rng = np.random.default_rng(53)
    R, H, lx, ly = 1000, 24, 32, 48
    x = np.zeros((R, lx), np.uint8)
    for i in range(R):
        n = int(rng.integers(8, lx + 1))
        x[i, :n] = rng.choice(BASES, n)
    x[700, 3] = ord("N")
    haps = rng.choice(BASES, size=(H, ly)).astype(np.uint8)
    for i in range(0, R, 3):
        haps[i % H, 4 : 4 + lx - 8] = x[i, : lx - 8]
    idx_ref = rng.integers(0, H, size=R).astype(np.int32)
    idx_alt = rng.integers(0, H, size=R).astype(np.int32)
    modes = []

    def provider(start, n):
        modes.append("dense")
        return x[start : start + n]

    def packed2(start, n):
        rows = x[start : start + n]
        if not np.isin(rows[rows != 0], BASES).all():
            return None
        codes = np.searchsorted(BASES, np.where(rows == 0, 65, rows))
        out = np.zeros((n, lx // 4), np.uint8)
        for k in range(4):
            out |= (codes[:, k::4] << (2 * k)).astype(np.uint8)
        modes.append("2bit")
        return out, (rows != 0).sum(1).astype(np.int32)

    provider.shape = x.shape
    provider.packed2 = packed2
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", 256)
    be = sw_cuda.SwBackend("cpu", kernel=False)
    got = be.pair_calls_chained(provider, haps, idx_ref, idx_alt)
    assert modes == ["2bit", "2bit", "dense", "dense"]
    np.testing.assert_array_equal(
        got, sw_calls_pair_quad_tpu(x, haps, idx_ref, idx_alt))
    np.testing.assert_array_equal(
        be.pair_chained(x, haps, idx_ref, idx_alt),
        sw_scores_pair_quad_tpu(x, haps, idx_ref, idx_alt))
    np.testing.assert_array_equal(
        be(x, haps[idx_ref]), sw_scores_batch_tpu_v2(x, haps[idx_ref]))


def test_backend_rejects_out_of_range_index():
    x, haps, idx2 = quad_case(R=8)
    be = sw_cuda.SwBackend("cpu", kernel=False)
    with pytest.raises(IndexError):
        be.pair_calls_chained(x, haps[:4], idx2[0::2], idx2[1::2])


def test_kernel_backend_needs_cuda_device():
    with pytest.raises(ValueError):
        sw_cuda.SwBackend("cpu", kernel=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("codes", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, codes):
    x, haps, idx2 = quad_case(seed=61, R=1024, lx=160, ly=224)
    exp = port_pair(x, haps, idx2[0::2], idx2[1::2], codes=codes)
    got = port_pair(x, haps, idx2[0::2], idx2[1::2], codes=codes,
                    device=cuda_device)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.cuda
def test_kernel_exact_near_scratch_limit(cuda_device):
    # a 2-base read insertion spanning a 16-row strip boundary after 32,783
    # matched bases: F near the top of the scratch word's 16-bit field
    # crosses the boundary
    rng = np.random.default_rng(71)
    n, p = 32840, 16 * 2049 - 1
    hap = rng.choice(BASES, n)
    read = np.concatenate([hap[:p], np.frombuffer(b"AC", np.uint8), hap[p:]])
    alt = hap.copy()
    alt[100] = BASES[(np.searchsorted(BASES, alt[100]) + 1) % 4]
    idx = np.zeros(1, np.int32)
    got = port_pair(read[None, :], np.stack([hap, alt]), idx, idx + 1,
                    device=cuda_device)
    assert got[:, 0].tolist() == [n - 7, n - 13]
