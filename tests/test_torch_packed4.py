"""The 4-bit read and haplotype route of the port, on the CPU, against the
JAX package: the packed gather (io/bam_native.gather_padded_packed), the
unpack (ops/sw_torch.unpack4), the plain 4-bit pair entries against K3's
4-bit entries in interpret mode, the haplotypes' PackedHaps
(core/fast_pipeline._maybe_pack_haps), sw_pair.cu's 4-bit base table, and a
CLI run on reads that carry N. Inputs are made with numpy from seeds; the
tolerance is exact equality. The card-marked case holds the kernel's three
read formats against each other on a GPU."""

import os
import re

import numpy as np
import pytest
import torch

from vartrix_tpu.core import fast_pipeline as jax_fast
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.io import bam_native as jax_bam_native
from vartrix_tpu.ops.sw_pallas_v2 import (PackedHaps as JaxPackedHaps,
                                          _sw_pair_quad,
                                          _sw_pair_quad_calls_packed,
                                          _sw_pair_quad_calls_packed2,
                                          _unpack4)
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.core import fast_pipeline
from vartrix_tpu_torch.driver import _main as port_main
from vartrix_tpu_torch.io import bam_native
from vartrix_tpu_torch.ops import sw_cuda, sw_torch
from vartrix_tpu_torch.utils import trace
from vartrix_tpu_torch.utils.synth import with_n_bases

NT16 = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
BASES = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"N=RYKMSWBDHV", np.uint8)
SW_PAIR_CU = os.path.join(os.path.dirname(sw_cuda.__file__), "..", "csrc",
                          "sw_pair.cu")


def pool_of(seqs):
    """A flat sequence pool and its offsets, as the BAM decode gives."""
    off = np.zeros(len(seqs) + 1, np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    pool = np.frombuffer(b"".join(seqs), np.uint8).copy()
    return pool, off


def pack4(x, lens):
    """uint8 [R, lx] SEQ_NT16 bytes (pad 0) -> [R, lx//2] nibbles, high
    first, positions past each length 0."""
    lut = np.zeros(256, np.uint8)
    lut[NT16] = np.arange(16, dtype=np.uint8)
    codes = np.where(np.arange(x.shape[1])[None, :] < lens[:, None],
                     lut[x], 0).astype(np.uint8)
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def iupac_case(seed, R, lx, ly, n_haps=64):
    """Reads cut from random haplotypes with substitutions, IUPAC bytes, N
    and '=' at seeded positions, odd lengths and some empty reads; returns
    (x uint8 [R, lx] pad 0, lens int32 [R], haps uint8 [H, ly] pad 1,
    idx_ref, idx_alt)."""
    rng = np.random.default_rng(seed)
    haps = np.ones((n_haps, ly), np.uint8)
    hl = rng.integers(1, ly + 1, n_haps)
    for h in range(n_haps):
        haps[h, : hl[h]] = rng.choice(BASES, hl[h])
    ir = rng.integers(0, n_haps, R).astype(np.int32)
    ia = rng.integers(0, n_haps, R).astype(np.int32)
    x = np.zeros((R, lx), np.uint8)
    lens = rng.integers(0, lx + 1, R).astype(np.int32)
    lens[rng.random(R) < 0.05] = 0
    for i in range(R):
        src = haps[ir[i] if i % 2 else ia[i]]
        m = int(lens[i])
        s = int(rng.integers(0, max(1, ly - m + 1)))
        row = np.where(src[s : s + m] == 1, BASES[0], src[s : s + m])
        x[i, : len(row)] = row
        x[i, len(row) : m] = rng.choice(BASES, m - len(row))
        odd = rng.random(m) < 0.05
        x[i, :m][odd] = rng.choice(IUPAC, int(odd.sum()))
    return x, lens, haps, ir, ia


# ------------------------------------------------ the gather


def test_gather_padded_packed_equal_to_jax():
    # every one of the 16 symbols, odd and even lengths, empty reads, reads
    # longer than lx (cut there)
    rng = np.random.default_rng(41)
    seqs = [NT16.tobytes(), NT16[::-1].tobytes(), b"", b"A", b"NNN"]
    seqs += [rng.choice(NT16, int(n)).tobytes()
             for n in rng.integers(0, 70, 200)]
    pool, off = pool_of(seqs)
    ids = rng.permutation(len(seqs)).astype(np.int64)
    for lx in (2, 16, 48, 64):
        got = bam_native.gather_padded_packed(pool, off, ids, lx)
        exp = jax_bam_native.gather_padded_packed(pool, off, ids, lx)
        assert got[0].dtype == np.uint8 and got[0].shape == (len(ids),
                                                             lx // 2)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
    empty = bam_native.gather_padded_packed(pool, off, ids[:0], 16)
    assert empty[0].shape == (0, 8) and empty[1].shape == (0,)


@pytest.mark.parametrize("bad", [b"ACGTa", b"ACGTX", b"\x01"])
def test_gather_padded_packed_declines_like_jax(bad):
    # a lowercase base or any byte outside the 16 symbols declines the
    # whole gather, in both packages
    pool, off = pool_of([b"ACGTN=", bad, b"ACMGR"])
    ids = np.arange(3, dtype=np.int64)
    assert bam_native.gather_padded_packed(pool, off, ids, 16) is None
    assert jax_bam_native.gather_padded_packed(pool, off, ids, 16) is None
    assert bam_native.gather_padded_packed(pool, off, ids[[0, 2]],
                                           16) is not None


def test_gather_padded_packed_declines_odd_lx():
    pool, off = pool_of([b"ACGT", b"NNA"])
    ids = np.arange(2, dtype=np.int64)
    assert bam_native.gather_padded_packed(pool, off, ids, 15) is None
    assert jax_bam_native.gather_padded_packed(pool, off, ids, 15) is None


# ------------------------------------------------ the unpack


@pytest.mark.parametrize("pad", [0, 1])
def test_unpack4_equal_to_jax(pad):
    rng = np.random.default_rng(5 + pad)
    lx = 38
    xp = rng.integers(0, 256, (57, lx // 2)).astype(np.uint8)
    lens = rng.integers(0, lx + 1, 57).astype(np.int32)
    got = sw_torch.unpack4(torch.from_numpy(xp), torch.from_numpy(lens), lx,
                           pad=pad)
    exp = np.asarray(_unpack4(xp, lens, lx, pad=pad))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), exp)


def test_kernel_base_table_is_seq_nt16():
    # sw_pair.cu unpacks a 4-bit base with two 64-bit constants, codes 0-7
    # and 8-15 a byte each, lowest first: the same 16 bytes as unpack4
    with open(SW_PAIR_CU) as f:
        src = f.read()
    words = [int(re.search(rf"kNt16{h}\s*=\s*(0x[0-9a-fA-F]+)ULL", src)
                 .group(1), 16) for h in ("Lo", "Hi")]
    table = b"".join(w.to_bytes(8, "little") for w in words)
    assert table == sw_torch.SEQ_NT16 == NT16.tobytes()
    codes = np.arange(16)
    w = np.where(codes & 8, words[1], words[0]).astype(np.uint64)
    got = (w >> ((codes & 7) * 8).astype(np.uint64)) & np.uint64(0xFF)
    np.testing.assert_array_equal(got.astype(np.uint8), NT16)


# ------------------------------------------------ the plain 4-bit entries


@pytest.mark.parametrize("lx, ly", [(32, 48), (48, 64), (64, 64)])
def test_plain_4bit_entry_equal_to_jax_k3(lx, ly):
    # K3's 4-bit read entry (_sw_pair_quad_calls_packed) and its entry with
    # haplotypes packed too (_packed2), in interpret mode: 256 reads, two
    # per lane of its 128
    x, lens, haps, ir, ia = iupac_case(lx + ly, 256, lx, ly)
    xp = pack4(x, lens)
    hlen = (haps != 1).sum(1).astype(np.int32)
    hp = pack4(np.where(haps == 1, 0, haps).astype(np.uint8), hlen)
    idx2 = np.stack([ir, ia], 1).reshape(-1)
    exp = np.asarray(_sw_pair_quad_calls_packed(xp, lens, haps, idx2, lx=lx,
                                                ly=ly, interpret=True))
    exp2 = np.asarray(_sw_pair_quad_calls_packed2(xp, lens, hp, hlen, idx2,
                                                  lx=lx, ly=ly,
                                                  interpret=True))
    exp_scores = np.asarray(_sw_pair_quad(x, haps, idx2, lx=lx, ly=ly,
                                          interpret=True))
    np.testing.assert_array_equal(exp2, exp)
    t = [torch.from_numpy(a) for a in (xp, haps, ir, ia, lens)]
    for fn in (sw_torch.pair_calls, sw_cuda.pair_calls):
        np.testing.assert_array_equal(
            fn(t[0], t[1], t[2], t[3], t[4], read_bits=4).numpy(), exp)
    for fn in (sw_torch.pair_scores, sw_cuda.pair_scores):
        np.testing.assert_array_equal(
            fn(t[0], t[1], t[2], t[3], t[4], read_bits=4).numpy(),
            exp_scores)
    # the haplotypes unpacked once, as device_haps does for a PackedHaps
    ht = sw_cuda.device_haps(sw_torch.PackedHaps(hp, hlen, haps),
                             torch.device("cpu"))
    np.testing.assert_array_equal(ht.numpy(), haps)


def test_read_bits_is_explicit():
    # the same bytes read as 2-bit and as 4-bit codes are different reads;
    # a width other than 2 or 4 is refused
    x, lens, haps, ir, ia = iupac_case(3, 16, 32, 48)
    t = [torch.from_numpy(a) for a in (pack4(x, lens), haps, ir, ia, lens)]
    dense = sw_torch.pair_scores(torch.from_numpy(x), *t[1:4])
    np.testing.assert_array_equal(
        sw_torch.pair_scores(*t, read_bits=4).numpy(), dense.numpy())
    assert sw_torch.dense_reads(t[0], t[4], 2).shape == (16, 64)
    for fn in (sw_torch.pair_scores, sw_cuda.pair_scores):
        with pytest.raises(ValueError):
            fn(*t, read_bits=3)


# ------------------------------------------------ the haplotypes


def hap_pool(rng, n, ly, lower=False):
    seqs = [rng.choice(NT16[1:] if i % 7 == 0 else BASES,
                       int(rng.integers(0, ly + 8))).tobytes()
            for i in range(n)]
    if lower:
        seqs[n // 2] = seqs[n // 2][:3] + b"a" + seqs[n // 2][4:]
    return pool_of(seqs)


@pytest.mark.parametrize("lower", [False, True])
def test_packed_haps_equal_to_jax(lower):
    # the bucket's 4-bit rows and lengths equal the JAX package's on the
    # rows the two share (JAX pads its matrix to a power of two of rows);
    # a lowercase base declines the bucket in both
    rng = np.random.default_rng(12)
    ly = 64
    pool, off = hap_pool(rng, 90, ly, lower)
    ids = rng.permutation(90)[:60].astype(np.int64)
    dense = fast_pipeline._gather_padded_pool(pool, off, ids, ly, pad_byte=1)
    got = fast_pipeline._maybe_pack_haps(pool, off, ids, ly, dense)
    jax_dense = jax_fast._quantize_hap_rows(
        jax_fast._gather_padded_pool(pool, off, ids, ly, pad_byte=1))
    exp = jax_fast._maybe_pack_haps(pool, off, ids, ly, jax_dense)
    if lower:
        assert got is dense and not isinstance(exp, JaxPackedHaps)
        return
    assert isinstance(got, sw_torch.PackedHaps)
    assert isinstance(exp, JaxPackedHaps)
    n = len(ids)
    np.testing.assert_array_equal(got.packed, exp.packed[:n])
    np.testing.assert_array_equal(got.lens, exp.lens[:n])
    assert not exp.packed[n:].any() and not exp.lens[n:].any()
    assert got.shape == dense.shape == (n, ly)
    assert np.asarray(got) is dense
    np.testing.assert_array_equal(np.asarray(got, dtype=np.int32),
                                  dense.astype(np.int32))
    ht = sw_cuda.device_haps(got, torch.device("cpu"))
    np.testing.assert_array_equal(ht.numpy(), dense)


def test_packed_haps_decline_odd_ly():
    rng = np.random.default_rng(13)
    pool, off = hap_pool(rng, 10, 33)
    ids = np.arange(10, dtype=np.int64)
    dense = fast_pipeline._gather_padded_pool(pool, off, ids, 33, pad_byte=1)
    assert fast_pipeline._maybe_pack_haps(pool, off, ids, 33, dense) is dense


def test_banded_backend_takes_dense_rows_of_packed_haps():
    # the banded backend shares the pipeline's bucket loop: a PackedHaps
    # reaches it as its dense matrix, never as packed rows
    x, lens, haps, ir, ia = iupac_case(21, 40, 32, 48, n_haps=12)
    hlen = (haps != 1).sum(1).astype(np.int32)
    ph = sw_torch.PackedHaps(
        pack4(np.where(haps == 1, 0, haps).astype(np.uint8), hlen), hlen,
        haps)
    be = sw_cuda.BandedSwBackend("cpu", kernel=False)
    np.testing.assert_array_equal(be.pair_calls_chained(x, ph, ir, ia),
                                  be.pair_calls_chained(x, haps, ir, ia))


# ------------------------------------------------ the CLI on reads with N


@pytest.fixture(scope="module")
def n_data(tmp_path_factory):
    d = generate_dataset(str(tmp_path_factory.mktemp("n_reads")), SynthConfig(
        n_variants=8, n_cells=25, reads_per_variant=25, seed=77,
        spliced_frac=0.3, indel_frac=0.2))
    bam = os.path.join(os.path.dirname(d["bam"]), "reads_n.bam")
    assert with_n_bases(d["bam"], bam, 0.2, 3) > 0
    return dict(d, bam=bam)


@pytest.mark.parametrize("mode", [["-s", "consensus"],
                                  ["-s", "coverage", "--umi"]])
def test_cli_on_n_reads_byte_equal_to_jax(tmp_path, n_data, mode, monkeypatch):
    def run(main, tag, extra):
        out = str(tmp_path / f"{tag}.mtx")
        ref = str(tmp_path / f"{tag}_ref.mtx")
        main(["-v", n_data["vcf"], "-b", n_data["bam"], "-f",
              n_data["fasta"], "-c", n_data["barcodes"], "-o", out,
              "--ref-matrix", ref] + mode + extra)
        with open(out, "rb") as f:
            got = f.read()
        if "--umi" not in mode:
            return got, None
        with open(ref, "rb") as f:
            return got, f.read()

    got = run(port_main, "port", ["--device", "cpu", "--backend", "torch"])
    counts = trace.counters()  # the port's run's, until the next _main
    exp = run(jax_main, "jax", ["--host", "native", "--backend", "tpu"])
    assert got == exp
    routes = {r: counts.get(f"route.read.{r}", 0)
              for r in ("p2", "p4", "dense")}
    assert routes["p4"] > 0 and routes["dense"] == 0, routes
    assert counts.get("route.hap.p4", 0) > 0
    assert counts.get("route.hap.dense", 0) == 0


# ------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("route", sw_cuda.PAIR_ROUTES)
def test_kernel_read_formats_equal_on_card(cuda_device, route):
    x, lens, haps, ir, ia = iupac_case(8, 512, 64, 96)
    acgt = np.where(np.isin(x, BASES) | (x == 0), x, BASES[0])
    xt, ht, irt, iat = sw_cuda.from_numpy(acgt, haps, ir, ia, cuda_device)
    lt = torch.from_numpy(lens).to(cuda_device)
    xp2 = np.zeros((len(x), 16), np.uint8)
    codes = np.searchsorted(BASES, np.where(acgt == 0, 65, acgt))
    for k in range(4):
        xp2 |= (codes[:, k::4] << (2 * k)).astype(np.uint8)
    plain = sw_torch.pair_scores(xt, ht, irt, iat)
    for reads, bits in ((xt, None), (torch.from_numpy(xp2).cuda(), 2),
                        (torch.from_numpy(pack4(acgt, lens)).cuda(), 4)):
        kw = {} if bits is None else dict(read_lens=lt, read_bits=bits)
        got = sw_cuda.pair_scores(reads, ht, irt, iat, route=route, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
    x4 = torch.from_numpy(pack4(x, lens)).cuda()
    dense = sw_torch.pair_scores(torch.from_numpy(x).cuda(), ht, irt, iat)
    got = sw_cuda.pair_calls(x4, ht, irt, iat, lt, route=route, read_bits=4)
    torch.cuda.synchronize()
    assert torch.equal(got, sw_torch.calls_from_scores(dense))
