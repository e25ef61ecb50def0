"""The port's --sw-mode banded (band bounds, plain banded DP, banded backend,
whole run) against the JAX package: its native band bounds and banded
aligner, and its banded TPU kernel run as the JAX tests run it (Pallas in
interpret mode on the CPU). Inputs are made with numpy from a seed and fed
to both sides as the same arrays; the tolerance is exact equality.

On the CPU the port's wrappers take the plain PyTorch version; the case
marked `cuda` holds the CUDA banded kernel against it on a GPU."""

import numpy as np
import pytest
import torch

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.core.agg_numpy import codes_from_scores
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.ops.sw_native import (banded_bounds_batch_native,
                                       banded_sw_chained_batch_native)
from vartrix_tpu.ops.sw_pallas_v2 import make_banded_tpu_scorer
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.driver import _main as port_main
from vartrix_tpu_torch.ops import sw_cuda, sw_native

BASES = np.frombuffer(b"ACGT", np.uint8)


def _rows(reads, haps, lx, ly):
    x = np.zeros((len(reads), lx), np.uint8)
    y = np.ones((len(haps), ly), np.uint8)
    for i, (r, h) in enumerate(zip(reads, haps)):
        x[i, : len(r)] = r
        y[i, : len(h)] = h
    return x, y


def family(name, B=256, lx=48, ly=64):
    """Plain (x, y) rows: tests/test_banded.py's seed-17 family (reads
    sampled from their haplotype with substitutions and an occasional
    deletion, or random) and corner families of the band construction."""
    rng = np.random.default_rng(17)
    reads, haps = [], []
    for i in range(B):
        if name == "short":  # a sequence shorter than k: full band
            hap = rng.choice(BASES, int(rng.integers(1, 13)))
            read = rng.choice(BASES, int(rng.integers(1, 9)))
            if rng.random() < 0.5:
                read = hap[: len(read)].copy()
        elif name == "unseeded":  # no shared 6-mer: empty band
            read = rng.choice(np.frombuffer(b"AC", np.uint8),
                              int(rng.integers(6, lx + 1)))
            read[::5] = ord("C")
            hap = rng.choice(np.frombuffer(b"AG", np.uint8),
                             int(rng.integers(6, ly + 1)))
        else:
            yl = int(rng.integers(8, ly + 1))
            hap = rng.choice(BASES, yl)
            xl = int(rng.integers(4, lx + 1))
            if rng.random() < 0.6 and yl > xl:
                s = int(rng.integers(0, yl - xl))
                read = hap[s : s + xl].copy()
                mut = rng.random(xl) < 0.08
                read[mut] = rng.choice(BASES, int(mut.sum()))
                if rng.random() < 0.3 and xl > 10:
                    read = np.delete(read, int(rng.integers(2, xl - 2)))
            else:
                read = rng.choice(BASES, xl)
            if name == "empty_haps" and rng.random() < 0.3:
                hap = hap[:0]
            if name == "odd_bytes":  # raw-byte compare: N, =, lowercase
                read = read.copy()
                read[rng.random(len(read)) < 0.05] = ord("N")
                read[rng.random(len(read)) < 0.03] = ord("=")
                hap = np.where(rng.random(len(hap)) < 0.05, hap + 32, hap)
        reads.append(read)
        haps.append(hap)
    return _rows(reads, haps, lx, ly)


def _seqs(x, y):
    return ([bytes(r[r != 0]) for r in x], [bytes(r[r != 1]) for r in y])


def _row_bounds(x, y):
    """Bounds of plain rows: read i against haplotype row i, as both
    problems of the pair entry; returns the ref problems' [lx, B]."""
    ident = np.arange(len(x), dtype=np.int32)
    jlo, jhi = sw_native.band_bounds(x, y, ident, ident, n_threads=2)
    np.testing.assert_array_equal(jlo[:, 0::2], jlo[:, 1::2])
    np.testing.assert_array_equal(jhi[:, 0::2], jhi[:, 1::2])
    return jlo[:, 0::2], jhi[:, 0::2]


def _plain_row_scores(x, y):
    """int32 [B] plain banded scores of read i against row i, through the
    pair entry's CPU route (identity indices, the ref row)."""
    ident = np.arange(len(x), dtype=np.int32)
    jlo, jhi = sw_native.band_bounds(x, y, ident, ident, n_threads=2)
    args = [torch.from_numpy(a) for a in (x, y, ident, ident, jlo, jhi)]
    scores = sw_cuda.banded_pair_scores(*args).numpy()
    np.testing.assert_array_equal(scores[0], scores[1])
    return scores[0]


BOUND_FAMILIES = ["seed17", "short", "unseeded", "empty_haps"]


@pytest.mark.parametrize("name", BOUND_FAMILIES)
def test_band_bounds_match_jax(name):
    x, y = family(name)
    jlo, jhi = _row_bounds(x, y)
    elo, ehi = banded_bounds_batch_native(*_seqs(x, y), x.shape[1], 2)
    np.testing.assert_array_equal(jlo.T, elo.astype(np.int32))
    np.testing.assert_array_equal(jhi.T, ehi.astype(np.int32))
    if name == "unseeded":
        assert not jhi.any()
    if name == "short":  # full band on the rows of the shorter pairs
        lens_y = (y != 1).sum(1)
        full = ((x != 0).sum(1) < 6) | (lens_y < 6)
        assert (jhi[0, full] == lens_y[full]).all()


@pytest.mark.parametrize("name", BOUND_FAMILIES + ["odd_bytes"])
def test_plain_banded_dp_matches_k4_and_native(name):
    x, y = family(name)
    got = _plain_row_scores(x, y)
    k4 = make_banded_tpu_scorer(2)(x, y)  # Pallas, interpret off the TPU
    native = banded_sw_chained_batch_native(*_seqs(x, y), 2)
    np.testing.assert_array_equal(got, k4)
    np.testing.assert_array_equal(got, native)


@pytest.mark.parametrize("name", BOUND_FAMILIES + ["odd_bytes"])
def test_backend_plain_rows_match_k4_and_native(name):
    """K4's own entry, plain rows x [B, lx] against y [B, ly]: the banded
    backend called on them (the Python host path's scorer, its plain
    version here) against the TPU kernel in interpret mode and the native
    aligner; the wrapper's plain-row band bounds against JAX's."""
    x, y = family(name)
    got = sw_cuda.BandedSwBackend("cpu", kernel=False)(x, y)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, make_banded_tpu_scorer(2)(x, y))
    np.testing.assert_array_equal(
        got, banded_sw_chained_batch_native(*_seqs(x, y), 2))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(
        sw_cuda.banded_batch_scores(xt, yt).numpy(), got)
    ident = torch.arange(len(x), dtype=torch.int32)
    jlo, jhi = sw_cuda.band_bounds(xt, yt, ident)
    assert jlo.shape == (x.shape[1], len(x))
    elo, ehi = banded_bounds_batch_native(*_seqs(x, y), x.shape[1], 2)
    np.testing.assert_array_equal(jlo.numpy().T, elo.astype(np.int32))
    np.testing.assert_array_equal(jhi.numpy().T, ehi.astype(np.int32))
    np.testing.assert_array_equal(
        sw_cuda.banded_scores(xt, yt, jlo, jhi).numpy(), got)


def pair_case(seed=23, R=700, H=40, lx=64, ly=96):
    """Reads sampled (with indels and substitutions) from one of H
    haplotypes, scored against a random (ref, alt) pair of rows; row 3 is
    empty."""
    rng = np.random.default_rng(seed)
    haps = [rng.choice(BASES, int(rng.integers(30, ly + 1))) for _ in range(H)]
    haps[3] = haps[3][:0]
    reads = []
    for _ in range(R):
        h = haps[int(rng.integers(0, H))]
        if len(h) < 20:
            reads.append(rng.choice(BASES, 20))
            continue
        n = int(rng.integers(16, min(lx, len(h)) + 1))
        s = int(rng.integers(0, len(h) - n + 1))
        read = list(h[s : s + n])
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(1, len(read) - 1))
            if rng.random() < 0.5:
                del read[p : p + int(rng.integers(1, 5))]
            else:
                read[p:p] = list(rng.choice(BASES, int(rng.integers(1, 5))))
        read = np.array(read[:lx], np.uint8)
        read[rng.random(len(read)) < 0.03] = BASES[0]
        reads.append(read)
    x, hap_mat = _rows(reads, haps, lx, ly)
    idx_ref = rng.integers(0, H, R).astype(np.int32)
    idx_alt = rng.integers(0, H, R).astype(np.int32)
    return x, hap_mat, idx_ref, idx_alt


def test_backend_pair_route_matches_jax_scores(monkeypatch):
    x, hap_mat, idx_ref, idx_alt = pair_case()
    xs, _ = _seqs(x, x)
    exp = np.stack([banded_sw_chained_batch_native(
        xs, _seqs(hap_mat[idx], hap_mat[idx])[1], 2)
        for idx in (idx_ref, idx_alt)], axis=1)
    assert (exp > 0).any() and (exp[idx_ref == 3, 0] == 0).all()

    def provider(start, n):
        return x[start : start + n]

    provider.shape = x.shape
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", 256)  # three chunks
    be = sw_cuda.BandedSwBackend("cpu", kernel=False)
    np.testing.assert_array_equal(
        be.pair_calls_chained(provider, hap_mat, idx_ref, idx_alt),
        codes_from_scores(exp))
    jlo, jhi = sw_native.band_bounds(x, hap_mat, idx_ref, idx_alt, 2)
    args = [torch.from_numpy(a) for a in (x, hap_mat, idx_ref, idx_alt, jlo,
                                          jhi)]
    np.testing.assert_array_equal(
        sw_cuda.banded_pair_scores(*args).numpy().T, exp)


def wide_case(seed=2024):
    """One 150-base read copied, with two substitutions, from bases
    36,000-36,150 of a 40,000-base haplotype, against it (ref) and a copy
    with one more substitution (alt): the band lies past int16."""
    rng = np.random.default_rng(seed)
    hap = rng.choice(BASES, 40000)
    read = hap[36000:36150].copy()
    for p in (40, 100):
        read[p] = BASES[(np.searchsorted(BASES, read[p]) + 1) % 4]
    alt = hap.copy()
    alt[36075] = BASES[(np.searchsorted(BASES, alt[36075]) + 2) % 4]
    x = np.zeros((1, 160), np.uint8)
    x[0, :150] = read
    idx = np.zeros(1, np.int32)
    return x, np.stack([hap, alt]), idx, idx + 1


def test_banded_bounds_and_scores_past_int16():
    # the port's int32 band builder and plain DP against the JAX package's
    # native aligner, which keeps its bounds in int32 internally
    x, hap_mat, idx_ref, idx_alt = wide_case()
    jlo, jhi = sw_native.band_bounds(x, hap_mat, idx_ref, idx_alt, 2)
    assert jhi.max() > 32_767
    assert (jlo[:150] > 35_000).all()
    args = [torch.from_numpy(a) for a in (x, hap_mat, idx_ref, idx_alt, jlo,
                                          jhi)]
    got = sw_cuda.banded_pair_scores(*args).numpy()[:, 0]
    xs, _ = _seqs(x, x)
    exp = banded_sw_chained_batch_native(
        xs * 2, _seqs(hap_mat, hap_mat)[1], 2)
    np.testing.assert_array_equal(got, exp)
    assert got[0] == 150 - 2 * 6 and got[1] < got[0]


def test_band_bounds_reject_out_of_range_index():
    x, hap_mat, idx_ref, idx_alt = pair_case(R=8)
    with pytest.raises(IndexError):
        sw_native.band_bounds(x, hap_mat[:2], idx_ref, idx_alt)


MODES = {
    "consensus": ["-s", "consensus"],
    "coverage_umi": ["-s", "coverage", "--umi"],
    "alt_frac": ["-s", "alt_frac"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("synth")), SynthConfig(
        n_variants=8, n_cells=25, reads_per_variant=25, seed=77,
        spliced_frac=0.3, indel_frac=0.2))


def _run(main, data, out_dir, tag, extra):
    out = str(out_dir / f"{tag}.mtx")
    ref = str(out_dir / f"{tag}_ref.mtx")
    main(["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
          "-c", data["barcodes"], "-o", out, "--ref-matrix", ref,
          "--sw-mode", "banded"] + extra)
    return out, ref


def _read(path):
    with open(path, "rb") as f:
        return f.read()


PORT_CPU = ["--device", "cpu", "--backend", "torch", "--threads", "2"]


@pytest.mark.parametrize("mode", list(MODES))
def test_banded_run_byte_equal_to_jax(tmp_path, data, mode):
    import json

    mj = tmp_path / "metrics.json"
    out, ref = _run(port_main, data, tmp_path, "port", MODES[mode] + PORT_CPU
                    + ["--metrics-json", str(mj)])
    exp, exp_ref = _run(jax_main, data, tmp_path, "jax", MODES[mode] + [
        "--host", "native", "--backend", "cpu"])
    assert _read(out) == _read(exp)
    if mode == "coverage_umi":
        assert _read(ref) == _read(exp_ref)
    payload = json.loads(mj.read_text())
    assert payload["config"]["sw_mode"] == "banded"
    assert payload["kernel_launches"] == {"sw_pair": 0, "sw_banded": 0,
                                          "band_build": 0, "band_index": 0}


def test_banded_run_byte_equal_to_jax_k4(tmp_path, data):
    # the JAX package's banded TPU kernel (K4), in interpret mode here
    out, _ = _run(port_main, data, tmp_path, "port", PORT_CPU)
    exp, _ = _run(jax_main, data, tmp_path, "jax", [
        "--host", "native", "--backend", "tpu"])
    assert _read(out) == _read(exp)


def test_banded_run_haplotypes_wider_than_int16(tmp_path_factory, tmp_path):
    # --padding 20000 on an 80 kb chromosome: haplotypes above 32,767 bases,
    # past the JAX package's int16 bounds, which its VMEM guard keeps from
    # the TPU; the port has int32 bounds and no guard
    cfg = SynthConfig(n_chroms=1, chrom_len=80_000, n_variants=3, n_cells=6,
                      reads_per_variant=4, seed=5)
    data = generate_dataset(str(tmp_path_factory.mktemp("wide")), cfg)
    pad = 20_000
    with open(data["vcf"]) as f:
        pos = [int(ln.split("\t")[1]) for ln in f if not ln.startswith("#")]
    assert any(min(p + pad, cfg.chrom_len) - max(p - 1 - pad, 0) > 32_767
               for p in pos)
    extra = ["-s", "coverage", "--padding", str(pad)]
    out, ref = _run(port_main, data, tmp_path, "port", extra + PORT_CPU)
    exp, exp_ref = _run(jax_main, data, tmp_path, "jax", extra + [
        "--host", "native", "--backend", "cpu"])
    assert _read(out) == _read(exp)
    assert _read(ref) == _read(exp_ref)
    size = next(ln for ln in _read(ref).splitlines()
                if not ln.startswith(b"%"))
    assert int(size.split()[2]) > 0  # reads were scored


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", BOUND_FAMILIES + ["odd_bytes"])
def test_plain_row_kernels_match_plain_on_card(cuda_device, name):
    x, y = family(name)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ident = torch.arange(len(x), dtype=torch.int32)
    exp = sw_cuda.band_bounds(xt, yt, ident)
    on_card = [t.to(cuda_device) for t in (xt, yt, ident)]
    got = sw_cuda.band_bounds(*on_card)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.cpu().numpy(), e.numpy())
    np.testing.assert_array_equal(
        sw_cuda.banded_batch_scores(*on_card[:2]).cpu().numpy(),
        sw_cuda.banded_batch_scores(xt, yt).numpy())


@pytest.mark.cuda
def test_banded_kernel_matches_plain_on_card(cuda_device):
    x, hap_mat, idx_ref, idx_alt = pair_case(seed=29, R=2000, lx=160, ly=224)
    jlo, jhi = sw_native.band_bounds(x, hap_mat, idx_ref, idx_alt, 2)
    args = [torch.from_numpy(a) for a in (x, hap_mat, idx_ref, idx_alt, jlo,
                                          jhi)]
    on_card = [a.to(cuda_device) for a in args]
    for fn in (sw_cuda.banded_pair_scores, sw_cuda.banded_pair_calls):
        np.testing.assert_array_equal(fn(*on_card).cpu().numpy(),
                                      fn(*args).numpy())
