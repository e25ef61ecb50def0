"""Scoring split over devices (--mesh-devices) against the single-device
run and the JAX package: ops/sw_cuda.MeshSwBackend over 1, 2 and 3 CPU
parts exactly against SwBackend (chunks that the parts do not divide, the
2-bit route kept per part); parallel/mesh.build_sharded_step against the
JAX package's on 2 of its 8 virtual CPU devices (its Pallas kernel in
interpret mode), on reads cut from the haplotypes so that REF, ALT, UNKNOWN
and dropped calls all occur; whole --mesh-devices runs' `.mtx` byte for
byte against the JAX package's; and --sw-mode banded, which runs unsharded.
Tolerance: exact."""

import logging

import jax
import numpy as np
import pytest
import torch

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.parallel import mesh as jmesh
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch import driver as port_driver
from vartrix_tpu_torch.ops import sw_cuda
from vartrix_tpu_torch.parallel import mesh as pmesh

BASES = np.frombuffer(b"ACGT", np.uint8)


def _pack2(x):
    """uint8 [R, lx] A/C/G/T reads -> (uint8 [R, lx//4] 2-bit codes, low
    bits first, int32 [R] lengths)."""
    lut = np.zeros(256, np.uint8)
    for c, b in enumerate(b"ACGT"):
        lut[b] = c
    codes = lut[x]
    out = np.zeros((x.shape[0], x.shape[1] // 4), np.uint8)
    for k in range(4):
        out |= codes[:, k::4] << (2 * k)
    return out, (x != 0).sum(1).astype(np.int32)


def _pairs(rng, R=37, lx=32, ly=48, H=6):
    """Reads cut from random haplotypes with a few substitutions; read 30
    holds an N, so its chunk ships dense."""
    haps = rng.choice(BASES, size=(H, ly)).astype(np.uint8)
    ir = rng.integers(0, H, R).astype(np.int32)
    ia = rng.integers(0, H, R).astype(np.int32)
    x = np.zeros((R, lx), np.uint8)
    for i in range(R):
        m = int(rng.integers(20, lx + 1))
        s = int(rng.integers(0, ly - m + 1))
        x[i, :m] = haps[ir[i] if i % 3 else ia[i], s : s + m]
        x[i, int(rng.integers(0, m))] = rng.choice(BASES)
    x[30, 3] = ord("N")
    return x, haps, ir, ia


def _provider(x):
    def fetch(start, n):
        return x[start : start + n]

    def packed2(start, n):
        rows = x[start : start + n]
        return None if (rows == ord("N")).any() else _pack2(rows)

    fetch.shape = x.shape
    fetch.packed2 = packed2
    return fetch


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_mesh_backend_equal_to_single_device(monkeypatch, n_parts):
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", 10)  # 4 chunks, the last 7
    x, haps, ir, ia = _pairs(np.random.default_rng(n_parts))
    single = sw_cuda.SwBackend("cpu", kernel=False)
    mesh = sw_cuda.MeshSwBackend(pmesh.make_mesh(n_parts, "cpu"),
                                 kernel=False)
    seen = []
    for be in mesh.parts:
        def spy(reads, hap, i_r, i_a, lens, read_bits,
                _fn=be._pair_calls):
            seen.append((reads.shape[0], lens is not None))
            return _fn(reads, hap, i_r, i_a, lens, read_bits=read_bits)
        be._pair_calls = spy
    want = single.pair_calls_chained(_provider(x), haps, ir, ia)
    got = mesh.pair_calls_chained(_provider(x), haps, ir, ia)
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert set(want.tolist()) >= {1, 2}
    # every chunk split over the parts in order; 2-bit until the N's chunk
    sizes = [n for n, _ in seen]
    assert sum(sizes) == len(x) and len(seen) == 4 * n_parts
    assert [p for _, p in seen] == [True] * 3 * n_parts + [False] * n_parts
    got = mesh.pair_chained(x, haps, ir, ia)
    assert np.array_equal(got, single.pair_chained(x, haps, ir, ia))
    y = haps[ir]
    assert np.array_equal(mesh(x, y), single(x, y))


def test_mesh_backend_empty():
    mesh = sw_cuda.MeshSwBackend(pmesh.make_mesh(2, "cpu"), kernel=False)
    z = np.zeros(0, np.int32)
    x = np.zeros((0, 16), np.uint8)
    haps = np.ones((2, 32), np.uint8)
    assert mesh.pair_calls_chained(x, haps, z, z).shape == (0,)
    assert mesh.pair_chained(x, haps, z, z).shape == (0, 2)
    assert mesh(x, np.ones((0, 32), np.uint8)).shape == (0,)


def test_make_mesh(monkeypatch):
    cpu = torch.device("cpu")
    assert pmesh.make_mesh(-1, "cpu") == [cpu]
    assert pmesh.make_mesh(3, "cpu") == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pmesh.make_mesh(2) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert len(pmesh.make_mesh(8)) == len(pmesh.make_mesh(-1)) == 4


def _step_inputs(seed=5, n_rows=4, n_cells=12, lx=32, ly=96, B=256):
    """Reads of 26-32 bases cut from each variant's ref or alt haplotype
    (one SNP in the middle), with at most one substitution: reads over the
    SNP call REF or ALT, the others tie (UNKNOWN); 1 in 10 is random and
    dropped below MIN_SCORE. The last 5 are padding (valid False)."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(BASES, size=(n_rows, ly))
    alt = ref.copy()
    snp = ly // 2
    alt[:, snp] = np.where(ref[:, snp] == ord("A"), ord("C"), ord("A"))
    hap = np.ones((2 * n_rows, ly), np.uint8)
    hap[0::2], hap[1::2] = ref, alt
    rows = rng.integers(0, n_rows, B).astype(np.int32)
    cells = rng.integers(0, n_cells, B).astype(np.int32)
    x = np.zeros((B, lx), np.uint8)
    for i in range(B):
        m = int(rng.integers(26, lx + 1))
        if rng.random() < 0.1:
            x[i, :m] = rng.choice(BASES, m)
            continue
        s = int(rng.integers(0, ly - m + 1))
        r = (alt if rng.random() < 0.5 else ref)[rows[i], s : s + m].copy()
        if rng.random() < 0.5:
            r[rng.integers(0, m)] = rng.choice(BASES)
        x[i, :m] = r
    valid = np.ones(B, bool)
    valid[-5:] = False
    return x, hap, 2 * rows, 2 * rows + 1, rows, cells, valid, n_rows, n_cells


def test_sharded_step_equal_to_jax():
    x, hap, ir, ia, rows, cells, valid, n_rows, n_cells = _step_inputs()
    assert len(jax.devices()) >= 2
    jstep = jmesh.build_sharded_step(jmesh.make_mesh(2), n_rows, n_cells)
    want, want_n = jstep(x, hap, ir, ia, rows, cells, valid)
    want = np.asarray(want)
    for n_parts in (1, 2, 3):
        step = pmesh.build_sharded_step(pmesh.make_mesh(n_parts, "cpu"),
                                        n_rows, n_cells)
        got, got_n = step(x, hap, ir, ia, rows, cells, valid)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got_n) == int(np.asarray(want_n)) == valid.sum()
    # channel 0 counts every valid read; REF, ALT and UNKNOWN all occur,
    # and some reads are dropped
    seen, ref_c, alt_c, unk_c = want.sum(axis=(0, 1))
    assert seen == valid.sum() and min(ref_c, alt_c, unk_c) > 0
    assert seen > ref_c + alt_c + unk_c


def test_pad_to_multiple_equal_to_jax():
    a = np.arange(10, dtype=np.int32)
    b = np.ones((10, 3), np.uint8)
    got, n = pmesh.pad_to_multiple([a, b], 4, [0, 7])
    want, m = jmesh.pad_to_multiple([a, b], 4, [0, 7])
    assert n == m == 10
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    got, n = pmesh.pad_to_multiple([a[:0]], 4, [0])
    assert n == 0 and got[0].shape == (4,)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("mesh")), SynthConfig(
        n_variants=8, n_cells=20, reads_per_variant=20, seed=63,
        indel_frac=0.2))


def _run(main, ds, out, extra):
    main(["-v", ds["vcf"], "-b", ds["bam"], "-f", ds["fasta"],
          "-c", ds["barcodes"], "-o", str(out), "--ref-matrix",
          str(out) + ".ref", "--log-level", "info", *extra])
    got = out.read_bytes()
    if "coverage" in extra:
        got += (out.parent / (out.name + ".ref")).read_bytes()
    return got


def _mesh_lines(caplog):
    return [r.getMessage() for r in caplog.records
            if "Mesh scoring" in r.getMessage()
            or "--mesh-devices is" in r.getMessage()]


PORT = ["--device", "cpu", "--backend", "torch"]


@pytest.mark.parametrize("mode", [["-s", "consensus"],
                                  ["-s", "coverage", "--umi"]],
                         ids=["consensus", "coverage_umi"])
def test_mesh_run_byte_equal_to_jax(ds, tmp_path, caplog, mode):
    mesh = mode + ["--mesh-devices", "2"]
    with caplog.at_level(logging.INFO, logger="vartrix"):
        got = _run(port_driver._main, ds, tmp_path / "p.mtx", mesh + PORT)
        port_log = _mesh_lines(caplog)
        caplog.clear()
        want = _run(jax_main, ds, tmp_path / "j.mtx", mesh + ["--backend",
                                                              "cpu"])
        jax_log = _mesh_lines(caplog)
    assert got == want
    assert got == _run(port_driver._main, ds, tmp_path / "s.mtx",
                       mode + PORT)
    assert port_log == jax_log == ["Mesh scoring across 2 local devices"]


def test_mesh_banded_runs_unsharded(ds, tmp_path, caplog):
    banded = ["--sw-mode", "banded", "-s", "coverage", "--umi"]
    with caplog.at_level(logging.INFO, logger="vartrix"):
        got = _run(port_driver._main, ds, tmp_path / "p.mtx",
                   banded + ["--mesh-devices", "2"] + PORT)
        lines = _mesh_lines(caplog)
    assert len(lines) == 1
    assert lines[0].startswith("--mesh-devices is a full-SW device path")
    assert got == _run(port_driver._main, ds, tmp_path / "s.mtx",
                       banded + PORT)
    assert got == _run(jax_main, ds, tmp_path / "j.mtx",
                       banded + ["--mesh-devices", "2", "--backend", "cpu"])
