"""The port's chunk dispatcher (ops/sw_cuda: host_chunks, prefetched,
SwBackend._chunks, MeshSwBackend._chunks) on the CPU: the read formats it
ships chunk by chunk against the JAX package's `_chunked_pair_dispatch` on
the same declining provider, equal outputs with and without the producer
thread, the producer running ahead, a producer's exception reaching the
caller with no thread left behind, and the mesh split over 4-bit parts.
Inputs are made with numpy from seeds; the tolerance is exact equality."""

import threading

import numpy as np
import pytest

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.ops import sw_pallas_v2
from vartrix_tpu.ops.sw_pallas_v2 import PackedHaps as JaxPackedHaps
from vartrix_tpu_torch.io import bam_native
from vartrix_tpu_torch.ops import sw_cuda, sw_torch
from vartrix_tpu_torch.parallel import mesh as pmesh
from vartrix_tpu_torch.utils import trace

BASES = np.frombuffer(b"ACGT", np.uint8)
SPAN = 256  # reads per chunk in both packages (VARTRIX_CHUNK = 2 * SPAN)
ROUTE_CODE = {"p2": 0, "p4": 1, "dense": 2}
# host_chunks' read_bits by format
FORMAT_OF_BITS = {2: "p2", 4: "p4", None: "dense"}


def reads_with(rng, n_chunks, odd, lx=32, tail=37):
    """Reads of n_chunks chunks of SPAN and a tail; odd maps a chunk to
    the byte one of its reads carries ('N', 'a', ...)."""
    R = n_chunks * SPAN + tail
    seqs = [rng.choice(BASES, int(n)).tobytes()
            for n in rng.integers(1, lx + 8, R)]
    for k, byte in odd.items():
        i = k * SPAN + int(rng.integers(0, SPAN))
        s = bytearray(seqs[i])
        s[len(s) // 2] = byte
        seqs[i] = bytes(s)
    off = np.zeros(R + 1, np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    return np.frombuffer(b"".join(seqs), np.uint8).copy(), off


def provider(pool, off, lx, log=None):
    """The pipeline's read provider over a pool (core/fast_pipeline's
    _read_provider): dense rows, 2-bit and 4-bit gathers; `log` records
    each gather as (format, start, thread name)."""
    R = len(off) - 1
    ids = np.arange(R, dtype=np.int64)

    def note(form, start):
        if log is not None:
            log.append((form, start, threading.current_thread().name))

    def x(start, n):
        note("dense", start)
        return bam_native.gather_padded(pool, off, ids[start : start + n], lx)

    def packed(start, n):
        note("p4", start)
        return bam_native.gather_padded_packed(pool, off,
                                               ids[start : start + n], lx)

    def packed2(start, n):
        note("p2", start)
        return bam_native.gather_padded_packed2(pool, off,
                                                ids[start : start + n], lx)

    x.shape = (R, lx)
    x.packed = packed
    x.packed2 = packed2
    return x


def haps_of(rng, H, ly):
    haps = np.ones((H, ly), np.uint8)
    for h in range(H):
        n = int(rng.integers(1, ly + 1))
        haps[h, :n] = rng.choice(BASES, n)
    return haps


def packed_haps(haps):
    """haps uint8 [H, ly] (pad 1) as a PackedHaps: 4-bit rows and lengths."""
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(sw_torch.SEQ_NT16, np.uint8)] = np.arange(16)
    codes = np.where(haps == 1, 0, lut[haps]).astype(np.uint8)
    return sw_torch.PackedHaps((codes[:, 0::2] << 4) | codes[:, 1::2],
                               (haps != 1).sum(1).astype(np.int32), haps)


def jax_routes(x, haps, ir, ia, monkeypatch):
    """The formats `_chunked_pair_dispatch` ships chunk by chunk, through
    entries that record theirs."""
    monkeypatch.setenv("VARTRIX_CHUNK", str(2 * SPAN))

    def entry(route):
        def run(*args, **kwargs):
            return np.array([ROUTE_CODE[route]])
        return run

    results, spans = sw_pallas_v2._chunked_pair_dispatch(
        x, haps, ir, ia, entry("dense"), 1, entry("p4"), entry("p4"),
        bp_of=lambda n: n, p2_entry=entry("p2"))
    assert [n for _, n in spans][0] == SPAN
    names = {v: k for k, v in ROUTE_CODE.items()}
    return [names[int(np.asarray(r)[0])] for r in results]


CASES = {
    # chunk: the byte one of its reads carries
    "acgt": {},
    "n_then_lower": {2: ord("N"), 4: ord("a")},
    "n_first": {0: ord("N")},
    "lower_first": {0: ord("a")},
    "eq_iupac_then_foreign": {1: ord("="), 2: ord("R"), 3: ord("X")},
}


@pytest.mark.parametrize("case", list(CASES))
def test_routes_equal_to_jax_dispatch(case, monkeypatch):
    # 2-bit until a chunk declines, 4-bit from that same chunk, dense from
    # the first chunk the 4-bit gather declines: chunk by chunk as the JAX
    # package, haplotypes dense or packed
    rng = np.random.default_rng(len(case))
    lx = 32
    pool, off = reads_with(rng, 6, CASES[case], lx)
    R = len(off) - 1
    haps = haps_of(rng, 10, 48)
    ir = rng.integers(0, 10, R).astype(np.int32)
    ia = rng.integers(0, 10, R).astype(np.int32)
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", SPAN)
    trace.reset(record=False)
    x = provider(pool, off, lx)
    got = [FORMAT_OF_BITS[c[0]] for c in sw_cuda.host_chunks(x, ir, ia)]
    routes = {r: trace.counters().get(f"route.read.{r}", 0)
              for r in ROUTE_CODE}
    ph = packed_haps(haps)
    for hap in (haps, JaxPackedHaps(ph.packed, ph.lens, haps)):
        assert jax_routes(x, hap, ir, ia, monkeypatch) == got
    assert len(got) == 7
    assert routes == {r: got.count(r) for r in ROUTE_CODE}
    assert got == sorted(got, key=list(ROUTE_CODE).index)


def test_plain_array_ships_dense():
    rng = np.random.default_rng(3)
    x = np.zeros((40, 32), np.uint8)
    x[:, :20] = rng.choice(BASES, (40, 20))
    z = np.zeros(40, np.int32)
    assert [c[0] for c in sw_cuda.host_chunks(x, z, z)] == [None]


def run_backend(be, x, haps, ir, ia, depth, monkeypatch):
    monkeypatch.setattr(sw_cuda, "PREFETCH_DEPTH", depth)
    return (be.pair_calls_chained(x, haps, ir, ia),
            be.pair_chained(x, haps, ir, ia))


@pytest.mark.parametrize("case", ["acgt", "n_then_lower"])
def test_outputs_equal_at_depth_0_and_2(case, monkeypatch):
    rng = np.random.default_rng(17)
    pool, off = reads_with(rng, 6, CASES[case])
    R = len(off) - 1
    haps = haps_of(rng, 10, 48)
    ir = rng.integers(0, 10, R).astype(np.int32)
    ia = rng.integers(0, 10, R).astype(np.int32)
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", SPAN)
    be = sw_cuda.SwBackend("cpu", kernel=False)
    x = provider(pool, off, 32)
    serial = run_backend(be, x, haps, ir, ia, 0, monkeypatch)
    ahead = run_backend(be, x, haps, ir, ia, 2, monkeypatch)
    dense = sw_torch.pair_scores(*sw_cuda.from_numpy(x(0, R), haps, ir, ia,
                                                     "cpu"))
    for a, b in zip(serial, ahead):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(ahead[1], dense.numpy().T)
    np.testing.assert_array_equal(
        ahead[0], sw_torch.calls_from_scores(dense).numpy())


def test_producer_gathers_ahead(monkeypatch):
    # at depth 2 the producer thread gathers chunks 1 and 2 while chunk 0 is
    # launched; at depth 0 every gather runs on the launching thread
    rng = np.random.default_rng(4)
    pool, off = reads_with(rng, 4, {})
    R = len(off) - 1
    haps = haps_of(rng, 6, 48)
    ir = np.zeros(R, np.int32)
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", SPAN)
    log = []
    ready = threading.Event()
    be = sw_cuda.SwBackend("cpu", kernel=False)
    launch = be._pair_calls
    launched = []

    def gather_seen(form, start):
        if start == 2 * SPAN:
            ready.set()

    def spy(*args, **kwargs):
        if not launched:
            assert ready.wait(30), "chunk 2 was not gathered ahead"
        launched.append(threading.current_thread().name)
        return launch(*args, **kwargs)

    be._pair_calls = spy
    x = provider(pool, off, 32, log)
    inner = x.packed2

    def packed2(start, n):
        got = inner(start, n)
        gather_seen("p2", start)
        return got

    x.packed2 = packed2
    monkeypatch.setattr(sw_cuda, "PREFETCH_DEPTH", 2)
    be.pair_calls_chained(x, haps, ir, ir)
    main = threading.current_thread().name
    assert len(launched) == 5 and set(launched) == {main}
    assert {t for _, _, t in log} != {main}
    assert all(t.startswith("chunk-gather") for _, _, t in log)
    log.clear()
    launched.clear()
    ready.set()
    monkeypatch.setattr(sw_cuda, "PREFETCH_DEPTH", 0)
    be.pair_calls_chained(x, haps, ir, ir)
    assert {t for _, _, t in log} == {main}


@pytest.mark.parametrize("depth", [0, 2])
def test_producer_exception_reaches_caller(depth, monkeypatch):
    rng = np.random.default_rng(9)
    pool, off = reads_with(rng, 5, {})
    R = len(off) - 1
    haps = haps_of(rng, 6, 48)
    ir = np.zeros(R, np.int32)
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", SPAN)
    monkeypatch.setattr(sw_cuda, "PREFETCH_DEPTH", depth)
    x = provider(pool, off, 32)
    calls = []

    def packed2(start, n):
        calls.append(start)
        if start == 2 * SPAN:
            raise OSError("the read source failed")
        return bam_native.gather_padded_packed2(
            pool, off, np.arange(start, start + n, dtype=np.int64), 32)

    x.packed2 = packed2
    be = sw_cuda.SwBackend("cpu", kernel=False)
    with pytest.raises(OSError, match="the read source failed"):
        be.pair_calls_chained(x, haps, ir, ir)
    assert calls == [0, SPAN, 2 * SPAN]  # not retried, nothing after it
    assert not [t for t in threading.enumerate()
                if t.name.startswith("chunk-gather")]


def test_consumer_exception_leaves_no_thread(monkeypatch):
    rng = np.random.default_rng(10)
    pool, off = reads_with(rng, 5, {})
    R = len(off) - 1
    haps = haps_of(rng, 6, 48)
    ir = np.zeros(R, np.int32)
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", SPAN)
    monkeypatch.setattr(sw_cuda, "PREFETCH_DEPTH", 2)
    be = sw_cuda.SwBackend("cpu", kernel=False)
    n = []

    def failing(*args, **kwargs):
        n.append(1)
        if len(n) == 2:
            raise RuntimeError("launch failed")
        return sw_torch.pair_calls(*args, **kwargs)

    be._pair_calls = failing
    with pytest.raises(RuntimeError, match="launch failed"):
        be.pair_calls_chained(provider(pool, off, 32), haps, ir, ir)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("chunk-gather")]


@pytest.mark.parametrize("n_parts", [2, 3])
def test_mesh_backend_equal_over_4bit_parts(n_parts, monkeypatch):
    # each chunk's 4-bit reads and lengths split over the parts in order;
    # each part unpacks its own copy of the packed haplotypes
    rng = np.random.default_rng(20 + n_parts)
    pool, off = reads_with(rng, 3, {0: ord("N"), 2: ord("Y")})
    R = len(off) - 1
    haps = haps_of(rng, 8, 48)
    ph = packed_haps(haps)
    ir = rng.integers(0, 8, R).astype(np.int32)
    ia = rng.integers(0, 8, R).astype(np.int32)
    monkeypatch.setattr(sw_cuda, "CHUNK_READS", SPAN)
    single = sw_cuda.SwBackend("cpu", kernel=False)
    mesh = sw_cuda.MeshSwBackend(pmesh.make_mesh(n_parts, "cpu"),
                                 kernel=False)
    seen = []
    for be in mesh.parts:
        def spy(reads, hap, i_r, i_a, lens, read_bits, _fn=be._pair_calls):
            seen.append((reads.shape[0], read_bits if lens is not None
                         else 8))
            return _fn(reads, hap, i_r, i_a, lens, read_bits=read_bits)
        be._pair_calls = spy
    x = provider(pool, off, 32)
    want = single.pair_calls_chained(x, haps, ir, ia)
    trace.reset(record=False)
    got = mesh.pair_calls_chained(x, ph, ir, ia)
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert sum(n for n, _ in seen) == R and len(seen) == 4 * n_parts
    assert [b for _, b in seen] == [4] * 4 * n_parts
    assert {r: trace.counters().get(f"route.hap.{r}", 0)
            for r in ("p4", "dense")} == {"p4": n_parts, "dense": 0}
    np.testing.assert_array_equal(mesh.pair_chained(x, ph, ir, ia),
                                  single.pair_chained(x, haps, ir, ia))
