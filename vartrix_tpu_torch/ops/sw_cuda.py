"""Wrappers of the CUDA kernels (csrc/sw_pair.cu, full Smith-Waterman;
csrc/sw_banded.cu, banded Smith-Waterman; csrc/band_build.cu, the band
bounds of banded mode) and the scoring backends that
core/fast_pipeline.score_all_fast drives.

The wrapper functions take tensors. CUDA tensors always go to a kernel;
CPU tensors go to the plain version (ops/sw_torch.py, ops/sw_banded_torch.py,
ops/band_torch.py), the only case in which it is taken. Each kernel is
built with nvcc at first use and bound through ctypes; a failed build or
launch raises. The kernels take every (lx, ly): sw_pair runs two problems
per thread in 16-bit halves while min(lx, ly) <= 32,767 and one per thread
past that, with a 32-bit scratch word up to 65,535 and a 64-bit one from
65,536 (pair_route); sw_banded switches to its 64-bit word from 65,536
(wide_word). Every wrapper cuts a launch into ranges whose scratch fits a
fixed budget (read_ranges, band_ranges) and writes them into one output.

`SwBackend` is the duck-typed backend contract of the pipeline: calling it
scores plain (x, y) rows, `.pair_chained` returns (ref, alt) scores and
`.pair_calls_chained` (the default route) returns one int8 call code per
read. It chunks each shape bucket into launches of CHUNK_READS reads,
shipping reads as 2-bit codes while every read of the bucket is A/C/G/T
and as dense bytes from the first chunk that is not. `BandedSwBackend`
(--sw-mode banded) has the default route only: per shape bucket it builds
the haplotypes' k-mer index once on the device (band_index), then per
chunk it ships dense reads and indices, builds both problems' band bounds
on the device (band_bounds) and scores them there; no band stage runs on
the host.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import band_torch, sw_banded_torch, sw_torch
from ._build import band_build_library, banded_kernel_library, kernel_library
from .band_torch import BandIndex

# 131,072 (read, haplotype) problems per launch
CHUNK_READS = 65536

# device bytes the band builder's chain pass may take for its match
# scratch (12 bytes per match) and work rows (8 bytes per read row) per
# launch, less the k-mer index it reads (12 bytes per haplotype position);
# a chunk that needs more runs the pass over ranges of problems
BAND_SCRATCH_BYTES = 1 << 30
# device bytes the DP kernels' scratch (the (H, F + 6) words a strip hands
# to the next) may take per launch; a chunk that needs more runs over
# ranges of reads
DP_SCRATCH_BYTES = 1 << 30
# read rows per strip of csrc/sw_pair.cu (kStrip; kPackedStrip on its
# packed route) and csrc/sw_banded.cu (kStrip): a read within one strip
# needs no scratch
PAIR_STRIP = 16
PACKED_STRIP = 32
BANDED_STRIP = 8
# read width from which the band builder's chain keys (score x 64 +
# nearness, a score at most the read's length) need 64 bits
BAND_WIDE_KEYS_LX = 1 << 25

# kernel launches (sw_pair, sw_banded: one per read range; band_build: one
# per chain-pass range; band_index: one per index) since the last reset;
# the smoke check zeroes them before driving a path and reads them after
LAUNCHES = 0
BANDED_LAUNCHES = 0
BAND_LAUNCHES = 0
INDEX_LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None
_banded_lib: Optional[ctypes.CDLL] = None
_band_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(kernel_library())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sw_pair_launch.restype = ci
        lib.sw_pair_launch.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, vp, ci,
                                       vp, ci, vp, vp, ci, vp]
        lib.sw_pair_error_string.restype = ctypes.c_char_p
        lib.sw_pair_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def _banded_kernel() -> ctypes.CDLL:
    global _banded_lib
    if _banded_lib is None:
        lib = ctypes.CDLL(banded_kernel_library())
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sw_banded_launch.restype = ci
        lib.sw_banded_launch.argtypes = [vp, ci, ci, vp, ci, vp, vp, vp, vp,
                                         cl, vp, ci, vp, vp, ci, vp]
        lib.sw_banded_error_string.restype = ctypes.c_char_p
        lib.sw_banded_error_string.argtypes = [ci]
        _banded_lib = lib
    return _banded_lib


def _band_kernel() -> ctypes.CDLL:
    global _band_lib
    if _band_lib is None:
        lib = ctypes.CDLL(band_build_library())
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.band_index_build.restype = ci
        lib.band_index_build.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp]
        lib.band_build_count.restype = ci
        lib.band_build_count.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, vp,
                                         vp, vp]
        lib.band_build_chain.restype = ci
        lib.band_build_chain.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, vp,
                                         vp, cl, cl, vp, vp, vp, vp, vp, vp,
                                         vp, ci, vp]
        lib.band_build_error_string.restype = ctypes.c_char_p
        lib.band_build_error_string.argtypes = [ci]
        _band_lib = lib
    return _band_lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, reads are on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wide_word(lx: int, ly: int) -> bool:
    """Whether the DP kernels need their 64-bit scratch word: H and F + 6
    reach min(lx, ly), which the 32-bit word holds as 16-bit halves only
    below 65536."""
    return min(lx, ly) >= 1 << 16


# sw_pair's routes (csrc/sw_pair.cu), by their code in sw_pair_launch:
# two problems per thread in int16 halves, then one per thread with a
# 32-bit or a 64-bit scratch word
PAIR_ROUTES = ("packed", "word32", "word64")
PACKED_MAX = (1 << 15) - 1
# columns per step of the packed route (kCols): its scratch holds ly
# rounded up to a multiple of them
PACKED_COLS = 2


def pair_route(lx: int, ly: int) -> str:
    """sw_pair's route for a bucket of lx x ly: "packed" while an H (at
    most min(lx, ly)) fits an int16 half, "word32" while H and F + 6 fit
    the 16-bit halves of the scalar scratch word, else "word64"."""
    if min(lx, ly) <= PACKED_MAX:
        return "packed"
    return "word64" if wide_word(lx, ly) else "word32"


def pair_scratch_bytes(lx: int, ly: int, route: str) -> int:
    """Scratch bytes of one problem of sw_pair on `route`, per column 4
    (half of a packed pair's 8-byte (G, F) words, over ly rounded up to
    PACKED_COLS columns; or the scalar (H, F + 6) word) or, on word64, 8;
    none when the read fits one strip."""
    if lx <= (PACKED_STRIP if route == "packed" else PAIR_STRIP):
        return 0
    if route == "packed":
        return 4 * (-(-ly // PACKED_COLS) * PACKED_COLS)
    return (8 if route == "word64" else 4) * ly


def dp_scratch_bytes(lx: int, ly: int, banded: bool = False) -> int:
    """Scratch bytes of one (read, haplotype) problem of sw_pair on its
    route (pair_scratch_bytes) or, banded, of sw_banded (2 ly words: two
    buffers alternate by strip); none when the read fits one strip."""
    if not banded:
        return pair_scratch_bytes(lx, ly, pair_route(lx, ly))
    if lx <= BANDED_STRIP:
        return 0
    return 2 * ly * (8 if wide_word(lx, ly) else 4)


def read_ranges(n_reads: int, lx: int, ly: int, per_read: int, budget: int,
                banded: bool = False,
                route: Optional[str] = None) -> List[Tuple[int, int]]:
    """Read ranges [r0, r1) of one DP launch, in order and covering every
    read, each taking at most `budget` bytes of scratch (per_read problems
    per read, dp_scratch_bytes each, or sw_pair's pair_scratch_bytes on a
    given route) unless one read alone takes more. sw_pair's packed route
    runs an odd range of plain rows (per_read == 1) with one empty problem
    more (pair_scratch_problems)."""
    need = per_read * (dp_scratch_bytes(lx, ly, banded) if route is None
                       else pair_scratch_bytes(lx, ly, route))
    step = max(1, budget // need) if need else max(1, n_reads)
    return [(r0, min(r0 + step, n_reads)) for r0 in range(0, n_reads, step)]


def pair_scratch_problems(ranges: List[Tuple[int, int]], per_read: int,
                          route: str) -> int:
    """Problems that sw_pair's scratch for `ranges` holds: those of the
    largest range (the first), rounded up to pairs on the packed route."""
    n = (ranges[0][1] - ranges[0][0]) * per_read
    return n + n % 2 if route == "packed" else n


def _scratch(n_problems: int, per_problem: int,
             dev: torch.device) -> Optional[torch.Tensor]:
    """One scratch buffer of n_problems, reused by each launch in stream
    order; None when no problem needs any."""
    if not per_problem:
        return None
    return torch.empty(n_problems * per_problem, dtype=torch.uint8,
                       device=dev)


def _output(R: int, per_read: int, codes: bool, dev: torch.device):
    """A launch's output, int8 codes [R] or int32 scores [per_read, R], and
    its (scores, codes) pointers, one of them None."""
    if codes:
        out = torch.empty(R, dtype=torch.int8, device=dev)
        return out, None, out.data_ptr()
    out = torch.empty((per_read, R), dtype=torch.int32, device=dev)
    return out, out.data_ptr(), None


def _launch(reads: torch.Tensor, read_lens: Optional[torch.Tensor],
            hap_mat: torch.Tensor, idx_ref: torch.Tensor,
            idx_alt: torch.Tensor, per_read: int, codes: bool,
            route: Optional[str] = None) -> torch.Tensor:
    """Validate, allocate and launch on the current stream; route: one of
    PAIR_ROUTES (default pair_route(lx, ly)); the kernel refuses a route
    that cannot hold min(lx, ly)."""
    global LAUNCHES
    dev = reads.device
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    _check(idx_ref, "idx_ref", torch.int32, 1, dev)
    _check(idx_alt, "idx_alt", torch.int32, 1, dev)
    R = reads.shape[0]
    packed2 = read_lens is not None
    lx = 4 * reads.shape[1] if packed2 else reads.shape[1]
    ly = hap_mat.shape[1]
    if packed2:
        _check(read_lens, "read_lens", torch.int32, 1, dev)
        if read_lens.shape[0] != R:
            raise ValueError("read_lens must have one entry per read")
    if idx_ref.shape[0] != R or idx_alt.shape[0] != R:
        raise ValueError("idx_ref and idx_alt must have one entry per read")
    route = pair_route(lx, ly) if route is None else route
    if route not in PAIR_ROUTES:
        raise ValueError(f"route must be one of {PAIR_ROUTES}, got {route!r}")
    lib = _kernel()
    out, scores_ptr, codes_ptr = _output(R, per_read, codes, dev)
    ranges = read_ranges(R, lx, ly, per_read, DP_SCRATCH_BYTES, route=route)
    if not ranges:
        return out
    scratch = _scratch(pair_scratch_problems(ranges, per_read, route),
                       pair_scratch_bytes(lx, ly, route), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    row_bytes = reads.shape[1]
    for r0, r1 in ranges:
        err = lib.sw_pair_launch(
            reads.data_ptr() + r0 * row_bytes,
            read_lens.data_ptr() + 4 * r0 if packed2 else None, r1 - r0, lx,
            int(packed2), hap_mat.data_ptr(), ly, idx_ref.data_ptr() + 4 * r0,
            idx_alt.data_ptr() + 4 * r0, per_read,
            scores_ptr + 4 * r0 if scores_ptr else None, R,
            codes_ptr + r0 if codes_ptr else None,
            None if scratch is None else scratch.data_ptr(),
            PAIR_ROUTES.index(route), stream)
        if err != 0:
            raise RuntimeError(f"sw_pair kernel launch failed ({route}): "
                               + lib.sw_pair_error_string(err).decode())
        LAUNCHES += 1
    return out


def pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                read_lens: Optional[torch.Tensor] = None, *,
                route: Optional[str] = None) -> torch.Tensor:
    """int32 [2, R] (ref, alt) scores. reads: uint8 [R, lx] (pad 0), or
    [R, lx//4] 2-bit codes with int32 read_lens [R]; hap_mat: uint8
    [H, ly] (pad 1); idx_ref, idx_alt: int32 [R] rows of hap_mat. route
    (the kernel only): one of PAIR_ROUTES in place of pair_route(lx, ly),
    for measurements."""
    if reads.device.type == "cpu":
        return sw_torch.pair_scores(reads, hap_mat, idx_ref, idx_alt,
                                    read_lens)
    return _launch(reads, read_lens, hap_mat, idx_ref, idx_alt, 2, False,
                   route)


def pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
               idx_ref: torch.Tensor, idx_alt: torch.Tensor,
               read_lens: Optional[torch.Tensor] = None, *,
               route: Optional[str] = None) -> torch.Tensor:
    """int8 [R] call codes of each read's (ref, alt) scores: 0 dropped
    (both below MIN_SCORE), 1 REF, 2 ALT, 3 tie. Arguments as pair_scores."""
    if reads.device.type == "cpu":
        return sw_torch.pair_calls(reads, hap_mat, idx_ref, idx_alt,
                                   read_lens)
    return _launch(reads, read_lens, hap_mat, idx_ref, idx_alt, 2, True,
                   route)


def batch_scores(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain rows: uint8 x [B, lx] (pad 0) against uint8 y [B, ly] (pad 1)
    -> int32 [B]; the pair kernel with one problem per read and identity
    haplotype indices."""
    if x.device.type == "cpu":
        return sw_torch.sw_scores(x, y)
    if y.shape[0] != x.shape[0]:
        raise ValueError("x and y must have the same number of rows")
    ident = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return _launch(x, None, y, ident, ident, 1, False)[0]


def _launch_banded(reads: torch.Tensor, hap_mat: torch.Tensor,
                   idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                   jlo: torch.Tensor, jhi: torch.Tensor,
                   codes: bool) -> torch.Tensor:
    """Validate, allocate and launch the banded kernel on the current
    stream."""
    global BANDED_LAUNCHES
    dev = reads.device
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    _check(idx_ref, "idx_ref", torch.int32, 1, dev)
    _check(idx_alt, "idx_alt", torch.int32, 1, dev)
    _check(jlo, "jlo", torch.int32, 2, dev)
    _check(jhi, "jhi", torch.int32, 2, dev)
    R, lx = reads.shape
    ly = hap_mat.shape[1]
    if idx_ref.shape[0] != R or idx_alt.shape[0] != R:
        raise ValueError("idx_ref and idx_alt must have one entry per read")
    if jlo.shape != (lx, 2 * R) or jhi.shape != jlo.shape:
        raise ValueError(f"jlo and jhi must be [{lx}, {2 * R}] (one "
                         "column per problem), got "
                         f"{list(jlo.shape)} and {list(jhi.shape)}")
    lib = _banded_kernel()
    out, scores_ptr, codes_ptr = _output(R, 2, codes, dev)
    ranges = read_ranges(R, lx, ly, 2, DP_SCRATCH_BYTES, banded=True)
    if not ranges:
        return out
    scratch = _scratch(2 * (ranges[0][1] - ranges[0][0]),
                       dp_scratch_bytes(lx, ly, True), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for r0, r1 in ranges:
        # problems 2 r0 .. 2 r1 - 1: columns of the bounds, 4 bytes each
        err = lib.sw_banded_launch(
            reads.data_ptr() + r0 * lx, r1 - r0, lx, hap_mat.data_ptr(), ly,
            idx_ref.data_ptr() + 4 * r0, idx_alt.data_ptr() + 4 * r0,
            jlo.data_ptr() + 8 * r0, jhi.data_ptr() + 8 * r0, 2 * R,
            scores_ptr + 4 * r0 if scores_ptr else None, R,
            codes_ptr + r0 if codes_ptr else None,
            None if scratch is None else scratch.data_ptr(),
            int(wide_word(lx, ly)), stream)
        if err != 0:
            raise RuntimeError("sw_banded kernel launch failed: "
                               + lib.sw_banded_error_string(err).decode())
        BANDED_LAUNCHES += 1
    return out


def banded_pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                       idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                       jlo: torch.Tensor, jhi: torch.Tensor) -> torch.Tensor:
    """int32 [2, R] banded (ref, alt) scores. reads: uint8 [R, lx] (pad 0);
    hap_mat: uint8 [H, ly] (pad 1); idx_ref, idx_alt: int32 [R] rows of
    hap_mat; jlo, jhi: int32 [lx, 2R] band bounds of each read row, problem
    2r the read's ref and 2r + 1 its alt (band_bounds)."""
    if reads.device.type == "cpu":
        return sw_banded_torch.banded_pair_scores(reads, hap_mat, idx_ref,
                                                  idx_alt, jlo, jhi)
    return _launch_banded(reads, hap_mat, idx_ref, idx_alt, jlo, jhi, False)


def banded_pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
                      idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                      jlo: torch.Tensor, jhi: torch.Tensor) -> torch.Tensor:
    """int8 [R] call codes of each read's banded (ref, alt) scores.
    Arguments as banded_pair_scores."""
    if reads.device.type == "cpu":
        return sw_banded_torch.banded_pair_calls(reads, hap_mat, idx_ref,
                                                 idx_alt, jlo, jhi)
    return _launch_banded(reads, hap_mat, idx_ref, idx_alt, jlo, jhi, True)


def band_ranges(ends: np.ndarray, lx: int,
                budget: int) -> List[Tuple[int, int]]:
    """Problem ranges [p0, p1) of the band builder's chain pass, in order
    and covering every problem, each taking at most `budget` bytes of
    scratch (12 per match, 8 per read row of a problem) unless one problem
    alone takes more. ends: int64 [P], the running sum of the problems'
    match counts."""
    need = 12 * np.asarray(ends, np.int64) + 8 * lx * np.arange(
        1, len(ends) + 1, dtype=np.int64)
    out, p0 = [], 0
    while p0 < len(need):
        base = need[p0 - 1] if p0 else 0
        p1 = max(p0 + 1, int(np.searchsorted(need, base + budget, "right")))
        out.append((p0, p1))
        p0 = p1
    return out


def _launch_index(hap_mat: torch.Tensor) -> BandIndex:
    """Validate, allocate and launch the index build on the current
    stream."""
    global INDEX_LAUNCHES
    dev = hap_mat.device
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    H, ly = hap_mat.shape
    index = BandIndex(torch.empty((H, ly), dtype=torch.int64, device=dev),
                      torch.empty((H, ly), dtype=torch.int32, device=dev),
                      torch.zeros(H, dtype=torch.int32, device=dev))
    if H == 0 or ly == 0:
        return index
    lib = _band_kernel()
    tmp_keys = torch.empty_like(index.keys)
    tmp_pos = torch.empty_like(index.pos)
    err = lib.band_index_build(
        hap_mat.data_ptr(), H, ly, index.keys.data_ptr(),
        index.pos.data_ptr(), tmp_keys.data_ptr(), tmp_pos.data_ptr(),
        index.hap_len.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("band_index kernel launch failed: "
                           + lib.band_build_error_string(err).decode())
    INDEX_LAUNCHES += 1
    return index


def band_index(hap_mat: torch.Tensor) -> BandIndex:
    """The k-mer index of the band builder: per haplotype row its true
    length and its 6-mer keys sorted by (key, j) (band_torch.BandIndex).
    hap_mat: uint8 [H, ly] (pad 1). Built once per haplotype matrix and
    passed to every band_bounds call over it."""
    if hap_mat.device.type == "cpu":
        return band_torch.band_index(hap_mat)
    return _launch_index(hap_mat)


def _launch_band(reads: torch.Tensor, hap_mat: torch.Tensor,
                 idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                 index: BandIndex) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate, allocate and launch the band builder on the current
    stream. Its match scratch is sized exactly: the count kernel's counts
    are summed on the device and the total is read (the host waits for the
    count pass there). A chunk within BAND_SCRATCH_BYTES (less the index)
    runs one chain pass; a larger one reads every problem's sum and runs
    the pass over the problem ranges of band_ranges, each in scratch of its
    own size."""
    global BAND_LAUNCHES
    dev = reads.device
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    _check(idx_ref, "idx_ref", torch.int32, 1, dev)
    _check(idx_alt, "idx_alt", torch.int32, 1, dev)
    R, lx = reads.shape
    H, ly = hap_mat.shape
    if idx_ref.shape[0] != R or idx_alt.shape[0] != R:
        raise ValueError("idx_ref and idx_alt must have one entry per read")
    _check(index.keys, "index.keys", torch.int64, 2, dev)
    _check(index.pos, "index.pos", torch.int32, 2, dev)
    _check(index.hap_len, "index.hap_len", torch.int32, 1, dev)
    if (index.keys.shape != (H, ly) or index.pos.shape != (H, ly)
            or index.hap_len.shape != (H,)):
        raise ValueError(f"the index is not one of a [{H}, {ly}] haplotype "
                         "matrix")
    P = 2 * R
    jlo = torch.empty((lx, P), dtype=torch.int32, device=dev)
    jhi = torch.empty((lx, P), dtype=torch.int32, device=dev)
    if P == 0 or lx == 0:
        return jlo, jhi
    lib = _band_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = torch.empty(P, dtype=torch.int64, device=dev)
    problems = (reads.data_ptr(), R, lx, ly, idx_ref.data_ptr(),
                idx_alt.data_ptr(), index.keys.data_ptr(),
                index.pos.data_ptr(), index.hap_len.data_ptr())
    err = lib.band_build_count(*problems, counts.data_ptr(), stream)
    if err == 0:
        ends = torch.cumsum(counts, 0)
        total = int(ends[-1])
        budget = max(0, BAND_SCRATCH_BYTES - 12 * H * ly)
        ranges = [(0, P, total)]
        if 12 * total + 8 * lx * P > budget:
            e = ends.cpu().numpy()  # every problem's sum, only when needed
            ranges = [(p0, p1, int(e[p1 - 1] - (e[p0 - 1] if p0 else 0)))
                      for p0, p1 in band_ranges(e, lx, budget)]
        for p0, p1, n in ranges:
            matches = torch.empty((3, max(n, 1)), dtype=torch.int32,
                                  device=dev)
            work = torch.empty((2, p1 - p0, lx), dtype=torch.int32,
                               device=dev)
            err = lib.band_build_chain(
                *problems, ends.data_ptr(), p0, p1, matches[0].data_ptr(),
                matches[1].data_ptr(), matches[2].data_ptr(),
                work[0].data_ptr(), work[1].data_ptr(), jlo.data_ptr(),
                jhi.data_ptr(), int(lx >= BAND_WIDE_KEYS_LX), stream)
            if err != 0:
                break
            BAND_LAUNCHES += 1
    if err != 0:
        raise RuntimeError("band_build kernel launch failed: "
                           + lib.band_build_error_string(err).decode())
    return jlo, jhi


def band_bounds(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                index: Optional[BandIndex] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chained-band bounds (k = 6, w = 20) of each read against its ref and
    alt haplotype rows: (jlo, jhi) int32 [lx, 2R], problem 2r the read's
    ref and 2r + 1 its alt; the same values as the host reference
    ops/sw_native.band_bounds. reads: uint8 [R, lx] (pad 0); hap_mat: uint8
    [H, ly] (pad 1); idx_ref, idx_alt: int32 [R] rows of hap_mat (the
    caller checks the range); index: band_index(hap_mat), built here when
    not given. The plain version on the CPU compares every pair of 6-mers
    and takes no index."""
    if reads.device.type == "cpu":
        return band_torch.band_bounds(reads, hap_mat, idx_ref, idx_alt)
    if index is None:
        index = band_index(hap_mat)
    return _launch_band(reads, hap_mat, idx_ref, idx_alt, index)


def _to(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _check_indices(n_haps: int, *idxs: np.ndarray) -> None:
    for idx in idxs:
        if len(idx) and (int(np.min(idx)) < 0 or int(np.max(idx)) >= n_haps):
            raise IndexError(f"haplotype index outside the {n_haps} rows")


def from_numpy(x: np.ndarray, hap_mat: np.ndarray, idx_ref: np.ndarray,
               idx_alt: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """The JAX entries' numpy arguments (x uint8 [R, lx], hap_mat uint8
    [H, ly], idx_ref/idx_alt int32 [R]) as the port's tensors on `device`.
    Raises when an index falls outside hap_mat."""
    _check_indices(hap_mat.shape[0], idx_ref, idx_alt)
    return (_to(x, np.uint8, device), _to(hap_mat, np.uint8, device),
            _to(idx_ref, np.int32, device), _to(idx_alt, np.int32, device))


class SwBackend:
    """Scoring backend on `device`: the CUDA kernel (kernel=True, needs a
    CUDA device) or the plain PyTorch version (kernel=False)."""

    def __init__(self, device: str = "cuda", kernel: bool = True):
        self.device = torch.device(device)
        if kernel and self.device.type != "cuda":
            raise ValueError("the CUDA kernel needs a CUDA device")
        self.kernel = kernel
        impl = (pair_scores, pair_calls, batch_scores) if kernel else (
            sw_torch.pair_scores, sw_torch.pair_calls, sw_torch.sw_scores)
        self._pair_scores, self._pair_calls, self._batch = impl

    def __call__(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """uint8 [B, lx] / [B, ly] rows -> int32 [B]."""
        outs = []
        for s in range(0, x.shape[0], 2 * CHUNK_READS):
            xt = torch.from_numpy(np.ascontiguousarray(
                x[s : s + 2 * CHUNK_READS], np.uint8)).to(self.device)
            yt = torch.from_numpy(np.ascontiguousarray(
                y[s : s + 2 * CHUNK_READS], np.uint8)).to(self.device)
            outs.append(self._batch(xt, yt))
        if not outs:
            return np.zeros(0, np.int32)
        return torch.cat(outs).cpu().numpy()

    def pair_chained(self, x, hap_mat, idx_ref, idx_alt) -> np.ndarray:
        """int32 [R, 2] (ref, alt) scores; x is uint8 [R, lx] or a read
        provider (see _chunks)."""
        outs = self._chunks(x, hap_mat, idx_ref, idx_alt, self._pair_scores)
        if not outs:
            return np.zeros((0, 2), np.int32)
        return torch.cat(outs, dim=1).T.cpu().numpy()

    def pair_calls_chained(self, x, hap_mat, idx_ref, idx_alt) -> np.ndarray:
        """int8 [R] call codes (the pipeline's default route)."""
        outs = self._chunks(x, hap_mat, idx_ref, idx_alt, self._pair_calls)
        if not outs:
            return np.zeros(0, np.int8)
        return torch.cat(outs).cpu().numpy()

    def _chunks(self, x, hap_mat, idx_ref, idx_alt, fn):
        """Launch `fn` over chunks of CHUNK_READS reads. x is a uint8
        [R, lx] array or a provider: `x(start, n)` -> uint8 [n, lx] rows,
        `.shape` == (R, lx), and optionally `.packed2(start, n)` -> (uint8
        [n, lx//4] 2-bit codes, int32 [n] lengths) or None when a chunk
        holds a base other than A/C/G/T. Outputs stay on the device until
        the caller gathers them, so chunk k+1's host gather overlaps chunk
        k's kernel."""
        R, lx = x.shape
        packed2 = (callable(x) and getattr(x, "packed2", None) is not None
                   and lx % 4 == 0)
        _check_indices(hap_mat.shape[0], idx_ref, idx_alt)
        dev = self.device
        hap = _to(hap_mat, np.uint8, dev)
        outs = []
        for start in range(0, R, CHUNK_READS):
            n = min(CHUNK_READS, R - start)
            lens = None
            if packed2:
                got = x.packed2(start, n)
                if got is None:
                    packed2 = False  # dense from here on
                else:
                    xc, lens = got
            if lens is None:
                xc = x(start, n) if callable(x) else x[start : start + n]
            outs.append(fn(
                _to(xc, np.uint8, dev), hap,
                _to(idx_ref[start : start + n], np.int32, dev),
                _to(idx_alt[start : start + n], np.int32, dev),
                None if lens is None else _to(lens, np.int32, dev)))
        return outs


class BandedSwBackend:
    """--sw-mode banded on `device`: the CUDA index build, band builder and
    banded kernel (kernel=True, needs a CUDA device) or the plain PyTorch
    band builder and banded DP (kernel=False). Per call (one shape bucket)
    the haplotypes' k-mer index is built once on the device; per chunk the
    band bounds are built there, on the current stream after the chunk's
    copy. The band builder's wrapper waits for its count pass (it reads the
    match sums to size the scratch), so chunk k's chain pass and banded DP,
    not its count pass, overlap chunk k+1's host gather. Empty haplotypes
    get an empty band and score 0."""

    def __init__(self, device: str = "cuda", kernel: bool = True):
        self.device = torch.device(device)
        if kernel and self.device.type != "cuda":
            raise ValueError("the CUDA kernel needs a CUDA device")
        self.kernel = kernel

    def pair_calls_chained(self, x, hap_mat, idx_ref, idx_alt) -> np.ndarray:
        """int8 [R] call codes. x is a uint8 [R, lx] array or a provider
        `x(start, n)` -> uint8 [n, lx] rows with `.shape` == (R, lx); reads
        ship dense, the bytes the band builder compares. Outputs stay on
        the device until all chunks are launched."""
        R, _ = x.shape
        _check_indices(hap_mat.shape[0], idx_ref, idx_alt)
        if R == 0:
            return np.zeros(0, np.int8)
        dev = self.device
        hap = _to(hap_mat, np.uint8, dev)
        if self.kernel:
            index = band_index(hap)
            calls = banded_pair_calls
        else:
            calls = sw_banded_torch.banded_pair_calls
        outs = []
        for start in range(0, R, CHUNK_READS):
            n = min(CHUNK_READS, R - start)
            xc = _to(x(start, n) if callable(x) else x[start : start + n],
                     np.uint8, dev)
            ir = _to(idx_ref[start : start + n], np.int32, dev)
            ia = _to(idx_alt[start : start + n], np.int32, dev)
            if self.kernel:
                jlo, jhi = band_bounds(xc, hap, ir, ia, index)
            else:
                jlo, jhi = band_torch.band_bounds(xc, hap, ir, ia)
            outs.append(calls(xc, hap, ir, ia, jlo, jhi))
        return torch.cat(outs).cpu().numpy()
