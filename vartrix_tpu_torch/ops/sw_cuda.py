"""Wrappers of the CUDA kernels (csrc/sw_pair.cu, full Smith-Waterman;
csrc/sw_banded.cu, banded Smith-Waterman; csrc/band_build.cu, the band
bounds of banded mode) and the scoring backends that
core/fast_pipeline.score_all_fast drives.

The wrapper functions take tensors. CUDA tensors always go to a kernel;
CPU tensors go to the plain version (ops/sw_torch.py, ops/sw_banded_torch.py,
ops/band_torch.py), the only case in which it is taken. Each kernel is
built with nvcc at first use and bound through ctypes; a failed build or
launch raises. The kernels take every (lx, ly): sw_pair runs two problems
per thread in 16-bit halves while min(lx, ly) <= 32,767, sw_banded while
ly <= 32,767, and both one per thread past that, with a 32-bit scratch
word up to min(lx, ly) = 65,535 and a 64-bit one from 65,536
(pair_route, banded_route). Every wrapper cuts a launch into ranges
whose scratch fits a fixed budget (read_ranges, band_ranges) and writes
them into one output.

The banded kernels, like sw_pair, take two layouts of problems: a read's
(ref, alt) pair (per_read 2, the native host path) and plain rows, read p
against haplotype row p (per_read 1: the Python host path, K4's own entry);
a wrapper given no idx_alt takes plain rows.

`SwBackend` is the duck-typed backend contract of the pipeline: calling it
scores plain (x, y) rows (core/pipeline.score_all, the Python host path),
`.pair_chained` returns (ref, alt) scores and `.pair_calls_chained` (the
native host path's default route) returns one int8 call code per read. It
is the JAX package's chunk dispatcher (`_chunked_pair_dispatch`): it cuts
each shape bucket into launches of CHUNK_READS reads and ships reads in
three formats, 2-bit A/C/G/T codes while every chunk so far is A/C/G/T,
4-bit BAM nibble codes from the first chunk that is not, and dense bytes
from the first chunk the 4-bit gather declines (host_chunks); the kernel
unpacks either code on its read load. A bucket's haplotypes (a PackedHaps)
ship 4-bit and are unpacked on the device once per bucket (device_haps).
One producer thread gathers and packs chunks up to PREFETCH_DEPTH ahead
(prefetched); the launching thread copies them to the device without a
stream synchronisation and launches in chunk order. The JAX package's second
knob, dispatch threads that keep two chunks in flight, has no counterpart:
the stream's own queue holds the launches in flight. `MeshSwBackend`
(--mesh-devices) has the same contract and splits each chunk's reads over
several devices, one SwBackend each. `BandedSwBackend` (--sw-mode banded)
scores plain rows when called (banded_batch_scores) and has the default
pair route: per shape bucket it builds the haplotypes' k-mer index once on
the device (band_index), then per chunk it ships dense reads and indices,
builds both problems' band bounds on the device (band_bounds) and scores
them there; no band stage runs on the host.
"""

from __future__ import annotations

import collections
import ctypes
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from . import band_torch, sw_banded_torch, sw_torch
from ._build import band_build_library, banded_kernel_library, kernel_library
from .band_torch import BandIndex

# 131,072 (read, haplotype) problems per launch
CHUNK_READS = 65536
# chunks one producer thread gathers and packs ahead of the chunk being
# launched (the JAX package's default); 0 gathers each chunk on the
# launching thread, between launches
PREFETCH_DEPTH = 2

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
# packed route) and csrc/sw_banded.cu (kStrip, every route): a read within
# one strip needs no scratch
PAIR_STRIP = 16
PACKED_STRIP = 32
BANDED_STRIP = 8
# read width from which the band builder's chain keys (score x 64 +
# nearness, a score at most the read's length) need 64 bits
BAND_WIDE_KEYS_LX = 1 << 25
# widest read whose band rows the band builder's chain pass keeps in
# shared memory (8 bytes per read row and problem, 8 problems per block);
# wider reads keep them in a work buffer in device memory (band_route)
BAND_SHARED_LX = 1024

# The recorder's counters (utils/trace.count) of this module:
# launch.<kernel>.<mode>, a kernel's launches (sw_pair, sw_banded: one per
# read range; band_build: one per chain-pass range) in its pair mode
# ("pair") or plain-row mode ("rows"), and launch.band_index, one per
# index; route.read.{p2,p4,dense}, the read chunks shipped in each format
# (host_chunks); route.hap.{p4,dense}, the haplotype matrices shipped
# 4-bit or dense (device_haps, once per bucket and device); score.chunks;
# score.h2d_bytes, the bytes _to hands to the scoring device.


def _mode(per_read: int) -> str:
    return "pair" if per_read == 2 else "rows"

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
        lib.sw_banded_launch.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, vp,
                                         vp, cl, vp, ci, vp, vp, ci, vp]
        lib.sw_banded_error_string.restype = ctypes.c_char_p
        lib.sw_banded_error_string.argtypes = [ci]
        _banded_lib = lib
    return _banded_lib


def bind_band_library(path: str) -> ctypes.CDLL:
    """A build of csrc/band_build.cu at `path`, its C entries typed."""
    lib = ctypes.CDLL(path)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.band_index_build.restype = ci
    lib.band_index_build.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, ci, vp]
    lib.band_build_count.restype = ci
    lib.band_build_count.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp, vp, vp,
                                     vp, vp]
    lib.band_build_chain.restype = ci
    lib.band_build_chain.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp, vp, vp,
                                     vp, cl, cl, vp, vp, vp, vp, vp, vp, vp,
                                     ci, vp]
    lib.band_build_error_string.restype = ctypes.c_char_p
    lib.band_build_error_string.argtypes = [ci]
    return lib


def _band_kernel() -> ctypes.CDLL:
    global _band_lib
    if _band_lib is None:
        _band_lib = bind_band_library(band_build_library())
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


def banded_route(lx: int, ly: int) -> str:
    """sw_banded's route for a bucket of lx x ly: "packed" while ly <=
    32,767, which keeps in an int16 half both an H (at most min(lx, ly))
    and a column's offset from a strip's first column, what the packed
    route compares with its rows' bounds; past that sw_pair's scalar
    routes by min(lx, ly) (pair_route)."""
    if ly <= PACKED_MAX:
        return "packed"
    return "word64" if wide_word(lx, ly) else "word32"


def banded_scratch_bytes(lx: int, ly: int, route: str) -> int:
    """Scratch bytes of one problem of sw_banded on `route`: two buffers
    of, per column, half a packed pair's 8-byte (G, F) words over ly
    rounded up to PACKED_COLS columns, or the scalar (H, F + 6) word, 4
    bytes or, on word64, 8; none when the read fits one strip."""
    if lx <= BANDED_STRIP:
        return 0
    if route == "packed":
        return 8 * (-(-ly // PACKED_COLS) * PACKED_COLS)
    return 2 * ly * (8 if route == "word64" else 4)


def dp_scratch_bytes(lx: int, ly: int, banded: bool = False) -> int:
    """Scratch bytes of one (read, haplotype) problem of sw_pair
    (pair_scratch_bytes) or, banded, of sw_banded (banded_scratch_bytes),
    each on its route for (lx, ly)."""
    if not banded:
        return pair_scratch_bytes(lx, ly, pair_route(lx, ly))
    return banded_scratch_bytes(lx, ly, banded_route(lx, ly))


def read_ranges(n_reads: int, lx: int, ly: int, per_read: int, budget: int,
                banded: bool = False,
                route: Optional[str] = None) -> List[Tuple[int, int]]:
    """Read ranges [r0, r1) of one launch of sw_pair or, banded, sw_banded,
    in order and covering every read, each taking at most `budget` bytes of
    scratch (per_read problems per read, pair_scratch_bytes or
    banded_scratch_bytes each on `route`, by default the kernel's route for
    (lx, ly)) unless one read alone takes more. The packed routes run an
    odd range of plain rows (per_read == 1) with one empty problem more
    (pair_scratch_problems)."""
    if route is None:
        route = (banded_route if banded else pair_route)(lx, ly)
    need = per_read * (banded_scratch_bytes if banded
                       else pair_scratch_bytes)(lx, ly, route)
    step = max(1, budget // need) if need else max(1, n_reads)
    return [(r0, min(r0 + step, n_reads)) for r0 in range(0, n_reads, step)]


def pair_scratch_problems(ranges: List[Tuple[int, int]], per_read: int,
                          route: str) -> int:
    """Problems that sw_pair's or sw_banded's scratch for `ranges` holds:
    those of the largest range (the first), rounded up to pairs on the
    packed route."""
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
            route: Optional[str] = None,
            read_bits: Optional[int] = 2) -> torch.Tensor:
    """Validate, allocate and launch on the current stream; route: one of
    PAIR_ROUTES (default pair_route(lx, ly)); the kernel refuses a route
    that cannot hold min(lx, ly). With read_lens, reads are codes of
    read_bits bits: lx = 8 x row bytes / read_bits."""
    dev = reads.device
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    _check(idx_ref, "idx_ref", torch.int32, 1, dev)
    _check(idx_alt, "idx_alt", torch.int32, 1, dev)
    R = reads.shape[0]
    # sw_pair_launch's read_format: 0 dense bytes, 1 2-bit, 2 4-bit codes
    if read_lens is None:
        fmt, lx = 0, reads.shape[1]
    elif read_bits in sw_torch.READ_BITS:
        fmt, lx = {2: 1, 4: 2}[read_bits], 8 * reads.shape[1] // read_bits
    else:
        raise ValueError(f"read_bits must be one of {sw_torch.READ_BITS}, "
                         f"got {read_bits!r}")
    ly = hap_mat.shape[1]
    if fmt:
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
            read_lens.data_ptr() + 4 * r0 if fmt else None,
            r1 - r0, lx, fmt, hap_mat.data_ptr(), ly,
            idx_ref.data_ptr() + 4 * r0, idx_alt.data_ptr() + 4 * r0,
            per_read,
            scores_ptr + 4 * r0 if scores_ptr else None, R,
            codes_ptr + r0 if codes_ptr else None,
            None if scratch is None else scratch.data_ptr(),
            PAIR_ROUTES.index(route), stream)
        if err != 0:
            raise RuntimeError(f"sw_pair kernel launch failed ({route}): "
                               + lib.sw_pair_error_string(err).decode())
        trace.count(f"launch.sw_pair.{_mode(per_read)}")
    return out


def pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                read_lens: Optional[torch.Tensor] = None, *,
                route: Optional[str] = None,
                read_bits: Optional[int] = 2) -> torch.Tensor:
    """int32 [2, R] (ref, alt) scores. reads: uint8 [R, lx] (pad 0), or
    with int32 read_lens [R] codes of read_bits bits per base (read only
    with read_lens): 2, [R, lx//4] A/C/G/T codes, low bits first; 4, [R,
    lx//2] BAM nibble codes of `=ACMGRSVTWYHKDBN`, high nibble first.
    hap_mat: uint8 [H, ly] (pad 1); idx_ref, idx_alt: int32 [R] rows of
    hap_mat. route (the kernel only): one of PAIR_ROUTES in place of
    pair_route(lx, ly), for measurements."""
    if reads.device.type == "cpu":
        return sw_torch.pair_scores(reads, hap_mat, idx_ref, idx_alt,
                                    read_lens, read_bits)
    return _launch(reads, read_lens, hap_mat, idx_ref, idx_alt, 2, False,
                   route, read_bits)


def pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
               idx_ref: torch.Tensor, idx_alt: torch.Tensor,
               read_lens: Optional[torch.Tensor] = None, *,
               route: Optional[str] = None,
               read_bits: Optional[int] = 2) -> torch.Tensor:
    """int8 [R] call codes of each read's (ref, alt) scores: 0 dropped
    (both below MIN_SCORE), 1 REF, 2 ALT, 3 tie. Arguments as pair_scores."""
    if reads.device.type == "cpu":
        return sw_torch.pair_calls(reads, hap_mat, idx_ref, idx_alt,
                                   read_lens, read_bits)
    return _launch(reads, read_lens, hap_mat, idx_ref, idx_alt, 2, True,
                   route, read_bits)


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


def _check_problems(reads: torch.Tensor, idx_ref: torch.Tensor,
                    idx_alt: Optional[torch.Tensor]) -> int:
    """per_read of a banded launch: 2 with idx_alt (a read's ref and alt),
    1 without (read p against idx_ref[p]); checks the index lengths."""
    dev = reads.device
    R = reads.shape[0]
    _check(idx_ref, "idx_ref", torch.int32, 1, dev)
    if idx_alt is not None:
        _check(idx_alt, "idx_alt", torch.int32, 1, dev)
    if idx_ref.shape[0] != R or (idx_alt is not None
                                 and idx_alt.shape[0] != R):
        raise ValueError("idx_ref and idx_alt must have one entry per read")
    return 1 if idx_alt is None else 2


def _launch_banded(reads: torch.Tensor, hap_mat: torch.Tensor,
                   idx_ref: torch.Tensor, idx_alt: Optional[torch.Tensor],
                   jlo: torch.Tensor, jhi: torch.Tensor, codes: bool,
                   route: Optional[str] = None) -> torch.Tensor:
    """Validate, allocate and launch the banded kernel on the current
    stream; plain rows (per_read 1) when idx_alt is None. route: one of
    PAIR_ROUTES, sw_banded's three by the same codes (default
    banded_route(lx, ly)); the kernel refuses a route that cannot hold
    the bucket (packed past ly = 32,767, word32 past min(lx, ly) =
    65,535)."""
    dev = reads.device
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    _check(jlo, "jlo", torch.int32, 2, dev)
    _check(jhi, "jhi", torch.int32, 2, dev)
    per_read = _check_problems(reads, idx_ref, idx_alt)
    if codes and per_read != 2:
        raise ValueError("call codes need each read's (ref, alt) pair")
    R, lx = reads.shape
    ly = hap_mat.shape[1]
    P = per_read * R
    if jlo.shape != (lx, P) or jhi.shape != jlo.shape:
        raise ValueError(f"jlo and jhi must be [{lx}, {P}] (one "
                         "column per problem), got "
                         f"{list(jlo.shape)} and {list(jhi.shape)}")
    route = banded_route(lx, ly) if route is None else route
    if route not in PAIR_ROUTES:
        raise ValueError(f"route must be one of {PAIR_ROUTES}, got {route!r}")
    lib = _banded_kernel()
    out, scores_ptr, codes_ptr = _output(R, per_read, codes, dev)
    ranges = read_ranges(R, lx, ly, per_read, DP_SCRATCH_BYTES, banded=True,
                         route=route)
    if not ranges:
        return out
    scratch = _scratch(pair_scratch_problems(ranges, per_read, route),
                       banded_scratch_bytes(lx, ly, route), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    alt_ptr = None if idx_alt is None else idx_alt.data_ptr()
    for r0, r1 in ranges:
        # problems per_read r0 .. per_read r1 - 1: columns of the bounds,
        # 4 bytes each
        err = lib.sw_banded_launch(
            reads.data_ptr() + r0 * lx, r1 - r0, lx, hap_mat.data_ptr(), ly,
            idx_ref.data_ptr() + 4 * r0,
            None if alt_ptr is None else alt_ptr + 4 * r0, per_read,
            jlo.data_ptr() + 4 * per_read * r0,
            jhi.data_ptr() + 4 * per_read * r0, P,
            scores_ptr + 4 * r0 if scores_ptr else None, R,
            codes_ptr + r0 if codes_ptr else None,
            None if scratch is None else scratch.data_ptr(),
            PAIR_ROUTES.index(route), stream)
        if err != 0:
            raise RuntimeError(f"sw_banded kernel launch failed ({route}): "
                               + lib.sw_banded_error_string(err).decode())
        trace.count(f"launch.sw_banded.{_mode(per_read)}")
    return out


def banded_pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                       idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                       jlo: torch.Tensor, jhi: torch.Tensor, *,
                       route: Optional[str] = None) -> torch.Tensor:
    """int32 [2, R] banded (ref, alt) scores. reads: uint8 [R, lx] (pad 0);
    hap_mat: uint8 [H, ly] (pad 1); idx_ref, idx_alt: int32 [R] rows of
    hap_mat; jlo, jhi: int32 [lx, 2R] band bounds of each read row, problem
    2r the read's ref and 2r + 1 its alt (band_bounds). route (the kernel
    only): one of PAIR_ROUTES in place of banded_route(lx, ly), for
    measurements."""
    if reads.device.type == "cpu":
        return sw_banded_torch.banded_pair_scores(reads, hap_mat, idx_ref,
                                                  idx_alt, jlo, jhi)
    return _launch_banded(reads, hap_mat, idx_ref, idx_alt, jlo, jhi, False,
                          route)


def banded_pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
                      idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                      jlo: torch.Tensor, jhi: torch.Tensor, *,
                      route: Optional[str] = None) -> torch.Tensor:
    """int8 [R] call codes of each read's banded (ref, alt) scores.
    Arguments as banded_pair_scores."""
    if reads.device.type == "cpu":
        return sw_banded_torch.banded_pair_calls(reads, hap_mat, idx_ref,
                                                 idx_alt, jlo, jhi)
    return _launch_banded(reads, hap_mat, idx_ref, idx_alt, jlo, jhi, True,
                          route)


def banded_scores(x: torch.Tensor, y: torch.Tensor, jlo: torch.Tensor,
                  jhi: torch.Tensor, *,
                  route: Optional[str] = None) -> torch.Tensor:
    """Plain rows: uint8 x [B, lx] (pad 0) against uint8 y [B, ly] (pad 1)
    within int32 jlo/jhi [lx, B] band bounds -> int32 [B] banded scores;
    the banded kernel with one problem per read and identity haplotype
    indices (K4's `_sw_banded_pairs` entry). route: as banded_pair_scores."""
    if x.device.type == "cpu":
        return sw_banded_torch.banded_scores(x, y, jlo, jhi)
    if y.shape[0] != x.shape[0]:
        raise ValueError("x and y must have the same number of rows")
    ident = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return _launch_banded(x, y, ident, None, jlo, jhi, False, route)[0]


def _plain_banded_batch_scores(x: torch.Tensor,
                               y: torch.Tensor) -> torch.Tensor:
    ident = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    jlo, jhi = band_torch.band_bounds(x, y, ident)
    return sw_banded_torch.banded_scores(x, y, jlo, jhi)


def banded_batch_scores(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain rows, banded: uint8 x [B, lx] (pad 0) against uint8 y [B, ly]
    (pad 1) -> int32 [B], each row pair's chained band (k = 6, w = 20)
    built and scored on the device: band_index(y) once, then band_bounds
    and banded_scores with identity indices. On the CPU the plain band
    builder and banded DP."""
    if x.device.type == "cpu":
        return _plain_banded_batch_scores(x, y)
    if y.shape[0] != x.shape[0]:
        raise ValueError("x and y must have the same number of rows")
    ident = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return banded_scores(x, y, *band_bounds(x, y, ident))


def band_route(lx: int) -> str:
    """The chain pass's width route for reads of width lx: "shared" keeps
    each problem's band rows in shared memory while lx <= BAND_SHARED_LX,
    "global" in a work buffer in device memory (8 bytes per read row)."""
    return "shared" if lx <= BAND_SHARED_LX else "global"


def band_work_bytes(lx: int, route: str) -> int:
    """Device bytes of one problem's band rows on the chain pass's width
    `route`: a work buffer row pair on "global", none on "shared"."""
    return 8 * lx if route == "global" else 0


def band_ranges(ends: np.ndarray, lx: int, budget: int,
                route: str) -> List[Tuple[int, int]]:
    """Problem ranges [p0, p1) of the band builder's chain pass, in order
    and covering every problem, each taking at most `budget` bytes of
    scratch (12 per match and, on the "global" route, 8 per read row of a
    problem) unless one problem alone takes more. ends: int64 [P], the
    running sum of the problems' match counts."""
    need = 12 * np.asarray(ends, np.int64) + band_work_bytes(
        lx, route) * np.arange(1, len(ends) + 1, dtype=np.int64)
    out, p0 = [], 0
    while p0 < len(need):
        base = need[p0 - 1] if p0 else 0
        p1 = max(p0 + 1, int(np.searchsorted(need, base + budget, "right")))
        out.append((p0, p1))
        p0 = p1
    return out


# the index build's width routes (csrc/band_build.cu band_index_build), by
# their code: each row's keys sorted on chip, or merge passes in device
# memory
INDEX_ROUTES = ("shared", "global")
# keys per thread of the shared route (kSortPerThread), per warp, and per
# row at most (kSortMaxKeys): the widest haplotype row it takes has
# INDEX_SHARED_KEYS + 5 bytes
INDEX_SORT_PER_THREAD = 8
INDEX_WARP_KEYS = 32 * INDEX_SORT_PER_THREAD
INDEX_SHARED_KEYS = 8192
INDEX_SHARED_LY = INDEX_SHARED_KEYS + 5


def index_route(ly: int) -> str:
    """The index build's route for haplotype rows of width ly: "shared"
    while a row's ly - 5 keys fit one block's sort on chip
    (INDEX_SHARED_LY), else "global"."""
    return "shared" if ly <= INDEX_SHARED_LY else "global"


def index_shape(ly: int) -> Tuple[int, int, int]:
    """The shared route's launch shape for rows of width ly (band_build.cu
    index_shape): (sort, threads per row, rows per block). sort: the ly - 5
    keys rounded up to a power of two, at least a warp's INDEX_WARP_KEYS;
    a warp per row and 8 rows per block at that size, else sort / 8
    threads and one row per block."""
    n = max(ly - 5, 0)
    sort = INDEX_WARP_KEYS
    while sort < n:
        sort *= 2
    if sort > INDEX_SHARED_KEYS:
        raise ValueError(f"rows of {ly} bytes do not fit the shared route")
    group = sort // INDEX_SORT_PER_THREAD
    return sort, group, 8 if group == 32 else 1


def index_buffers(H: int, ly: int, route: str,
                  dev: torch.device) -> Tuple[BandIndex, tuple]:
    """The index of an [H, ly] matrix as the wrapper allocates it on `dev`
    (keys int64 [H, ly], pos int32 [H, ly], hap_len int32 [H]), and the
    route's scratch (tmp_keys, tmp_pos) of the same shapes on "global"
    only: (None, None) on "shared". Three allocations: on the card they
    take less host time than one buffer cut into views (PERF.md)."""
    index = BandIndex(torch.empty((H, ly), dtype=torch.int64, device=dev),
                      torch.empty((H, ly), dtype=torch.int32, device=dev),
                      torch.empty(H, dtype=torch.int32, device=dev))
    if route != "global":
        return index, (None, None)
    return index, (torch.empty_like(index.keys), torch.empty_like(index.pos))


def _launch_index(hap_mat: torch.Tensor,
                  route: Optional[str] = None) -> BandIndex:
    """Validate, allocate and launch the index build on the current
    stream; route: one of INDEX_ROUTES (default index_route(ly)); the
    kernel refuses the shared route past INDEX_SHARED_LY. The kernel
    writes every row's length, so only a matrix without rows or columns
    gets its zeros here."""
    dev = hap_mat.device
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    H, ly = hap_mat.shape
    route = index_route(ly) if route is None else route
    if route not in INDEX_ROUTES:
        raise ValueError(f"route must be one of {INDEX_ROUTES}, got {route!r}")
    index, tmp = index_buffers(H, ly, route, dev)
    if H == 0 or ly == 0:
        index.hap_len.zero_()
        return index
    lib = _band_kernel()
    err = lib.band_index_build(
        hap_mat.data_ptr(), H, ly, index.keys.data_ptr(),
        index.pos.data_ptr(), *(None if t is None else t.data_ptr()
                                for t in tmp),
        index.hap_len.data_ptr(), INDEX_ROUTES.index(route),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_index kernel launch failed ({route}): "
                           + lib.band_build_error_string(err).decode())
    trace.count("launch.band_index")
    return index


def band_index(hap_mat: torch.Tensor, *,
               route: Optional[str] = None) -> BandIndex:
    """The k-mer index of the band builder: per haplotype row its true
    length and its 6-mer keys sorted by (key, j) (band_torch.BandIndex).
    hap_mat: uint8 [H, ly] (pad 1). Built once per haplotype matrix and
    passed to every band_bounds call over it. route (the kernel only): one
    of INDEX_ROUTES in place of index_route(ly), for measurements."""
    if hap_mat.device.type == "cpu":
        return band_torch.band_index(hap_mat)
    return _launch_index(hap_mat, route)


def band_problems(reads: torch.Tensor, hap_mat: torch.Tensor,
                  idx_ref: torch.Tensor, idx_alt: Optional[torch.Tensor],
                  index: BandIndex) -> tuple:
    """Validates a band build's inputs; returns (the C entries' problem
    arguments, per_read): plain rows (per_read 1) when idx_alt is None."""
    dev = reads.device
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(hap_mat, "hap_mat", torch.uint8, 2, dev)
    per_read = _check_problems(reads, idx_ref, idx_alt)
    R, lx = reads.shape
    H, ly = hap_mat.shape
    _check(index.keys, "index.keys", torch.int64, 2, dev)
    _check(index.pos, "index.pos", torch.int32, 2, dev)
    _check(index.hap_len, "index.hap_len", torch.int32, 1, dev)
    if (index.keys.shape != (H, ly) or index.pos.shape != (H, ly)
            or index.hap_len.shape != (H,)):
        raise ValueError(f"the index is not one of a [{H}, {ly}] haplotype "
                         "matrix")
    return (reads.data_ptr(), R, lx, ly, idx_ref.data_ptr(),
            None if idx_alt is None else idx_alt.data_ptr(), per_read,
            index.keys.data_ptr(), index.pos.data_ptr(),
            index.hap_len.data_ptr()), per_read


def band_chain(lib: ctypes.CDLL, problems: tuple, P: int, H: int,
               ends: torch.Tensor, total: int, jlo: torch.Tensor,
               jhi: torch.Tensor, route: str) -> int:
    """The chain pass of `lib` over problems [0, P), given the count
    pass's running sums `ends` and their total: one launch when the
    match scratch (and, on the "global" route, the work rows) fits
    BAND_SCRATCH_BYTES less the index, else one per problem range of
    band_ranges, each in scratch of its own size. Each launch adds one to
    launch.band_build.pair (pair mode) or launch.band_build.rows (plain
    rows). Returns the first error, or 0."""
    lx, ly, per_read = problems[2], problems[3], problems[6]
    dev = jlo.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    budget = max(0, BAND_SCRATCH_BYTES - 12 * H * ly)
    ranges = [(0, P, total)]
    if 12 * total + band_work_bytes(lx, route) * P > budget:
        with trace.span("vartrix::score.sync"):
            e = ends.cpu().numpy()  # every problem's sum, only when needed
        ranges = [(p0, p1, int(e[p1 - 1] - (e[p0 - 1] if p0 else 0)))
                  for p0, p1 in band_ranges(e, lx, budget, route)]
    for p0, p1, n in ranges:
        matches = torch.empty((3, max(n, 1)), dtype=torch.int32, device=dev)
        work = (torch.empty((2, p1 - p0, lx), dtype=torch.int32, device=dev)
                if route == "global" else None)
        err = lib.band_build_chain(
            *problems, ends.data_ptr(), p0, p1, matches[0].data_ptr(),
            matches[1].data_ptr(), matches[2].data_ptr(),
            None if work is None else work[0].data_ptr(),
            None if work is None else work[1].data_ptr(), jlo.data_ptr(),
            jhi.data_ptr(), int(lx >= BAND_WIDE_KEYS_LX), stream)
        if err != 0:
            return err
        trace.count(f"launch.band_build.{_mode(per_read)}")
    return 0


def _launch_band(reads: torch.Tensor, hap_mat: torch.Tensor,
                 idx_ref: torch.Tensor, idx_alt: Optional[torch.Tensor],
                 index: BandIndex) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate, allocate and launch the band builder on the current
    stream; plain rows (per_read 1) when idx_alt is None. Its match
    scratch is sized exactly: the count kernel's counts are summed on the
    device and the total is read (the host waits for the count pass
    there); then the chain pass (band_chain) on the width route of
    band_route."""
    problems, per_read = band_problems(reads, hap_mat, idx_ref, idx_alt,
                                       index)
    R, lx = reads.shape
    P = per_read * R
    dev = reads.device
    jlo = torch.empty((lx, P), dtype=torch.int32, device=dev)
    jhi = torch.empty((lx, P), dtype=torch.int32, device=dev)
    if P == 0 or lx == 0:
        return jlo, jhi
    lib = _band_kernel()
    counts = torch.empty(P, dtype=torch.int64, device=dev)
    err = lib.band_build_count(*problems, counts.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err == 0:
        ends = torch.cumsum(counts, 0)
        with trace.span("vartrix::score.sync"):
            total = int(ends[-1])
        err = band_chain(lib, problems, P, hap_mat.shape[0], ends, total,
                         jlo, jhi, band_route(lx))
    if err != 0:
        raise RuntimeError("band_build kernel launch failed: "
                           + lib.band_build_error_string(err).decode())
    return jlo, jhi


def band_bounds(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: Optional[torch.Tensor] = None,
                index: Optional[BandIndex] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chained-band bounds (k = 6, w = 20) of each read against its ref and
    alt haplotype rows: (jlo, jhi) int32 [lx, 2R], problem 2r the read's
    ref and 2r + 1 its alt; without idx_alt, of read r against row
    idx_ref[r] only: int32 [lx, R]. The same values as the host reference
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


def _to(a: np.ndarray, dtype, device,
        non_blocking: bool = False) -> torch.Tensor:
    """a as a tensor of dtype on device; its bytes count to
    score.h2d_bytes, whatever the device."""
    a = np.ascontiguousarray(a, dtype=dtype)
    trace.count("score.h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device, non_blocking=non_blocking)


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


def _gather(outs: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The launches' outputs, in order, as one host tensor: those of other
    devices join the first one's, then one copy to the host."""
    first = outs[0].device
    with trace.span("vartrix::score.sync"):
        return torch.cat([o.to(first) for o in outs], dim=dim).cpu()


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
            outs += self._rows(x[s : s + 2 * CHUNK_READS],
                               y[s : s + 2 * CHUNK_READS])
        if not outs:
            return np.zeros(0, np.int32)
        return _gather(outs).numpy()

    def pair_chained(self, x, hap_mat, idx_ref, idx_alt) -> np.ndarray:
        """int32 [R, 2] (ref, alt) scores; x is uint8 [R, lx] or a read
        provider (see host_chunks)."""
        outs = self._chunks(x, hap_mat, idx_ref, idx_alt, "_pair_scores")
        if not outs:
            return np.zeros((0, 2), np.int32)
        return _gather(outs, dim=1).T.numpy()

    def pair_calls_chained(self, x, hap_mat, idx_ref, idx_alt) -> np.ndarray:
        """int8 [R] call codes (the pipeline's default route)."""
        outs = self._chunks(x, hap_mat, idx_ref, idx_alt, "_pair_calls")
        if not outs:
            return np.zeros(0, np.int8)
        return _gather(outs).numpy()

    def _rows(self, x: np.ndarray, y: np.ndarray) -> List[torch.Tensor]:
        """One chunk of plain rows scored on the device."""
        return [self._batch(_to(x, np.uint8, self.device),
                            _to(y, np.uint8, self.device))]

    def _chunks(self, x, hap_mat, idx_ref, idx_alt, fn: str):
        """Launch the wrapper `fn` names over chunks of CHUNK_READS reads
        (host_chunks), gathered ahead on a producer thread (prefetched).
        Outputs stay on the device until the caller gathers them."""
        _check_indices(hap_mat.shape[0], idx_ref, idx_alt)
        hap = device_haps(hap_mat, self.device)
        launch = getattr(self, fn)
        with prefetched(host_chunks(x, idx_ref, idx_alt),
                        PREFETCH_DEPTH) as chunks:
            return [_launch_part(launch, self.device, hap, *chunk)
                    for chunk in chunks]


def device_haps(hap_mat, dev: torch.device) -> torch.Tensor:
    """A bucket's haplotype matrix as uint8 [H, ly] (pad 1) on `dev`: a
    PackedHaps ships its 4-bit rows and lengths and is unpacked there
    (sw_torch.unpack4, once per bucket and device: the JAX package's
    `_unpack4_jit`, plain XLA there too); any other matrix ships dense.
    Counts route.hap.p4 or route.hap.dense."""
    with trace.span("vartrix::score.haps"):
        if isinstance(hap_mat, sw_torch.PackedHaps):
            trace.count("route.hap.p4")
            return sw_torch.unpack4(_to(hap_mat.packed, np.uint8, dev),
                                    _to(hap_mat.lens, np.int32, dev),
                                    hap_mat.shape[1], pad=1)
        trace.count("route.hap.dense")
        return _to(hap_mat, np.uint8, dev)


def host_chunks(x, idx_ref: np.ndarray, idx_alt: np.ndarray):
    """Yields each chunk of CHUNK_READS reads as host arrays (read_bits,
    reads, their lengths, idx_ref, idx_alt): read_bits 2 or 4 for codes
    with lengths, None for dense bytes with lengths None; it adds one to
    score.chunks and to the format's route.read.{p2,p4,dense}, and times
    each chunk's gather as the span score.gather. x is a uint8 [R, lx]
    array or a provider: `x(start, n)` -> uint8 [n, lx] rows, `.shape` ==
    (R, lx), and optionally `.packed2(start, n)` -> (uint8 [n, lx//4]
    2-bit codes, int32 [n] lengths) and `.packed(start, n)` -> (uint8 [n,
    lx//2] 4-bit codes, int32 [n] lengths), each None when the chunk
    holds a byte its format lacks. The JAX package's chunk preparation
    (`_chunked_pair_dispatch`'s prep): "p2" while every chunk so far is
    A/C/G/T (lx % 4 == 0); from the first chunk the 2-bit gather declines,
    "p4" from that same chunk on (lx even); from the first chunk the 4-bit
    gather declines, "dense". A format once declined is not tried again.
    (The JAX package also needs `.packed` before it tries `.packed2`; the
    pipeline's provider has both.)"""
    R, lx = x.shape
    provider = callable(x)
    p2 = provider and getattr(x, "packed2", None) is not None and lx % 4 == 0
    p4 = provider and getattr(x, "packed", None) is not None and lx % 2 == 0
    for start in range(0, R, CHUNK_READS):
        n = min(CHUNK_READS, R - start)
        got = None
        with trace.span("vartrix::score.gather"):
            if p2:
                got, bits = x.packed2(start, n), 2
                p2 = got is not None
            if got is None and p4:
                got, bits = x.packed(start, n), 4
                p4 = got is not None
            if got is None:
                bits = None
                got = (x(start, n) if provider else x[start : start + n]), None
        trace.count(f"route.read.{f'p{bits}' if bits else 'dense'}")
        trace.count("score.chunks")
        yield (bits, *got, idx_ref[start : start + n],
               idx_alt[start : start + n])


@contextmanager
def prefetched(items, depth: int):
    """The iterator `items` advanced on one producer thread up to `depth`
    items ahead of its consumer, which gets them in order; depth 0
    advances it on the consumer's thread. An exception raised while
    producing an item is raised to the consumer at that item, and nothing
    retries it. On exit no thread is left running: items not yet begun
    are cancelled and the producer is joined."""
    if depth <= 0:
        yield iter(items)
        return
    end = object()
    ahead = collections.deque()
    with ThreadPoolExecutor(1, thread_name_prefix="chunk-gather") as ex:

        # the producer thread's spans are children of the caller's
        advance = trace.carry(next)

        def consume():
            for _ in range(depth):
                ahead.append(ex.submit(advance, items, end))
            while True:
                item = ahead.popleft().result()
                if item is end:
                    return
                ahead.append(ex.submit(advance, items, end))
                yield item

        try:
            yield consume()
        finally:
            for f in ahead:
                f.cancel()


def _launch_part(fn, dev: torch.device, hap: torch.Tensor, read_bits, xc,
                 lens, ir, ia):
    """`fn` (a pair wrapper) on one host chunk of host_chunks' (bits per
    read base or None, reads, their lengths or None, idx_ref, idx_alt),
    copied to `dev`; hap lies there already. The copies are non_blocking:
    from the arrays' own pageable memory the CUDA driver stages each before
    the call returns, and PyTorch leaves out the stream synchronisation of
    a blocking copy, which would wait for the chunks launched before.
    (Page-locked copies of each chunk, and copies on a stream of their
    own, measured no faster end to end.)"""

    def to(a, dtype):
        return None if a is None else _to(a, dtype, dev, non_blocking=True)

    with trace.span("vartrix::score.launch"):
        return fn(to(xc, np.uint8), hap, to(ir, np.int32), to(ia, np.int32),
                  to(lens, np.int32), read_bits=read_bits)


def device_context(dev: torch.device):
    """The context that makes `dev` the current CUDA device (the kernels
    launch on the current device's stream); none on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def split_rows(n: int, n_parts: int) -> List[Tuple[int, int]]:
    """n rows as n_parts contiguous ranges [a, b) in order, their lengths
    at most one row apart; empty ranges dropped."""
    bounds = [n * p // n_parts for p in range(n_parts + 1)]
    return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


class MeshSwBackend(SwBackend):
    """SwBackend split over local devices (--mesh-devices; the counterpart
    of the JAX package's make_mesh_scorer): one SwBackend per device, each
    chunk of reads cut into contiguous parts, one per device, each part
    launched on its device against the device's copy of the haplotype
    matrix, and the outputs gathered back in read order. A part keeps each
    read's (ref, alt) indices and 2- or 4-bit length with the read, and
    each device unpacks its own copy of a PackedHaps. The kernel
    (kernel=True, every device CUDA) or the plain version runs on every
    part. Scores are per read, so they do not depend on the split."""

    def __init__(self, devices, kernel: bool = True):
        super().__init__(devices[0], kernel)
        self.parts = [SwBackend(d, kernel) for d in devices]

    def _rows(self, x: np.ndarray, y: np.ndarray) -> List[torch.Tensor]:
        outs = []
        for be, (a, b) in zip(self.parts,
                              split_rows(len(x), len(self.parts))):
            with device_context(be.device):
                outs += be._rows(x[a:b], y[a:b])
        return outs

    def _chunks(self, x, hap_mat, idx_ref, idx_alt, fn: str):
        _check_indices(hap_mat.shape[0], idx_ref, idx_alt)
        haps = [device_haps(hap_mat, be.device) for be in self.parts]
        outs = []
        with prefetched(host_chunks(x, idx_ref, idx_alt),
                        PREFETCH_DEPTH) as chunks:
            for bits, xc, lens, ir, ia in chunks:
                for be, hap, (a, b) in zip(
                        self.parts, haps,
                        split_rows(len(ir), len(self.parts))):
                    with device_context(be.device):
                        outs.append(_launch_part(
                            getattr(be, fn), be.device, hap, bits, xc[a:b],
                            None if lens is None else lens[a:b], ir[a:b],
                            ia[a:b]))
        return outs


class BandedSwBackend:
    """--sw-mode banded on `device`: the CUDA index build, band builder and
    banded kernel (kernel=True, needs a CUDA device) or the plain PyTorch
    band builder and banded DP (kernel=False). Called on plain rows (the
    Python host path), it scores chunks of 2 * CHUNK_READS rows with
    banded_batch_scores. On the pair route, per call (one shape bucket)
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
        self._batch = (banded_batch_scores if kernel
                       else _plain_banded_batch_scores)

    def __call__(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """uint8 [B, lx] / [B, ly] rows -> int32 [B] banded scores."""
        outs = []
        for s in range(0, x.shape[0], 2 * CHUNK_READS):
            xt = _to(x[s : s + 2 * CHUNK_READS], np.uint8, self.device)
            yt = _to(y[s : s + 2 * CHUNK_READS], np.uint8, self.device)
            outs.append(self._batch(xt, yt))
        if not outs:
            return np.zeros(0, np.int32)
        return _gather(outs).numpy()

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
        with trace.span("vartrix::score.haps"):
            hap = _to(hap_mat, np.uint8, dev)
            if self.kernel:
                index = band_index(hap)
        calls = (banded_pair_calls if self.kernel
                 else sw_banded_torch.banded_pair_calls)
        outs = []
        for start in range(0, R, CHUNK_READS):
            n = min(CHUNK_READS, R - start)
            with trace.span("vartrix::score.gather"):
                xs = x(start, n) if callable(x) else x[start : start + n]
            trace.count("score.chunks")
            with trace.span("vartrix::score.launch"):
                xc = _to(xs, np.uint8, dev)
                ir = _to(idx_ref[start : start + n], np.int32, dev)
                ia = _to(idx_alt[start : start + n], np.int32, dev)
                if self.kernel:
                    jlo, jhi = band_bounds(xc, hap, ir, ia, index)
                else:
                    jlo, jhi = band_torch.band_bounds(xc, hap, ir, ia)
                outs.append(calls(xc, hap, ir, ia, jlo, jhi))
        return _gather(outs).numpy()
