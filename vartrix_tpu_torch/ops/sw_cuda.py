"""Wrapper of the CUDA Smith-Waterman pair kernel (csrc/sw_pair.cu) and the
scoring backend that core/fast_pipeline.score_all_fast drives.

The wrapper functions take tensors. CUDA tensors always go to the kernel;
CPU tensors go to the plain version (ops/sw_torch.py), the only case in
which it is taken. The kernel is built with nvcc at first use and bound
through ctypes; a failed build or launch raises.

`SwBackend` is the duck-typed backend contract of the pipeline: calling it
scores plain (x, y) rows, `.pair_chained` returns (ref, alt) scores and
`.pair_calls_chained` (the default route) returns one int8 call code per
read. It chunks each shape bucket into launches of CHUNK_READS reads,
shipping reads as 2-bit codes while every read of the bucket is A/C/G/T
and as dense bytes from the first chunk that is not.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import sw_torch
from ._build import kernel_library

# 131,072 (read, haplotype) problems per launch
CHUNK_READS = 65536

# kernel launches since the last reset; the smoke check zeroes it before
# driving the main path and reads it after
LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(kernel_library())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sw_pair_launch.restype = ci
        lib.sw_pair_launch.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, vp, ci,
                                       vp, vp, vp, vp]
        lib.sw_pair_scratch_rows.restype = ci
        lib.sw_pair_scratch_rows.argtypes = [ci, ci]
        lib.sw_pair_error_string.restype = ctypes.c_char_p
        lib.sw_pair_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, reads are on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(reads: torch.Tensor, read_lens: Optional[torch.Tensor],
            hap_mat: torch.Tensor, idx_ref: torch.Tensor,
            idx_alt: torch.Tensor, per_read: int, codes: bool) -> torch.Tensor:
    """Validate, allocate and launch on the current stream."""
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
    if min(lx, ly) >= 1 << 16:
        raise ValueError(f"read and haplotype widths ({lx}, {ly}) both at or "
                         "above 65536: scores would overflow the scratch "
                         "word")
    lib = _kernel()
    if codes:
        out = torch.empty(R, dtype=torch.int8, device=dev)
        scores_ptr, codes_ptr = None, out.data_ptr()
    else:
        out = torch.empty((per_read, R), dtype=torch.int32, device=dev)
        scores_ptr, codes_ptr = out.data_ptr(), None
    if R == 0:
        return out
    rows = lib.sw_pair_scratch_rows(lx, ly)
    scratch = torch.empty((rows, R * per_read), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sw_pair_launch(
        reads.data_ptr(), read_lens.data_ptr() if packed2 else None, R, lx,
        int(packed2), hap_mat.data_ptr(), ly, idx_ref.data_ptr(),
        idx_alt.data_ptr(), per_read, scores_ptr, codes_ptr,
        scratch.data_ptr() if rows else None, stream)
    if err != 0:
        raise RuntimeError("sw_pair kernel launch failed: "
                           + lib.sw_pair_error_string(err).decode())
    LAUNCHES += 1
    return out


def pair_scores(reads: torch.Tensor, hap_mat: torch.Tensor,
                idx_ref: torch.Tensor, idx_alt: torch.Tensor,
                read_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [2, R] (ref, alt) scores. reads: uint8 [R, lx] (pad 0), or
    [R, lx//4] 2-bit codes with int32 read_lens [R]; hap_mat: uint8
    [H, ly] (pad 1); idx_ref, idx_alt: int32 [R] rows of hap_mat."""
    if reads.device.type == "cpu":
        return sw_torch.pair_scores(reads, hap_mat, idx_ref, idx_alt,
                                    read_lens)
    return _launch(reads, read_lens, hap_mat, idx_ref, idx_alt, 2, False)


def pair_calls(reads: torch.Tensor, hap_mat: torch.Tensor,
               idx_ref: torch.Tensor, idx_alt: torch.Tensor,
               read_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [R] call codes of each read's (ref, alt) scores: 0 dropped
    (both below MIN_SCORE), 1 REF, 2 ALT, 3 tie. Arguments as pair_scores."""
    if reads.device.type == "cpu":
        return sw_torch.pair_calls(reads, hap_mat, idx_ref, idx_alt,
                                   read_lens)
    return _launch(reads, read_lens, hap_mat, idx_ref, idx_alt, 2, True)


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
