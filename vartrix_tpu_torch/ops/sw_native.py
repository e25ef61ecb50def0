"""ctypes binding of the host band builder of --sw-mode banded
(csrc/band_bounds.cpp), the counterpart of the JAX package's
ops/sw_native.banded_bounds_batch_native.

It is the port's exact host reference of the band, on no path of the
program: banded runs build their bounds on the device (csrc/band_build.cu
and its plain version ops/band_torch.py, through ops/sw_cuda.band_bounds),
and the tests and chip_smoke.py hold both against this builder.

`band_bounds` takes the padded matrices the pipeline holds and returns
int32 per-row band bounds in the banded kernel's [row][problem] layout;
the library is built with g++ at first use.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ._build import band_bounds_library

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(band_bounds_library())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.band_bounds_pairs.restype = None
        lib.band_bounds_pairs.argtypes = [vp, ctypes.c_int64, ctypes.c_int32,
                                          vp, ctypes.c_int32, vp, vp, vp, vp,
                                          ci]
        _lib = lib
    return _lib


def band_bounds(reads: np.ndarray, haps: np.ndarray, idx_ref: np.ndarray,
                idx_alt: np.ndarray, n_threads: int = 1
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Chained-band bounds (the reference tool's k = 6, w = 20) of each read
    against its ref and alt haplotype rows.

    reads: uint8 [R, lx] (pad 0); haps: uint8 [H, ly] (pad 1); idx_ref,
    idx_alt: int32 [R] rows of haps. Returns (jlo, jhi), int32 [lx, 2R]:
    column interval [jlo, jhi) of each read row, problem 2r the ref and
    2r + 1 the alt of read r. Unseeded pairs and rows past the read get
    [0, 0); a read or haplotype shorter than k gets [0, len_y) on every row
    of the read."""
    reads = np.ascontiguousarray(reads, np.uint8)
    haps = np.ascontiguousarray(haps, np.uint8)
    idxs = [np.ascontiguousarray(i, np.int32) for i in (idx_ref, idx_alt)]
    R, lx = reads.shape
    for idx in idxs:
        if idx.shape != (R,):
            raise ValueError("one haplotype index per read")
        if R and (int(idx.min()) < 0 or int(idx.max()) >= haps.shape[0]):
            raise IndexError(f"haplotype index outside the {haps.shape[0]} "
                             "rows")
    jlo = np.empty((lx, 2 * R), np.int32)
    jhi = np.empty((lx, 2 * R), np.int32)
    if R:
        _library().band_bounds_pairs(
            reads.ctypes.data, R, lx, haps.ctypes.data, haps.shape[1],
            idxs[0].ctypes.data, idxs[1].ctypes.data, jlo.ctypes.data,
            jhi.ctypes.data, max(int(n_threads), 1))
    return jlo, jhi
