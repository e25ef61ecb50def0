"""Sparse triplet matrix + Matrix Market writer.

Reproduces the exact on-disk format the reference emits through sprs'
`write_matrix_market` (reference src/main.rs:381-389):

    %%MatrixMarket matrix coordinate real general
    % written by sprs
    <rows> <cols> <nnz>
    <row> <col> <value>      (1-based indices)

Values are f64 printed with Rust's `Display` semantics: shortest
round-trip representation, integral values without a decimal point,
NaN printed as `NaN` (formatted by libgenomio, io/bam_native.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .bam_native import mtx_format_native


class TriMat:
    """Triplet (COO) accumulation matrix, insertion-ordered like sprs TriMat."""

    def __init__(self, shape: Tuple[int, int]):
        self.shape = shape
        self._chunks: list = []  # (rows, cols, vals) blocks

    def add_triplets(self, rows, cols, values) -> None:
        """Bulk insertion from array-likes (vectorized bounds check)."""
        r = np.asarray(rows, dtype=np.int64)
        c = np.asarray(cols, dtype=np.int64)
        v = np.asarray(values, dtype=np.float64)
        if not (len(r) == len(c) == len(v)):
            raise ValueError(
                f"triplet arrays disagree: {len(r)}/{len(c)}/{len(v)}")
        bad = (r < 0) | (r >= self.shape[0]) | (c < 0) | (c >= self.shape[1])
        if bad.any():
            k = np.nonzero(bad)[0][0]
            raise IndexError(
                f"triplet ({r[k]},{c[k]}) outside shape {self.shape}")
        if len(r):
            self._chunks.append((r.copy(), c.copy(), v.copy()))

    def _arrays(self):
        """(rows, cols, vals) as single consolidated arrays."""
        if not self._chunks:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=np.float64)
        if len(self._chunks) > 1:
            self._chunks = [tuple(np.concatenate([c[k] for c in self._chunks])
                                  for k in range(3))]
        return self._chunks[0]

    @property
    def rows(self) -> np.ndarray:
        return self._arrays()[0]

    @property
    def cols(self) -> np.ndarray:
        return self._arrays()[1]

    @property
    def data(self) -> np.ndarray:
        return self._arrays()[2]

    def nnz(self) -> int:
        return sum(len(c[0]) for c in self._chunks)


def write_matrix_market(path: str, mat: TriMat) -> None:
    header = ("%%MatrixMarket matrix coordinate real general\n"
              "% written by sprs\n"
              f"{mat.shape[0]} {mat.shape[1]} {mat.nnz()}\n")
    body = (mtx_format_native(mat.rows + 1, mat.cols + 1, mat.data)
            if mat.nnz() else b"")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(body)
