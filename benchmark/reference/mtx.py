"""Reads a Matrix Market file as VarTrix writes it (sprs' writer) and
compares it with the reference's matrix.

    %%MatrixMarket matrix coordinate real general
    % written by sprs
    <rows> <cols> <nnz>
    <row> <col> <value>      (1-based, one line per entry)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

HEADER = (b"%%MatrixMarket matrix coordinate real general",
          b"% written by sprs")


class MalformedMatrix(ValueError):
    pass


def read(path: str):
    """((rows, cols), (row, col, value) arrays, 0-based)."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n", 3)
    if len(lines) < 3 or tuple(lines[:2]) != HEADER:
        raise MalformedMatrix(f"{path}: not a sprs Matrix Market header")
    try:
        n_rows, n_cols, nnz = (int(v) for v in lines[2].split())
    except ValueError as exc:
        raise MalformedMatrix(f"{path}: bad size line {lines[2]!r}") from exc
    body = lines[3] if len(lines) > 3 else b""
    tok = body.split()
    if len(tok) != 3 * nnz:
        raise MalformedMatrix(f"{path}: {len(tok) // 3} entries, header "
                              f"says {nnz}")
    vals = np.array(tok, dtype=np.float64).reshape(-1, 3) if nnz else (
        np.zeros((0, 3)))
    rows = vals[:, 0].astype(np.int64) - 1
    cols = vals[:, 1].astype(np.int64) - 1
    return (n_rows, n_cols), (rows, cols, vals[:, 2])


def mismatches(got, want) -> int:
    """Entries that differ between two (row, col, value) sets: present in
    one only, or with another value, or repeated."""
    def table(t):
        r, c, v = (np.asarray(a) for a in t)
        key = r.astype(np.int64) << 32 | c.astype(np.int64)
        order = np.argsort(key, kind="stable")
        return key[order], v[order].astype(np.float64)

    gk, gv = table(got)
    wk, wv = table(want)
    dup = int((gk[1:] == gk[:-1]).sum())
    both, gi, wi = np.intersect1d(gk, wk, assume_unique=False,
                                  return_indices=True)
    same = gv[gi] == wv[wi]
    only = (len(np.unique(gk)) - len(both)) + (len(np.unique(wk)) - len(both))
    return only + int((~same).sum()) + dup


def compare(path: str, want, shape: Tuple[int, int]) -> int:
    """Mismatched entries of the file at path against the reference's
    (row, col, value) arrays; a wrong shape counts every entry."""
    got_shape, got = read(path)
    if tuple(got_shape) != tuple(shape):
        return max(len(got[0]), len(want[0]), 1)
    return mismatches(got, want)
