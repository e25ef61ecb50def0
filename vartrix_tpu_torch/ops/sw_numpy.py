"""NumPy Smith-Waterman traceback for --log-level debug on the Python host
path: the reference's per-read pretty alignments (src/main.rs:903-921).

Affine-gap local alignment with the reference's scoring (match 1,
mismatch -5, a gap of length L costs GAP_OPEN + L * GAP_EXTEND), bytes
compared raw. Scores come from the scoring backends (ops/sw_cuda.py); this
module only renders alignments.
"""

from __future__ import annotations

import numpy as np

from ..constants import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH

NEG = np.int32(-(1 << 28))


def sw_traceback(x: bytes, y: bytes):
    """Full local SW with traceback for debug logging.

    Returns (score, xstart, xend, ystart, yend, ops) where ops is a list
    of ('M'|'S'|'I'|'D') per column: match, substitution, insertion
    (x-only base), deletion (y-only base). Used to reproduce the
    reference's debug-level pretty alignment logs (src/main.rs:903-921).
    """
    Lx, Ly = len(x), len(y)
    if Lx == 0 or Ly == 0:
        return 0, 0, 0, 0, 0, []
    NEGV = int(NEG)
    H = np.zeros((Lx + 1, Ly + 1), dtype=np.int64)
    E = np.full((Lx + 1, Ly + 1), NEGV, dtype=np.int64)
    F = np.full((Lx + 1, Ly + 1), NEGV, dtype=np.int64)
    xa = np.frombuffer(x, np.uint8)
    ya = np.frombuffer(y, np.uint8)
    for i in range(1, Lx + 1):
        s = np.where(ya == xa[i - 1], MATCH, MISMATCH).astype(np.int64)
        Hp = H[i - 1]
        E[i, 1:] = 0  # computed left-to-right below
        e = NEGV
        F[i, 1:] = np.maximum(Hp[1:] + GAP_OPEN + GAP_EXTEND,
                              F[i - 1, 1:] + GAP_EXTEND)
        row = H[i]
        for j in range(1, Ly + 1):
            e = max(row[j - 1] + GAP_OPEN + GAP_EXTEND, e + GAP_EXTEND)
            E[i, j] = e
            row[j] = max(0, Hp[j - 1] + s[j - 1], e, F[i, j])
    best_flat = int(np.argmax(H))
    bi, bj = divmod(best_flat, Ly + 1)
    score = int(H[bi, bj])
    ops = []
    i, j = bi, bj
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            if H[i, j] == 0:
                break
            s = MATCH if xa[i - 1] == ya[j - 1] else MISMATCH
            if H[i, j] == H[i - 1, j - 1] + s:
                ops.append("M" if s == MATCH else "S")
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":  # gap consuming y
            ops.append("D")
            if E[i, j] == H[i, j - 1] + GAP_OPEN + GAP_EXTEND:
                state = "H"
            j -= 1
        else:  # F: gap consuming x
            ops.append("I")
            if F[i, j] == H[i - 1, j] + GAP_OPEN + GAP_EXTEND:
                state = "H"
            i -= 1
    ops.reverse()
    return score, i, bi, j, bj, ops


def pretty_alignment(x: bytes, y: bytes) -> str:
    """Three-line local-alignment rendering (x row, operation row, y row)
    in the spirit of rust-bio's Alignment::pretty, for debug logs."""
    score, xs, xe, ys, ye, ops = sw_traceback(x, y)
    xi, yi = xs, ys
    lx, lm, ly_ = [], [], []
    for op in ops:
        if op in ("M", "S"):
            lx.append(chr(x[xi]))
            ly_.append(chr(y[yi]))
            lm.append("|" if op == "M" else "\\")
            xi += 1
            yi += 1
        elif op == "I":
            lx.append(chr(x[xi]))
            ly_.append("-")
            lm.append("+")
            xi += 1
        else:
            lx.append("-")
            ly_.append(chr(y[yi]))
            lm.append("x")
            yi += 1
    return (f"score={score} x[{xs}:{xe}] y[{ys}:{ye}]\n"
            + "".join(lx) + "\n" + "".join(lm) + "\n" + "".join(ly_))
