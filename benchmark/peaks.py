"""The card's peaks that the kernels' bounds charge, with their sources.

NVIDIA H100 80GB HBM3 (SXM), at its 700 W power limit:

  * INSTR_PER_S: instructions the card can issue each second, 132 SMs x
    128 lanes per clock x 1.98 GHz (the SM's maximum clock) = 33.45 T;
  * BYTES_PER_S: HBM3 bandwidth, 3.35 TB/s (NVIDIA's data sheet);
  * INSTR_PER_CELL: SASS instructions per needed Smith-Waterman cell, 3.75,
    the count of the cell probe `CELL_PROBE_SRC` in `chip_smoke.py` (a
    probe that includes neither kernel, PERF.md section 6), frozen here.
"""

INSTR_PER_S = 132 * 128 * 1.98e9
BYTES_PER_S = 3.35e12
INSTR_PER_CELL = 3.75


def bound_seconds(instructions: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the
    instructions at the issue rate and the bytes at HBM bandwidth."""
    return max(instructions / INSTR_PER_S, nbytes / BYTES_PER_S)
