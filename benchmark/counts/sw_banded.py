"""The least time sw_banded (banded Smith-Waterman) could take on one job.

Counted from the inputs, whatever implements the scores: the in-band
cells of the reference's own band (rust-bio's, reference/band.py) over
every pair the reference scores (reference/vartrix.score_pairs, "cells"),
each charged peaks.INSTR_PER_CELL instructions. Bytes: each read base
once at 4 bits, each haplotype base once, and one call code a read
written (the band is the aligner's own state, not an input).
"""

from .. import peaks

KERNEL = "sw_banded"  # the device trace's kernel names hold this


def bound_seconds(work: dict):
    """Seconds, or None when the job scores no pair in banded mode."""
    w = work.get("banded")
    if not w or not w["cells"]:
        return None
    nbytes = w["read_bases"] / 2 + w["hap_bases"] + w["pairs"] / 2
    return peaks.bound_seconds(w["cells"] * peaks.INSTR_PER_CELL, nbytes)
