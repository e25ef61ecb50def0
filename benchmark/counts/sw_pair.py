"""The least time sw_pair (full Smith-Waterman) could take on one job.

Counted from the inputs, whatever implements the scores: for every pair
the reference scores, the read's true length x the haplotype's true
length, for the ref and the alt haplotype (reference/vartrix.score_pairs,
"cells"), each cell charged peaks.INSTR_PER_CELL instructions. Bytes:
each read base once at 4 bits (BAM's own code), each haplotype base once,
and one call code a read written.
"""

from .. import peaks

KERNEL = "sw_pair"  # the device trace's kernel names hold this


def bound_seconds(work: dict):
    """Seconds, or None when the job scores no pair in full mode."""
    w = work.get("full")
    if not w or not w["cells"]:
        return None
    nbytes = w["read_bases"] / 2 + w["hap_bases"] + w["pairs"] / 2
    return peaks.bound_seconds(w["cells"] * peaks.INSTR_PER_CELL, nbytes)
