"""h2d_bytes_per_read: the bytes the program hands to the scoring device
(its counter score.h2d_bytes: reads, indices, haplotypes) per read handed
to scoring (collect.reads_scored), mean counts per unprofiled traced job
(the program's recorder, benchmark/spans.py)."""

from benchmark import spans


def read(r):
    nbytes = spans.counter(r, "score.h2d_bytes")
    reads = spans.counter(r, "collect.reads_scored")
    if nbytes is None or not reads:
        return None
    return nbytes / reads
