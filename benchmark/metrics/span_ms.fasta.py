"""span_ms.fasta: the program's span "vartrix::haplotypes.fasta" (reads
from the FASTA file: each chromosome's read and line-end strip, and its
upper-case, the child span "vartrix::haplotypes.upper"), mean total
milliseconds over the traced run's unprofiled jobs (the program's
recorder, benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.span_ms(r, "vartrix::haplotypes.fasta")
