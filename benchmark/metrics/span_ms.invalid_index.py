"""span_ms.invalid_index: the program's span
"vartrix::haplotypes.invalid_index" (each chromosome's scan for bytes
outside --valid-chars, once per chromosome), mean total milliseconds over
the traced run's unprofiled jobs (the program's recorder,
benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.span_ms(r, "vartrix::haplotypes.invalid_index")
