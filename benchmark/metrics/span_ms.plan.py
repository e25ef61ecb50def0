"""span_ms.plan: the program's span "vartrix::plan" (the fetch plan: the
BAM index read and its chunks merged over the variant windows), mean
total milliseconds over the traced run's unprofiled jobs (the program's
recorder, benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.span_ms(r, "vartrix::plan")
