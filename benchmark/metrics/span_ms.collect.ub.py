"""span_ms.collect.ub: the program's span "vartrix::collect.ub" (`--umi`'s
UB tags mapped to ids in the filter and join), mean total milliseconds
over the traced run's unprofiled jobs (the program's recorder,
benchmark/spans.py); None where no such job opened the span (a program
without it)."""

from benchmark import spans

SPAN = "vartrix::collect.ub"


def read(r):
    runs = spans.program_runs(r)
    if not runs or not any(SPAN in x["spans"] for x in runs):
        return None
    return spans.span_ms(r, SPAN)
