"""span_ms.aggregate.umi: the program's span "vartrix::aggregate.umi" (the
UMI vote of `--umi`: the (variant, cell, UMI) keys packed, np.unique over
them and the 0.75 vote), mean total milliseconds over the traced run's
unprofiled jobs (the program's recorder, benchmark/spans.py); None where
no such job opened the span (a program without it)."""

from benchmark import spans

SPAN = "vartrix::aggregate.umi"


def read(r):
    runs = spans.program_runs(r)
    if not runs or not any(SPAN in x["spans"] for x in runs):
        return None
    return spans.span_ms(r, SPAN)
