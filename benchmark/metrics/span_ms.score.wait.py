"""span_ms.score.wait: the program's span "vartrix::score.sync" (every
place the scoring host waits for the device: the band builder's read of
its match total, the final gather of the calls), mean total milliseconds
over the traced run's unprofiled jobs (the program's recorder,
benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.span_ms(r, "vartrix::score.sync")
