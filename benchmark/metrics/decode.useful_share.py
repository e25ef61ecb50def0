"""decode.useful_share: the reads handed to scoring (the program's counter
collect.reads_scored) over the records decoded (decode.records), mean
counts per unprofiled traced job (the program's recorder,
benchmark/spans.py)."""

from benchmark import spans


def read(r):
    scored = spans.counter(r, "collect.reads_scored")
    decoded = spans.counter(r, "decode.records")
    if scored is None or not decoded:
        return None
    return scored / decoded
