"""decode.inflate_share_max: the most BGZF blocks any one thread inflated
in a region decode (the program's counter decode.blocks_thread_max) over
the blocks inflated (decode.blocks), mean counts per unprofiled traced job
(the program's recorder, benchmark/spans.py); 1 / threads where the
inflate spreads evenly, 1 where one thread inflates it all. None where
the program counts no blocks."""

from benchmark import spans


def read(r):
    most = spans.counter(r, "decode.blocks_thread_max")
    blocks = spans.counter(r, "decode.blocks")
    if most is None or not blocks:
        return None
    return most / blocks
