"""phase_ms.decode: the program's `decode` phase timer (`--metrics-json`
phase_seconds), mean milliseconds over the traced run's unprofiled jobs.
In whole-file mode the decode starts on a thread before `haplotypes`, and
this timer holds only the wait left after it; with a region plan it is the
whole decode."""


def read(r):
    return r.phase_ms("decode")
