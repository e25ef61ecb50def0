"""phase_ms.haplotypes: the program's `haplotypes` phase timer (`--metrics-json`
phase_seconds), mean milliseconds over the traced run's unprofiled jobs."""


def read(r):
    return r.phase_ms("haplotypes")
