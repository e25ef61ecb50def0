"""phase_ms.collect: the program's `collect` phase timer (`--metrics-json`
phase_seconds), mean milliseconds over the traced run's unprofiled jobs."""


def read(r):
    return r.phase_ms("collect")
