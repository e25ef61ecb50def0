"""phase_ms.score: the program's `score` phase timer (`--metrics-json`
phase_seconds), mean milliseconds over the traced run's unprofiled jobs."""


def read(r):
    return r.phase_ms("score")
