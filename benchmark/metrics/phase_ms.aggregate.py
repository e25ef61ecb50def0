"""phase_ms.aggregate: the program's `aggregate` and `write` phase timers
(`--metrics-json` phase_seconds) summed, mean milliseconds over the traced
run's unprofiled jobs."""


def read(r):
    return r.phase_ms("aggregate", "write")
