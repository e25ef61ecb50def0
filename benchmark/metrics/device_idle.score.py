"""device_idle.score: 1 - the device's busy time over the program's
"vartrix::score" span, from the traces of the jobs run with
`--profile-dir` (busy and window summed over them)."""


def read(r):
    s = r.score_summaries
    window = sum(x["window_us"] for x in s)
    if not s or window <= 0:
        return None
    return 1.0 - sum(x["busy_us"] for x in s) / window
