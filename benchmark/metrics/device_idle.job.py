"""device_idle.job: 1 - the device's busy time (kernels, copies and sets,
their union) over whole jobs, from the benchmark's own profiles of jobs
inside its span "bench::job" (busy and window summed over them)."""


def read(r):
    s = r.job_summaries
    window = sum(x["window_us"] for x in s)
    if not s or window <= 0:
        return None
    return 1.0 - sum(x["busy_us"] for x in s) / window
