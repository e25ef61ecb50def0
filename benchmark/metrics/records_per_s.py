"""records_per_s: the input BAM's records over every job the window
completed, divided by the window's wall time (first job's start to the
last job's end), host clock."""


def read(r):
    if not r.jobs or r.window_s <= 0:
        return None
    return r.records_per_job * len(r.jobs) / r.window_s
