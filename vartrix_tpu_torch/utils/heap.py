"""The host heap's policy: memory a job frees stays in the process for the
next allocation.

By default glibc serves a block of 32 MiB or more with an mmap of its own
and unmaps it when it is freed, and gives the heap's top back to the
kernel past its trim threshold. A job's large columns (the decode's
inflated chunks and record columns, the per-read arrays of collect, score
and aggregate) are then faulted in page by page every time they are
allocated, within a job and again in the next job of the same process:
some 70,000 minor faults, a third of the host time, for a job of 500,000
91-base records. `keep_freed()` serves every block from the heap and
never trims it, so freed pages are reused; the process holds its peak
heap until it exits. A no-op where the C library has no `mallopt`.
"""

from __future__ import annotations

import ctypes
import ctypes.util

# glibc's malloc.h
M_TRIM_THRESHOLD = -1
M_MMAP_MAX = -4

_done = False


def keep_freed() -> bool:
    """Sets the policy once per process; True where the C library took
    it."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or None)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    # the trim threshold is an int; its largest value never trims
    _done = bool(mallopt(M_MMAP_MAX, 0)
                 and mallopt(M_TRIM_THRESHOLD, 2**31 - 1))
    return _done
