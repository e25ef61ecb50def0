"""sw_banded_roofline: per cent of its bound (counts/sw_banded.py, on the
reference's work for one job) that sw_banded's device time per
whole-job profile reaches."""


def read(r):
    return r.roofline("sw_banded")
