"""sw_pair_roofline: per cent of its bound (counts/sw_pair.py, on the
reference's work for one job) that sw_pair's device time per whole-job
profile reaches."""


def read(r):
    return r.roofline("sw_pair")
