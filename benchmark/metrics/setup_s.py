"""setup_s: seconds from the process's start to the end of the warm-up
jobs, less the seconds the cell's dataset took (made on a seed's first
run, found on later ones; the benchmark's own work): imports, the CUDA
context, kernel builds on a checkout's first run, the warm-up jobs."""


def read(r):
    return r.setup_s
