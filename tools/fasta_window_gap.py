"""Measures the costs that set WINDOW_GAP in
vartrix_tpu_torch/core/pipeline.py: what one more span costs
IndexedFasta.fetch_spans_upper (seek, read, line strip, join), against what
one more base costs it and the scan for invalid bytes that follows it, on a
FASTA of 60-base lines already in the page cache.

    python3 tools/fasta_window_gap.py [--mb 16] [--reps 7]

Prints one JSON line: the host's CPU, microseconds per span, nanoseconds
per base, the microseconds of a 201-base window read alone, and their
ratio `gap_bases`: the run of bases between two windows whose read costs
what one more span does.
"""

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vartrix_tpu_torch.io.fasta import IndexedFasta  # noqa: E402
from vartrix_tpu_torch.utils import trace  # noqa: E402

LINE = 60


def write_fasta(path: str, n: int) -> int:
    """One chromosome "c" of n random bases, soft-masked at random, in
    60-base lines; returns its length."""
    rng = np.random.default_rng(0)
    rows = n // LINE
    body = np.empty((rows, LINE + 1), np.uint8)
    body[:, :LINE] = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8),
                                (rows, LINE))
    body[:, LINE] = ord("\n")
    with open(path, "wb") as f, open(path + ".fai", "w") as fai:
        f.write(b">c\n")
        fai.write(f"c\t{rows * LINE}\t3\t{LINE}\t{LINE + 1}\n")
        f.write(body.tobytes())
    return rows * LINE


def seconds(fa: IndexedFasta, spans, lut, reps: int) -> float:
    """Median seconds of the windows path's FASTA work on `spans`."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        seq = fa.fetch_spans_upper("c", spans)
        np.nonzero(~lut[np.frombuffer(seq, np.uint8)])[0].tolist()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def cpu_name() -> str:
    """The host's architecture and CPU model, where /proc/cpuinfo has it."""
    model = "model unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()}, {model}, {os.cpu_count()} cores"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    trace.reset(False)
    lut = np.zeros(256, bool)
    lut[list(b"ATGCatgc")] = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.fa")
        n = write_fasta(path, args.mb << 20)
        fa = IndexedFasta(path)
        # as a VCF's windows: sorted, scattered over the chromosome
        starts = np.sort(np.random.default_rng(1).choice(
            n - 201, n // 2000, replace=False)).tolist()
        whole = seconds(fa, [(0, n)], lut, args.reps)
        ones = seconds(fa, [(a, a + 1) for a in starts], lut, args.reps)
        windows = seconds(fa, [(a, a + 201) for a in starts], lut,
                          args.reps)
        fa.close()
    per_base = whole / n
    per_span = ones / len(starts) - per_base
    print(json.dumps({
        "cpu": cpu_name(), "bases": n, "spans": len(starts),
        "per_span_us": per_span * 1e6, "per_base_ns": per_base * 1e9,
        "window_201_us": windows / len(starts) * 1e6,
        "gap_bases": per_span / per_base}))


if __name__ == "__main__":
    main()
