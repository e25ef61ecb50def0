"""Tells whether a benchmark cell's slow stretches of jobs are the
program's own: each job of a window beside what the process did
meanwhile.

    python3 tools/host_drift.py --workload souporcell-dense --seed N \
        [--seconds 51] [--device cuda] [--out drift.jsonl]

Runs the cell's warm-up and window as benchmark/harness.py does (jobs back
to back in this process, each with --metrics-json) and writes one JSON
line per window job: its wall seconds; this process's CPU seconds
(getrusage, every thread), user and system apart, and its minor page
faults; its resident MiB after the job; Python's garbage collection
(seconds, full collections); the job's phases and its "plan" span. The
last line is a summary: each quantity's Pearson correlation with the
wall over the window's jobs, and its mean over the fastest and the
slowest third. A slowdown that every phase shares, with the CPU seconds
rising as the wall does, is the cores' and not a phase's."""

import argparse
import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402
from vartrix_tpu_torch.utils import trace  # noqa: E402


class GcClock:
    """Seconds and full collections of Python's garbage collector."""

    def __init__(self):
        self.s = 0.0
        self.full = 0
        self._t = None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.s += time.perf_counter() - self._t
            self.full += info.get("generation") == 2


def _rss_mib() -> float:
    """This process's resident MiB (0 where /proc is not there)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**20
    except OSError:
        return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    workdir = tempfile.mkdtemp(prefix="vartrix-drift-")
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        paths, _ = harness.dataset(cell, args.seed,
                                   int(cell.config.get("threads", 1)),
                                   os.path.join(workdir, "inputs"))
        runner = harness.Runner(cell, paths, args.device, workdir)
        for _ in range(harness.WARMUP_JOBS):
            runner.run(metrics=True)
        clock = GcClock()
        rows = []
        t_end = time.perf_counter() + args.seconds
        while time.perf_counter() < t_end:
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            gc0 = (clock.s, clock.full)
            job = runner.run(metrics=True)
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            user = ru1.ru_utime - ru0.ru_utime
            sys_s = ru1.ru_stime - ru0.ru_stime
            plan = trace.runs()[-1]["spans"].get("vartrix::plan", {})
            row = {"wall_s": job.wall_s, "cpu_s": user + sys_s,
                   "user_s": user, "sys_s": sys_s,
                   "minflt": ru1.ru_minflt - ru0.ru_minflt,
                   "rss_mib": _rss_mib(),
                   "gc_s": clock.s - gc0[0], "gc_full": clock.full - gc0[1],
                   "plan_s": plan.get("s", 0.0),
                   **{f"{k}_s": v for k, v in (job.phases or {}).items()},
                   "error": job.error}
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
        wall = np.array([r["wall_s"] for r in rows])
        order = np.argsort(wall)
        third = max(1, len(rows) // 3)
        summary = {"workload": args.workload, "seed": args.seed,
                   "jobs": len(rows), "cores": os.cpu_count()}
        for k in rows[0]:
            if k == "error":
                continue
            x = np.array([r.get(k, 0.0) for r in rows], float)
            corr = (float(np.corrcoef(x, wall)[0, 1])
                    if len(rows) > 2 and x.std() > 0 else None)
            summary[k] = {"corr": corr,
                          "fast": float(x[order[:third]].mean()),
                          "slow": float(x[order[-third:]].mean())}
        print(json.dumps({"summary": summary}), file=out, flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
