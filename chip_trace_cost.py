"""What the port's span recorder costs a job, the split it records, and
its byte counter against the device trace, on one benchmark cell.

    python3 chip_trace_cost.py [--workload readme-sparse] [--seed N]
        [--jobs 20] [--out build/trace_cost.json]

from the root of a checkout on a machine with one NVIDIA GPU. The dataset,
the warm-up and the jobs are the benchmark's (benchmark/harness.py), all
in one process:

  1. --jobs jobs without `--metrics-json` (the recorder off) and as many
     with it (every span recorded, the JSON written), in turns (off, on,
     on, off, ...): each side's job walls, median and quartiles, and its
     records per second over the mean wall; whether every recorded job
     counted the same;
  2. one span's cost on this host, off and on (a loop of empty spans),
     times the spans a job opens: the recorder's own time per job;
  3. the recorded jobs' spans, mean total and self milliseconds per job;
  4. one job under `--profile-dir` in each scoring mode (the cell's, then
     --sw-mode full) and two under a whole-job profiler: the trace's
     host-to-device copies inside the window (their sizes and total)
     against the job's score.h2d_bytes counter; of each whole-job
     profile, the device's idle time by the innermost program span
     (benchmark/spans.py's idle_spans).

Run from a checkout whose program has no recorder, it does step 1 only.
The last line of output is the summary, which --out also holds with
every job's wall.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def side(walls, records: int) -> dict:
    return {"jobs": len(walls), "median_s": statistics.median(walls),
            "quartiles_s": statistics.quantiles(walls, n=4),
            "records_per_s": records / statistics.fmean(walls)}


def span_cost(n: int = 200_000) -> dict:
    """Microseconds per empty span with the recorder off and on."""
    from vartrix_tpu_torch.utils import trace

    out = {}
    for record in (False, True):
        trace.reset(record=record)
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("vartrix::cost"):
                pass
        out["on" if record else "off"] = (time.perf_counter() - t0) / n * 1e6
    trace.reset(record=False)
    return out


def split(jobs) -> dict:
    """Mean n, total and self milliseconds per job of each span."""
    names = {k for s in jobs for k in s}
    return {k: {f: statistics.fmean(s.get(k, {}).get(f, 0) for s in jobs)
                * (1 if f == "n" else 1e3)
                for f in ("n", "s", "self_s")} for k in sorted(names)}


def recorded():
    """The program's record of its last job ({"spans", "counters"}), or
    None where the program has no recorder."""
    from vartrix_tpu_torch.utils import trace

    runs = getattr(trace, "runs", None)
    return runs()[-1] if runs is not None and runs() else None


def h2d_check(runner, kind: str, span: str, extra=()) -> dict:
    """A profiled job's trace HtoD bytes in `span` against its counter,
    and a whole-job profile's idle time by program span."""
    from benchmark import spans, trace as btrace

    base = runner.base
    runner.base = base + list(extra)
    try:
        job = runner.run(kind, metrics=True)
    finally:
        runner.base = base
    if job.error:
        raise RuntimeError(job.error)
    s = btrace.device_summary(job.trace, span)
    htod = s["copies"].get("HtoD", {"n": 0, "bytes": 0})
    w0, w1 = btrace.span_window(job.trace, span)
    sizes = [n for cat, name, _, _, n in btrace.device_intervals(
        job.trace, w0, w1) if cat == "gpu_memcpy" and "HtoD" in name]
    out = {"kind": kind, "flags": list(extra), "span": span,
           "trace_htod_bytes": htod["bytes"], "trace_htod_copies": htod["n"],
           "trace_htod_sizes": sizes,
           "score.h2d_bytes": recorded()["counters"]["score.h2d_bytes"]}
    if kind == "job_profile":
        idle = spans.idle_spans(job.trace, span)
        out["idle_s"] = sum(idle.values())
        out["idle_spans_s"] = sorted(idle.items(), key=lambda kv: -kv[1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="readme-sparse")
    ap.add_argument("--seed", type=int, default=4200000001)
    ap.add_argument("--jobs", type=int, default=20)
    ap.add_argument("--out", default="build/trace_cost.json")
    args = ap.parse_args()

    import torch

    from benchmark import harness, trace as btrace

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    work = tempfile.mkdtemp(prefix="trace-cost-")
    try:
        paths, records = harness.dataset(
            cell, args.seed, int(cell.config.get("threads", 1)),
            os.path.join(work, "inputs"))
        runner = harness.Runner(cell, paths, "cuda", work)
        for _ in range(harness.WARMUP_JOBS):
            runner.run("plain", metrics=True)
        walls = {False: [], True: []}
        jobs, counts = [], []
        for k in range(2 * args.jobs):
            metrics = k % 4 in (1, 2)
            job = runner.run("plain", metrics=metrics)
            if job.error:
                raise RuntimeError(job.error)
            walls[metrics].append(job.wall_s)
            rec = recorded() if metrics else None
            if rec is not None:
                jobs.append(rec["spans"])
                counts.append(rec["counters"])
        checks = [] if not jobs else [
            h2d_check(runner, "score_profile", "vartrix::score"),
            h2d_check(runner, "score_profile", "vartrix::score",
                      ("--sw-mode", "full")),
            h2d_check(runner, "job_profile", btrace.JOB_SPAN),
            h2d_check(runner, "job_profile", btrace.JOB_SPAN)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    off, on = side(walls[False], records), side(walls[True], records)
    summary = {"device": torch.cuda.get_device_name(0),
               "workload": args.workload, "seed": args.seed,
               "off": off, "on": on,
               "on_vs_off": on["records_per_s"] / off["records_per_s"] - 1,
               "median_on_vs_off": off["median_s"] / on["median_s"] - 1}
    if jobs:
        per_job = statistics.fmean(sum(e["n"] for e in s.values())
                                   for s in jobs)
        cost = span_cost()
        summary.update({
            "span_us": cost, "spans_per_job": per_job,
            "recorder_ms_per_job": per_job * cost["on"] * 1e-3,
            "counters_identical": all(c == counts[0] for c in counts),
            "counters": counts[0], "h2d": checks, "split_ms": split(jobs)})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"walls": {"off": walls[False], "on": walls[True]},
                   "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
