"""The benchmark of vartrix_tpu_torch: one cell of BENCHMARK.json run for a
fixed time, its metrics read, and its outputs judged by the plain
reference.

A run, in its own process:

  1. the cell's dataset from `--seed`, written under TMPDIR and not held
     in memory past this step. It is the benchmark's own work, outside
     `setup_s`;
  2. set-up: WARMUP_JOBS warm-up jobs, so the kernel libraries load and
     the CUDA context, the allocators and the host's caches reach the
     state the window keeps (the first under the profiler in a traced
     run, whose first start is slow);
  3. the window: jobs back to back, a closed loop, until `--seconds` is
     spent. A job is one sample through every layer of the program:
     `vartrix_tpu_torch.driver._main(argv)` in this process, from the
     inputs on disk to the `.mtx` files, each job into a fresh directory
     under TMPDIR. After each job its outputs are fingerprinted (CRC-32
     and size) and deleted, but for the first job of each fingerprint;
  4. after the window: the program's state is freed, the dataset's
     columns made again from the seed, and the plain reference
     (reference/) works out the matrices; every fingerprint's kept
     outputs are compared with them, entry by entry.

A traced run (`--trace 1`) passes `--metrics-json` to its jobs, and
profiles some of them: alternately a whole job under the benchmark's own
torch.profiler and span "bench::job", and a job with the program's
`--profile-dir` (its span "vartrix::score").

Everything that belongs to one configuration, cell or metric lives in a
file of its own, found by the name BENCHMARK.json gives it:
configs/<config>.json, workloads/<cell>.json, metrics/<metric>.py (a
`read(readings)` that returns a number or None), counts/<kernel>.py and
inputs/<kind>.py.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import trace
from .inputs import synth
from .reference import mtx
from .reference import vartrix as reference

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vartrix_tpu")
# a traced run profiles at most this many jobs of each kind
PROFILED_JOBS = 3
# jobs run before the window (the first loads the libraries and builds the
# kernels)
WARMUP_JOBS = 2


@dataclass
class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def semantics(self) -> reference.Semantics:
        return reference.Semantics(**self.config["semantics"])

    @property
    def generator(self) -> dict:
        """The generator's parameters: the traffic's, with the record
        shapes the configuration fixes (its "shapes", e.g. read_len)."""
        shapes = self.config.get("shapes", {})
        traffic = self.workload["generator"]
        clash = sorted(k for k in set(shapes) & set(traffic)
                       if shapes[k] != traffic[k])
        if clash:
            raise ValueError(f"workloads/{self.name}.json sets {clash}, "
                             f"which its configuration fixes")
        return {**traffic, **shapes}

    def reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "workloads", f"{name}.json")) as f:
        workload = json.load(f)
    if workload["traffic"] != w["traffic"]:
        raise ValueError(f"workloads/{name}.json is traffic "
                         f"{workload['traffic']!r}, BENCHMARK.json says "
                         f"{w['traffic']!r}")
    return Cell(name, w["chips"], config, workload, spec["end_to_end"],
                spec["per_layer"])


def _load_file(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """metrics/<name>.py's read()."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    return _load_file(path, "bench_metric_" + name.replace(".", "_")).read


# ---------------------------------------------------------------- inputs


def dataset(cell: Cell, seed: int, threads: int, out: str) -> tuple:
    """(paths of the cell's input files for seed, written under out, and
    the records of its BAM). Every run writes its own, so that every run
    of a seed does the same work, in the same order, whichever ran
    before it. The columns the files were written from are dropped."""
    kind = importlib.import_module(f".inputs.{cell.workload['input']}",
                                   __package__)
    ds = synth.generate(cell.generator, seed)
    paths = kind.write(ds, out, threads)
    least = cell.workload.get("min_bam_bytes", 0)
    size = os.path.getsize(paths["bam"])
    if size < least:
        raise RuntimeError(f"{cell.name}: the BAM holds {size} bytes, under "
                           f"the {least} the cell needs")
    return paths, ds.n


# ---------------------------------------------------------------- jobs


@dataclass
class Job:
    kind: str           # "plain", "job_profile" or "score_profile"
    wall_s: float
    error: Optional[str]
    fingerprint: Optional[tuple] = None
    phases: Optional[Dict[str, float]] = None
    trace: Optional[list] = None  # a profiled job's events, until read


@dataclass
class Readings:
    """What a run measured; the metric readers' input."""

    setup_s: float
    records_per_job: int
    window_s: float = 0.0
    jobs: List[Job] = field(default_factory=list)
    score_summaries: List[dict] = field(default_factory=list)
    job_summaries: List[dict] = field(default_factory=list)
    job_ops: List[Dict[str, float]] = field(default_factory=list)
    job_gaps: List[Dict[str, float]] = field(default_factory=list)
    work: dict = field(default_factory=dict)

    def plain_phases(self) -> List[Dict[str, float]]:
        return [j.phases for j in self.jobs
                if j.kind == "plain" and j.phases is not None]

    def phase_ms(self, *names: str) -> Optional[float]:
        """Mean milliseconds of the named phases (summed) over the
        unprofiled traced jobs; None without such jobs."""
        runs = self.plain_phases()
        if not runs:
            return None
        return 1e3 * float(np.mean([sum(p.get(n, 0.0) for n in names)
                                    for p in runs]))

    def kernel_seconds(self, fragment: str) -> Optional[float]:
        """Mean device seconds per whole-job profile of the kernels whose
        name holds fragment; None without a profile or such a kernel."""
        if not self.job_summaries:
            return None
        tot = sum(k["us"] for s in self.job_summaries
                  for n, k in s["kernels"].items() if fragment in n)
        return tot * 1e-6 / len(self.job_summaries) if tot else None

    def bound_seconds(self, kernel: str) -> Optional[float]:
        """counts/<kernel>.py's bound on the reference's work."""
        mod = importlib.import_module(f".counts.{kernel}", __package__)
        return mod.bound_seconds(self.work) if self.work else None

    def roofline(self, kernel: str) -> Optional[float]:
        """Per cent of the kernel's bound that its device time reaches."""
        mod = importlib.import_module(f".counts.{kernel}", __package__)
        dev = self.kernel_seconds(mod.KERNEL)
        bound = self.bound_seconds(kernel)
        if not dev or bound is None:
            return None
        return 100.0 * bound / dev


def _fingerprint(outdir: str, names: List[str]) -> tuple:
    out = []
    for n in names:
        with open(os.path.join(outdir, n), "rb") as f:
            data = f.read()
        out.append((n, len(data), zlib.crc32(data)))
    return tuple(out)


class Runner:
    """Runs the cell's jobs in this process and keeps their outputs'
    fingerprints."""

    def __init__(self, cell: Cell, paths: dict, device: str, workdir: str):
        from vartrix_tpu_torch import driver  # the system under test

        self._main = driver._main
        self.cell = cell
        self.workdir = workdir
        sem = cell.semantics
        self.outputs = ["matrix.mtx"] + (
            ["ref_matrix.mtx"] if sem.scoring_method == "coverage" else [])
        self.base = (["-v", paths["vcf"], "-b", paths["bam"],
                      "-f", paths["fasta"], "-c", paths["barcodes"]]
                     + sem.argv()
                     + ["--threads", str(cell.config.get("threads", 1))]
                     + list(cell.workload.get("flags", []))
                     + ([] if device == "cuda" else
                        ["--device", device, "--backend", "torch"]))
        self.kept: Dict[tuple, str] = {}  # fingerprint -> kept output dir
        self.count = 0
        self.cuda = device == "cuda"

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def run(self, kind: str = "plain", metrics: bool = False) -> Job:
        self.count += 1
        out = os.path.join(self.workdir, f"job{self.count}")
        os.makedirs(out)
        argv = self.base + ["-o", os.path.join(out, "matrix.mtx"),
                            "--ref-matrix",
                            os.path.join(out, "ref_matrix.mtx")]
        mj = os.path.join(out, "metrics.json")
        if metrics:
            argv += ["--metrics-json", mj]
        if kind == "score_profile":
            argv += ["--profile-dir", os.path.join(out, "profile")]
        prof = None
        t0 = time.perf_counter()
        try:
            if kind == "job_profile":
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.cuda else [])
                with profile(activities=acts) as prof:
                    with record_function(trace.JOB_SPAN):
                        self._main(argv)
                        self._sync()
            else:
                self._main(argv)
                self._sync()
            err = None
        except SystemExit as exc:
            err = f"the program exited with {exc.code!r}"
        except Exception as exc:  # noqa: BLE001 - a failed job is counted
            err = f"{type(exc).__name__}: {exc}"
        wall = time.perf_counter() - t0
        job = Job(kind, wall, err)
        if err is None:
            try:
                job.fingerprint = _fingerprint(out, self.outputs)
            except OSError as exc:
                job.error = f"outputs unreadable: {exc}"
        if metrics and os.path.exists(mj):
            with open(mj) as f:
                job.phases = json.load(f)["phase_seconds"]
        if prof is not None:
            path = os.path.join(out, "job.pt.trace.json")
            prof.export_chrome_trace(path)
            job.trace = trace.load_events(path)
        if kind == "score_profile" and err is None:
            job.trace = trace.load_events(
                os.path.join(out, "profile", "score.pt.trace.json"))
        if job.fingerprint is not None and job.fingerprint not in self.kept:
            self.kept[job.fingerprint] = out
        else:
            shutil.rmtree(out, ignore_errors=True)
        return job


def _trace_kinds():
    """The kinds of a traced run's window jobs, in order."""
    n = 0
    while True:
        if n < 4 * PROFILED_JOBS and n % 4 == 0:
            yield "job_profile"
        elif n < 4 * PROFILED_JOBS and n % 4 == 2:
            yield "score_profile"
        else:
            yield "plain"
        n += 1


def _read_profile(job: Job, r: Readings) -> None:
    events, job.trace = job.trace, None
    if events is None:
        return
    if job.kind == "job_profile":
        r.job_summaries.append(trace.device_summary(events, trace.JOB_SPAN))
        r.job_ops.append(trace.device_ops(events, trace.JOB_SPAN))
        r.job_gaps.append(trace.idle_gaps(events, trace.JOB_SPAN,
                                          job.phases))
    else:
        r.score_summaries.append(trace.device_summary(
            events, trace.program_span("score")))


def _mean_top(dicts: List[Dict[str, float]], n: int = 10) -> list:
    tot: Dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            tot[k] = tot.get(k, 0.0) + v
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / len(dicts)] for k, v in top]


def loaded_forbidden() -> List[str]:
    """Top-level names of sys.modules that are JAX or the JAX package."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", setup_clock: Callable[[], float] = None
        ) -> dict:
    """One run of the cell; returns the result line's object (without its
    "device" entry's name, which run.py adds) and the checks. setup_clock
    gives the seconds since the process started; `setup_s` is that at the
    end of the warm-up, less the seconds the dataset took."""
    cfg = cell.config
    threads = int(cfg.get("threads", 1))
    t_start = time.perf_counter()
    clock = setup_clock or (lambda: time.perf_counter() - t_start)
    workdir = tempfile.mkdtemp(prefix="vartrix-bench-")
    try:
        t_data = time.perf_counter()
        paths, records = dataset(cell, seed, threads,
                                 os.path.join(workdir, "inputs"))
        data_s = time.perf_counter() - t_data
        return _run(cell, seed, seconds, traced, device, paths, records,
                    workdir, lambda: clock() - data_s)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, paths, records, workdir,
         setup_clock):
    import torch

    runner = Runner(cell, paths, device, workdir)
    warm = [runner.run("job_profile" if traced and k == 0 else "plain",
                       metrics=traced) for k in range(WARMUP_JOBS)]
    for job in warm:
        job.trace = None
    r = Readings(setup_s=setup_clock(), records_per_job=records)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kinds = _trace_kinds() if traced else iter(lambda: "plain", None)
    t0 = time.perf_counter()
    end = t0
    while True:
        kind = next(kinds)
        job = runner.run(kind, metrics=traced)
        end = time.perf_counter()
        _read_profile(job, r)
        r.jobs.append(job)
        done = end - t0 >= seconds
        if traced:  # a traced run has at least a job of each kind
            done = done and {"job_profile", "score_profile", "plain"} <= {
                j.kind for j in r.jobs}
        if done:
            break
    r.window_s = end - t0
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    # the program's state goes before the reference runs on the card
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ds = synth.generate(cell.generator, seed)
    sem = cell.semantics
    want, shape, work = reference.expected(ds, sem, device)
    r.work = {sem.sw_mode: work}
    mismatched = 0
    unreadable = 0
    wrong = set()
    for fp, out in runner.kept.items():
        for name in runner.outputs:
            try:
                n = mtx.compare(os.path.join(out, name), want[name[:-4]],
                                shape)
            except (OSError, mtx.MalformedMatrix):
                unreadable += 1
                wrong.add(fp)
                continue
            mismatched += n
            if n:
                wrong.add(fp)
    if not runner.kept:
        unreadable += 1
    ref_s = time.perf_counter() - t_ref

    raised = sum(j.error is not None for j in r.jobs)
    failed_jobs = sum(1 for j in r.jobs
                      if j.error is not None or j.fingerprint in wrong)
    checks = {
        "mismatched_entries": {"value": mismatched, "limit": 0},
        "unreadable_outputs": {"value": unreadable, "limit": 0},
        "jobs_raised": {"value": raised + sum(j.error is not None
                                              for j in warm),
                        "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        if not cell.reports(m):
            continue
        value = metric_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(r.jobs),
              "failed": failed_jobs, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if traced and r.job_summaries:
        result["device"]["busy_s"] = sum(
            s["busy_us"] for s in r.job_summaries) * 1e-6
        result["device"]["window_s"] = sum(
            s["window_us"] for s in r.job_summaries) * 1e-6
        result["breakdown"] = {"device_ops": _mean_top(r.job_ops),
                               "idle_gaps": _mean_top(r.job_gaps)}
    result["info"] = {"seed": seed, "jobs": len(r.jobs),
                      "window_s": r.window_s, "reference_s": ref_s,
                      "outputs_distinct": len(runner.kept),
                      "records_per_job": r.records_per_job,
                      "warmup_s": [round(j.wall_s, 4) for j in warm],
                      "walls": [round(j.wall_s, 4) for j in r.jobs],
                      "job_errors": sorted({j.error for j in r.jobs
                                            if j.error})[:3]}
    result["checks"] = checks
    return result

