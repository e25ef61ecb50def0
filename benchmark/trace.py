"""Reads a torch.profiler chrome trace: the device's busy time inside a
span, its idle share, the device operations by time, and the idle gaps by
what the host was doing.

`device_summary` is a copy of the port's `utils/trace.device_summary`
(its arithmetic unchanged): busy time is the union of the device's
kernel, memcpy and memset intervals clipped to the span, so work on
several streams counts once, and the idle share is 1 - busy / span. The
span is a `record_function` annotation: the program's own
"vartrix::<phase>" around a `--profile-dir` phase, or the benchmark's
"bench::job" around a whole job.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
JOB_SPAN = "bench::job"


def program_span(phase: str) -> str:
    """The program's name for the span around a profiled phase."""
    return f"vartrix::{phase}"


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        payload = json.load(f)
    return payload["traceEvents"] if isinstance(payload, dict) else payload


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by a set of [begin, end) intervals."""
    return sum(e - b for b, e in merged(intervals))


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                   float]]:
    """The union of [begin, end) intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for b, e in sorted(intervals):
        if out and b <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((b, e))
    return out


def _copy_direction(name: str) -> str:
    for d in ("HtoD", "DtoH", "DtoD", "HtoH", "PtoP"):
        if d in name:
            return d
    return "other"


def span_window(events: List[dict], span: str) -> Tuple[float, float]:
    """(begin, end) in microseconds of the named span; ValueError when the
    trace holds none."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    if not spans:
        raise ValueError(f"no {span!r} span in the trace")
    return (min(float(e["ts"]) for e in spans),
            max(float(e["ts"]) + float(e["dur"]) for e in spans))


def device_intervals(events: List[dict], w0: float, w1: float):
    """(category, name, begin, end, bytes) of each device operation
    clipped to [w0, w1)."""
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        b = max(float(e["ts"]), w0)
        end = min(float(e["ts"]) + float(e["dur"]), w1)
        if end > b:
            yield (cat, e.get("name", ""), b, end,
                   int(e.get("args", {}).get("bytes", 0)))


def device_summary(events: List[dict], span: str) -> Dict:
    """Device time inside the span: {"window_us", "busy_us",
    "idle_share", "lead_us", "tail_us", "kernels": {name: {"n", "us"}},
    "copies": {direction: {"n", "us", "bytes"}}, "memset_us"}."""
    w0, w1 = span_window(events, span)
    busy: List[Tuple[float, float]] = []
    kernels: Dict[str, Dict] = defaultdict(lambda: {"n": 0, "us": 0.0})
    copies: Dict[str, Dict] = defaultdict(
        lambda: {"n": 0, "us": 0.0, "bytes": 0})
    memset_us = 0.0
    for cat, name, b, end, nbytes in device_intervals(events, w0, w1):
        busy.append((b, end))
        dur = end - b
        if cat == "kernel":
            k = kernels[name]
            k["n"] += 1
            k["us"] += dur
        elif cat == "gpu_memcpy":
            c = copies[_copy_direction(name)]
            c["n"] += 1
            c["us"] += dur
            c["bytes"] += nbytes
        else:
            memset_us += dur
    window = w1 - w0
    busy_us = union_length(busy)
    return {"window_us": window, "busy_us": busy_us,
            "idle_share": 1.0 - busy_us / window if window > 0 else 0.0,
            "lead_us": min((b for b, _ in busy), default=w1) - w0,
            "tail_us": w1 - max((e for _, e in busy), default=w0),
            "kernels": dict(kernels), "copies": dict(copies),
            "memset_us": memset_us}


def device_ops(events: List[dict], span: str) -> Dict[str, float]:
    """Seconds of each device operation by name inside the span (copies
    by direction)."""
    w0, w1 = span_window(events, span)
    out: Dict[str, float] = defaultdict(float)
    for cat, name, b, end, _ in device_intervals(events, w0, w1):
        key = (f"memcpy {_copy_direction(name)}" if cat == "gpu_memcpy"
               else "memset" if cat == "gpu_memset" else name)
        out[key] += (end - b) * 1e-6
    return dict(out)


def phase_windows(w0: float, w1: float,
                  phase_seconds: Optional[Dict[str, float]]
                  ) -> List[Tuple[str, float, float]]:
    """The program's phases laid back from the span's end, in the order
    the program ran them (the timers of `--metrics-json`, which give
    durations, not times): each phase's (name, begin, end) in
    microseconds. Time before the first phase is "start-up" (arguments,
    barcodes, VCF). The placing is approximate by the untimed code
    between phases."""
    out = []
    t = w1
    for name, sec in reversed(list((phase_seconds or {}).items())):
        out.append((name, t - sec * 1e6, t))
        t -= sec * 1e6
    out.append(("start-up", w0, max(w0, t)))
    return list(reversed(out))


def idle_gaps(events: List[dict], span: str,
              phase_seconds: Optional[Dict[str, float]]) -> Dict[str, float]:
    """Seconds the device was idle inside the span, by what the host was
    doing: each idle gap cut at the phases' edges (phase_windows), each
    piece named by its phase and, where one covers the piece's middle, the
    innermost host-side operation (a PyTorch op or CUDA call)."""
    w0, w1 = span_window(events, span)
    busy = merged((b, e) for _, _, b, e, _ in device_intervals(events, w0,
                                                               w1))
    gaps, t = [], w0
    for b, e in busy:
        if b > t:
            gaps.append((t, b))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "")) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    phases = phase_windows(w0, w1, phase_seconds)
    out: Dict[str, float] = defaultdict(float)
    for b, e in gaps:
        for name, pb, pe in phases:
            lo, hi = max(b, pb), min(e, pe)
            if hi <= lo:
                continue
            mid = (lo + hi) / 2
            inner = min(((he - hb, op) for hb, he, op in host
                         if hb <= mid < he), default=None)
            key = name if inner is None else f"{name}: {inner[1]}"
            out[key] += (hi - lo) * 1e-6
    return dict(out)
