"""Reads the chrome trace that `--profile-dir` writes (torch.profiler):
the device's busy time inside a profiled phase and its idle share.

The driver wraps each profiled phase in a `record_function` span named
"vartrix::<phase>"; that span is the window. Busy time is the union of the
device's kernel, memcpy and memset intervals clipped to the window, so
overlapping work on several streams counts once. The idle share is
1 - busy / window.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span_name(phase: str) -> str:
    """The name of the `record_function` span around a profiled phase."""
    return f"vartrix::{phase}"


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        payload = json.load(f)
    return payload["traceEvents"] if isinstance(payload, dict) else payload


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by a set of [begin, end) intervals."""
    total = 0.0
    cur_b = cur_e = None
    for b, e in sorted(intervals):
        if cur_e is None or b > cur_e:
            if cur_e is not None:
                total += cur_e - cur_b
            cur_b, cur_e = b, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_b
    return total


def _copy_direction(name: str) -> str:
    for d in ("HtoD", "DtoH", "DtoD", "HtoH", "PtoP"):
        if d in name:
            return d
    return "other"


def device_summary(events: List[dict], phase: str) -> Dict:
    """Device time inside the phase's span: {"window_us", "busy_us",
    "idle_share", "lead_us", "tail_us", "kernels": {name: {"n", "us"}},
    "copies": {direction: {"n", "us", "bytes"}}, "memset_us"}; lead_us and
    tail_us, the window's time before the device's first interval in it
    and after its last (the whole window when it holds none). Raises
    ValueError when the trace holds no span for the phase."""
    want = span_name(phase)
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == want]
    if not spans:
        raise ValueError(f"no {want!r} span in the trace")
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    busy: List[Tuple[float, float]] = []
    kernels: Dict[str, Dict] = defaultdict(lambda: {"n": 0, "us": 0.0})
    copies: Dict[str, Dict] = defaultdict(
        lambda: {"n": 0, "us": 0.0, "bytes": 0})
    memset_us = 0.0
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        b = max(float(e["ts"]), w0)
        end = min(float(e["ts"]) + float(e["dur"]), w1)
        if end <= b:
            continue
        busy.append((b, end))
        dur = end - b
        if cat == "kernel":
            k = kernels[e["name"]]
            k["n"] += 1
            k["us"] += dur
        elif cat == "gpu_memcpy":
            c = copies[_copy_direction(e["name"])]
            c["n"] += 1
            c["us"] += dur
            c["bytes"] += int(e.get("args", {}).get("bytes", 0))
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


def kernel_count(summary: Dict, fragment: str) -> int:
    """Launches in the summary of the kernels whose name holds `fragment`."""
    return sum(k["n"] for name, k in summary["kernels"].items()
               if fragment in name)
