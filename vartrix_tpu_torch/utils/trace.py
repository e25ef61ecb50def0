"""The port's spans and counters, and the reader of the chrome trace that
`--profile-dir` writes (torch.profiler).

The recorder. `span(name)` is a context manager around one piece of a
job's work, named "vartrix::<layer>[.<step>]" and opened per job, phase,
chromosome, shape bucket or chunk, never per read or variant. What it
costs depends on the recorder's state, which `reset` sets at the start of
each job (driver._main):

  * off (no --metrics-json, info logging off, no torch.profiler active):
    one flag check; neither a clock nor the profiler is called;
  * profiling (a torch.profiler was active when the job began, or
    `profiling()` holds one, as --profile-dir does): the span opens
    `record_function(name)`, a "user_annotation" event in the chrome
    trace on the clock of the device's kernels and copies, with the id of
    the thread that opened it;
  * recording (--metrics-json, or info logging, whose phase lines it
    times): per name the spans' count, total seconds, self seconds (the
    total less what child spans on the same thread cover) and the parent
    of its first occurrence (the span open on its thread when it opened,
    or, on a worker thread, the span that `carry` handed the work over
    from). `spans()` returns them.

`count(name, n)` adds to an integer counter; counters are always on and
`counters()` returns them. `phase(name)` is the span of a driver phase,
whose recorded seconds also sum into `phase_seconds()`. `runs()` keeps the
spans and counters of this process's last RUNS_KEPT recording jobs, for a
caller that runs many jobs in one process (the benchmark's traced run).
The recorder is thread-safe.

The reader. The driver wraps each profiled phase in its span,
"vartrix::<phase>"; that span is the window. Busy time is the union of the
device's kernel, memcpy and memset intervals clipped to the window, so
overlapping work on several streams counts once. The idle share is
1 - busy / window.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span_name(phase: str) -> str:
    """The name of the span around a phase ("vartrix::<phase>")."""
    return f"vartrix::{phase}"


# ---------------------------------------------------------------- recorder

_RECORD = False   # totals per span name
_PROFILE = False  # record_function per span
_ON = False       # either
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans; .root
_spans: Dict[str, dict] = {}
_counters: Dict[str, int] = {}
_phases: Dict[str, float] = {}
RUNS_KEPT = 256
_run: dict = {"profiled": False, "spans": _spans, "counters": _counters}
_runs: deque = deque(maxlen=RUNS_KEPT)  # the recording jobs' _run


class _Off:
    """The span of a recorder that is off."""

    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _current() -> Optional[str]:
    """The innermost span open on this thread, else the one carried in."""
    stack = _stack()
    return stack[-1].name if stack else getattr(_local, "root", None)


class _Span:
    __slots__ = ("name", "seconds", "_parent", "_child", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.seconds = None  # set on exit while recording
        self._child = 0.0
        self._t0 = None
        self._rf = None

    def __enter__(self):
        self._parent = _current()
        if _PROFILE:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if _RECORD:
            self._t0 = time.perf_counter()
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        stack = _stack()
        stack.remove(self)
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.seconds = dt
            if stack:
                stack[-1]._child += dt
            with _lock:
                e = _spans.get(self.name)
                if e is None:
                    e = _spans[self.name] = {"n": 0, "s": 0.0, "self_s": 0.0,
                                             "parent": self._parent}
                e["n"] += 1
                e["s"] += dt
                e["self_s"] += max(0.0, dt - self._child)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """The context manager of one span named `name` (see the module's
    docstring); a shared no-op while the recorder is off."""
    if not _ON:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


@contextmanager
def phase(name: str):
    """span(span_name(name)) whose recorded seconds also add to
    phase_seconds()[name]; yields the span (its `.seconds` is None unless
    recording)."""
    sp = span(span_name(name))
    try:
        with sp:
            yield sp
    finally:
        if sp.seconds is not None:
            with _lock:
                _phases[name] = _phases.get(name, 0.0) + sp.seconds


def carry(fn):
    """fn, wrapped so that spans it opens on another thread (a worker's
    decode, the chunk producer's gathers) name the span open here now as
    their parent."""
    if not _ON:
        return fn
    parent = _current()

    def run(*args, **kwargs):
        saved = getattr(_local, "root", None)
        _local.root = parent
        try:
            return fn(*args, **kwargs)
        finally:
            _local.root = saved

    return run


def _set(record: bool, profile: bool) -> None:
    global _RECORD, _PROFILE, _ON
    _RECORD, _PROFILE, _ON = record, profile, record or profile


def reset(record: bool) -> None:
    """A fresh recorder for a job: spans, counters and phases cleared,
    recording on or off, and profiling on when a torch.profiler is active
    on this thread. A recording job's spans and counters join runs()."""
    global _spans, _counters, _phases, _run
    profile = _profiler_active()
    with _lock:
        _spans, _counters, _phases = {}, {}, {}
        _run = {"profiled": profile, "spans": _spans, "counters": _counters}
        if record:
            _runs.append(_run)
    _set(bool(record), profile)


def _profiler_active() -> bool:
    """Whether a torch.profiler runs: the flag its Python side sets (set
    too when it records every thread), or its thread's own state."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False) or torch._C._autograd._profiler_enabled())


@contextmanager
def profiling():
    """Spans open `record_function` while inside (a profiler started
    within the job, --profile-dir's)."""
    saved = _PROFILE
    _run["profiled"] = True
    _set(_RECORD, True)
    try:
        yield
    finally:
        _set(_RECORD, saved)


def spans() -> Dict[str, dict]:
    """{name: {"n", "s", "self_s", "parent"}} of the spans recorded since
    the last reset, in the order they first closed."""
    with _lock:
        return {k: dict(v) for k, v in _spans.items()}


def counters() -> Dict[str, int]:
    """{name: count} since the last reset."""
    with _lock:
        return dict(_counters)


def runs() -> List[dict]:
    """[{"profiled", "spans", "counters"}] of this process's last RUNS_KEPT
    recording jobs, oldest first, the current one included; "profiled" if
    a torch.profiler ran during any of the job (the spans then hold its
    cost)."""
    with _lock:
        return [{"profiled": r["profiled"],
                 "spans": {k: dict(v) for k, v in r["spans"].items()},
                 "counters": dict(r["counters"])} for r in _runs]


def phase_seconds() -> Dict[str, float]:
    """{phase: seconds} of the phases recorded since the last reset, in
    the order they first closed."""
    with _lock:
        return dict(_phases)


# ---------------------------------------------------------------- reader


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
