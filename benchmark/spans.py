"""The program's own spans and counters, as the per-layer metrics read
them, and the device's idle time of a whole-job profile cut at the
program's spans.

The jobs run in the benchmark's process, so the readers take the spans
and counters from the program's recorder (vartrix_tpu_torch.utils.trace's
`runs()`, one entry per job run with `--metrics-json`), not from the
jobs' metrics files. A program without that record gives None, and the
metric is left out of the line.
"""

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from . import trace


def program_runs(r) -> Optional[List[dict]]:
    """The program's record ({"spans", "counters"}) of the traced run's
    unprofiled jobs: its last unprofiled recording jobs, as many as r has
    unprofiled jobs with phase timers (the jobs `Readings.phase_ms`
    averages over), or as many as the program keeps. None where the
    program keeps no such record or r has no such jobs."""
    n = len(r.plain_phases())
    if not n:
        return None
    try:
        from vartrix_tpu_torch.utils import trace as recorder
    except ImportError:
        return None
    runs = getattr(recorder, "runs", None)
    if runs is None:
        return None
    plain = [x for x in runs() if not x["profiled"]]
    return plain[-n:] or None


def span_ms(r, name: str) -> Optional[float]:
    """Mean total milliseconds of the program's span `name` per unprofiled
    traced job (0 in a job that did not open it); None as program_runs."""
    runs = program_runs(r)
    if runs is None:
        return None
    return 1e3 * float(np.mean([x["spans"].get(name, {}).get("s", 0.0)
                                for x in runs]))


def counter(r, name: str) -> Optional[float]:
    """Mean of the program's counter `name` per unprofiled traced job (0 in
    a job that did not count it); None as program_runs."""
    runs = program_runs(r)
    if runs is None:
        return None
    return float(np.mean([x["counters"].get(name, 0) for x in runs]))


def idle_spans(events: List[dict], span: str) -> Dict[str, float]:
    """Seconds the device was idle inside the span, by the program's own
    spans: each idle gap cut at the edges of the "vartrix::*" spans that
    the span's thread opened (the times the trace gives them), each piece
    named by the innermost such span covering it, or "none" where none
    does."""
    w0, w1 = trace.span_window(events, span)
    tid = next(e.get("tid") for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == span)
    prog = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation" and e.get("tid") == tid
            and str(e.get("name", "")).startswith("vartrix::")]
    busy = trace.merged((b, e) for _, _, b, e, _ in trace.device_intervals(
        events, w0, w1))
    gaps, t = [], w0
    for b, e in busy:
        if b > t:
            gaps.append((t, b))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    edges = sorted({x for b, e, _ in prog for x in (b, e) if w0 < x < w1})
    out: Dict[str, float] = defaultdict(float)
    for b, e in gaps:
        cuts = [b] + [x for x in edges if b < x < e] + [e]
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            inner = min(((pe - pb, name) for pb, pe, name in prog
                         if pb <= mid < pe), default=None)
            out["none" if inner is None else inner[1]] += (hi - lo) * 1e-6
    return dict(out)
