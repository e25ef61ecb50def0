"""Runs one cell of the benchmark of vartrix_tpu_torch on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the NVIDIA GPUs the cell
asks for. The last line of standard output is one JSON object: correct,
attempted and failed jobs, the metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics), the device, with --trace 1 a
breakdown, and last the checks that decided `correct`, each number beside
its limit; the checks are also the last lines of standard error. Without
enough CUDA devices, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits 1.
"""

import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 1
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         setup_clock=lambda: _AGE0 + time.perf_counter()
                         - _T0)
    found = harness.loaded_forbidden()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        **{k: v for k, v in result["device"].items()
                           if k != "platform"}}
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
