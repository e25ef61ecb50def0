"""The control of `correct`: the plain reference put in the program's place
with its cells saturated to int4, the nearest precision below the int8
that holds every score of the configurations' 91-base reads exactly,
judged by the same comparison as a run's outputs.

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 [--device cpu]

For each seed it makes the cell's dataset in memory (no files), works out
the reference's matrices and the control's, and prints one JSON line:
the mismatched entries, which a sound program holds at 0 and the control
has to fail. The benchmark's own runs do not run it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402
from benchmark.inputs import synth  # noqa: E402
from benchmark.reference import mtx  # noqa: E402
from benchmark.reference import vartrix as reference  # noqa: E402

CONTROL_BITS = 4


def control_mismatches(cell, seed: int, device: str) -> dict:
    """{"mismatched_entries", "entries", seconds} of the control on seed."""
    t0 = time.perf_counter()
    ds = synth.generate(cell.generator, seed)
    sem = cell.semantics
    want, shape, _ = reference.expected(ds, sem, device)
    got, _, _ = reference.expected(ds, sem, device, bits=CONTROL_BITS)
    return {"workload": cell.name, "seed": seed,
            "mismatched_entries": sum(mtx.mismatches(got[k], want[k])
                                      for k in want),
            "entries": sum(len(w[0]) for w in want.values()),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control_mismatches(cell, int(s), args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
