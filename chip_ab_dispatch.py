#!/usr/bin/env python3
"""A/B of the port's chunk dispatcher on one CUDA card, variants in turns.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_ab_dispatch.py NAME=TREE[:DEPTH] ... [--turns 4] [--runs 5]
        [--out PATH]

Each variant is a checkout of the repo (TREE, whose vartrix_tpu_torch it
imports; "." is this one) and, optionally, the value its
ops/sw_cuda.PREFETCH_DEPTH is set to. The datasets are chip_smoke.py's
phase 5 sets, made once by this checkout's generator: the 500,000-read
A/C/G/T set (E2E_CFG), whose reads ship 2-bit, and its copy with one N in
a seeded 1 % of the reads (N_READ_FRAC, N_READ_SEED), whose reads ship
4-bit. Turn t runs every variant in a process of its own, in the given
order on even turns and in reverse on odd ones (A B B A ...). A process
runs full consensus with --backend cuda once on each set to warm up (the
first process of a tree also builds its kernels), then --runs times on
each set in alternation, and records per run the `score` phase seconds
(--metrics-json), the wall time of the driver call, and the dispatcher's
time: the sum over shape buckets of SwBackend.pair_calls_chained, from a
synchronised start to the codes' copy to the host. Every matrix must
equal the first variant's (CSR). Every run goes to --out (by default
build/ab_dispatch/runs.json); the medians by variant and set, beside the
card's name and power limit, are printed, the last line as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "ab_dispatch")
METRICS = ("dispatch_ms", "score_s", "wall_s")


def worker(tree, depth, sets, outdir, runs):
    """One variant's process: (runs by set) as JSON on standard output."""
    sys.path.insert(0, tree)
    import torch

    from vartrix_tpu_torch import driver
    from vartrix_tpu_torch.ops import sw_cuda

    if not os.path.abspath(sw_cuda.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {sw_cuda.__file__}, not {tree}'s")
    if depth != "-":
        if not hasattr(sw_cuda, "PREFETCH_DEPTH"):
            raise SystemExit(f"{tree} has no PREFETCH_DEPTH")
        sw_cuda.PREFETCH_DEPTH = int(depth)
    spent = []
    inner = sw_cuda.SwBackend.pair_calls_chained

    def timed(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(self, *args)
        spent.append(time.perf_counter() - t0)
        return out

    sw_cuda.SwBackend.pair_calls_chained = timed
    got = {name: [] for name in sets}
    mtx = {}

    def run(name, keep):
        data = sets[name]
        fd, out = tempfile.mkstemp(".mtx", f"{name}_", outdir)
        os.close(fd)
        os.unlink(out)
        mj = out[:-4] + ".json"
        argv = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
                "-c", data["barcodes"], "-o", out, "-s", "consensus",
                "--threads", str(os.cpu_count() or 1), "--metrics-json",
                mj, "--backend", "cuda"]
        spent.clear()
        t0 = time.perf_counter()
        driver._main(argv)
        wall = time.perf_counter() - t0
        with open(mj) as f:
            payload = json.load(f)
        mtx.setdefault(name, out)
        if keep:
            got[name].append({
                "dispatch_ms": 1e3 * sum(spent), "buckets": len(spent),
                "score_s": payload["phase_seconds"]["score"],
                "wall_s": wall})

    for name in sets:
        run(name, False)
    for _ in range(runs):
        for name in sets:
            run(name, True)
    print(json.dumps({"runs": got, "mtx": mtx}))


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=TREE[:DEPTH]")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(WORK, "runs.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    variants = []
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        tree, _, depth = rest.partition(":")
        variants.append((name, os.path.abspath(tree), depth or "-"))
    sys.path.insert(0, HERE)
    import chip_smoke

    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    data, _ = chip_smoke.generate_e2e(WORK)
    data_n, n_changed, _ = chip_smoke.generate_n_reads(data)
    sets = {name: {k: d[k] for k in ("vcf", "bam", "fasta", "barcodes")}
            for name, d in (("acgt", data), ("n_reads", data_n))}
    print(f"card: {card()}", flush=True)
    print(f"datasets: {data['n_reads']} reads, {n_changed} of them given "
          f"an N, made in {time.perf_counter() - t0:.1f}s", flush=True)
    runs = {name: {s: [] for s in sets} for name, _, _ in variants}
    turns = []
    first_mtx = None
    for turn in range(args.turns):
        order = variants if turn % 2 == 0 else variants[::-1]
        for name, tree, depth in order:
            outdir = os.path.join(WORK, f"{name}_{turn}")
            os.makedirs(outdir, exist_ok=True)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 depth, json.dumps(sets), outdir, str(args.runs)],
                cwd=tree, capture_output=True, text=True, timeout=900)
            if r.returncode:
                sys.stderr.write(r.stderr[-4000:])
                raise SystemExit(f"{name} turn {turn}: exit {r.returncode}")
            got = json.loads(r.stdout.strip().splitlines()[-1])
            if first_mtx is None:
                first_mtx = got["mtx"]
            for s, path in got["mtx"].items():
                if not chip_smoke.csr_equal(path, first_mtx[s]):
                    raise SystemExit(f"{name} turn {turn}: the {s} matrix "
                                     f"differs from {variants[0][0]}'s")
            for s, rs in got["runs"].items():
                runs[name][s] += rs
            med = {s: statistics.median(x["dispatch_ms"] for x in rs)
                   for s, rs in got["runs"].items()}
            turns.append({"turn": turn, "variant": name,
                          "dispatch_ms_median": med})
            print(f"turn {turn} {name}: dispatcher ms, medians of "
                  f"{args.runs}: " + ", ".join(
                      f"{s} {v:.4f}" for s, v in med.items()), flush=True)
    summary = {}
    for name, by_set in runs.items():
        summary[name] = {
            s: {m: statistics.median(x[m] for x in rs) for m in METRICS}
            for s, rs in by_set.items()}
        for s, med in summary[name].items():
            print(f"{name} {s} ({len(by_set[s])} runs): dispatcher "
                  f"{med['dispatch_ms']:.4f} ms, score "
                  f"{med['score_s']:.4f} s, wall {med['wall_s']:.4f} s")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card(), "variants": variants, "turns": turns,
                   "runs": runs, "medians": summary}, f, indent=1)
    print(json.dumps({"card": card(), "medians": summary}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        tree, depth, sets, outdir, runs = sys.argv[2:7]
        worker(tree, depth, json.loads(sets), outdir, int(runs))
    else:
        main()
