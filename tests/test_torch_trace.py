"""The port's span and counter recorder (utils/trace): the spans each path
opens and their totals beside --metrics-json's phase timers, exact
counters on small inputs, the spans in a torch.profiler trace around a
job, the recorder off (no clock, no profiler call), and --profile-dir's
one window span."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu_torch import driver
from vartrix_tpu_torch.core.pipeline import (WINDOW_GAP, PipelineArgs,
                                             collect_reads, prepare_variants)
from vartrix_tpu_torch.io.bam import BamReader
from vartrix_tpu_torch.io.barcodes import load_barcodes
from vartrix_tpu_torch.io.cram import write_crai, write_cram
from vartrix_tpu_torch.io.fasta import FastaIndex, IndexedFasta
from vartrix_tpu_torch.io.vcf import read_vcf_records
from vartrix_tpu_torch.ops import sw_cuda, sw_torch
from vartrix_tpu_torch.utils import trace
from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

PHASE_SPANS = {"vartrix::validate", "vartrix::haplotypes",
               "vartrix::aggregate", "vartrix::write"}
ALWAYS = PHASE_SPANS | {"vartrix::job", "vartrix::haplotypes.fasta",
                        "vartrix::haplotypes.upper",
                        "vartrix::haplotypes.invalid_index"}
SCORE = {"vartrix::score.prep", "vartrix::score.bucket",
         "vartrix::score.haps", "vartrix::score.gather",
         "vartrix::score.launch", "vartrix::score.sync"}
MONO = {"vartrix::decode", "vartrix::collect", "vartrix::score"}
# path -> (flags, spans it must open, spans it must not)
PATHS = {
    "full_whole": (["--fetch", "whole"],
                   ALWAYS | MONO | SCORE | {"vartrix::decode.early"},
                   {"vartrix::plan", "vartrix::stream"}),
    "banded_regions": (["--sw-mode", "banded", "--fetch", "regions"],
                       ALWAYS | MONO | SCORE | {"vartrix::plan"},
                       {"vartrix::decode.early", "vartrix::stream"}),
    "full_stream": (["--stream", "4"],
                    ALWAYS | SCORE | {"vartrix::stream",
                                      "vartrix::stream.window",
                                      "vartrix::plan", "vartrix::decode",
                                      "vartrix::collect"},
                    {"vartrix::decode.early", "vartrix::score"}),
}
# spans that run on a worker thread: their parent is on another thread
WORKER = {"vartrix::decode.early", "vartrix::score.gather"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("trace")),
                            SynthConfig(n_variants=6, n_cells=10,
                                        reads_per_variant=8, seed=61))


def run(data, tmp_path, *extra, metrics=True):
    out = tmp_path / "o.mtx"
    argv = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
            "-c", data["barcodes"], "-o", str(out), "--device", "cpu",
            "--backend", "torch", *extra]
    if metrics:
        argv += ["--metrics-json", str(tmp_path / "m.json")]
    driver._main(argv)
    assert out.exists()
    if metrics:
        with open(tmp_path / "m.json") as f:
            return json.load(f)
    return None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_of_each_path(data, tmp_path, path):
    flags, want, absent = PATHS[path]
    got = run(data, tmp_path, *flags)
    spans = got["spans"]
    assert want <= set(spans), want - set(spans)
    assert not absent & set(spans)
    assert all(n.startswith("vartrix::") for n in spans)
    # every phase timer is its span's total, to the timer's rounding
    assert set(got["phase_seconds"]) <= {n[len("vartrix::"):]
                                         for n in spans}
    for name, sec in got["phase_seconds"].items():
        assert round(spans[f"vartrix::{name}"]["s"], 4) == sec
    for name, e in spans.items():
        assert e["n"] >= 1 and 0 <= e["self_s"] <= e["s"] + 1e-9
        assert (e["parent"] is None) == (name == "vartrix::job")
        assert e["parent"] is None or e["parent"] in spans
    # a parent's total holds its children's on its own thread
    kids = {}
    for name, e in spans.items():
        if e["parent"] and name not in WORKER and not (
                path == "full_stream" and name in ("vartrix::plan",
                                                   "vartrix::decode")):
            kids.setdefault(e["parent"], []).append(spans[name]["s"])
    for parent, totals in kids.items():
        assert sum(totals) <= spans[parent]["s"] + 1e-6, parent
    assert sum(s["n"] for s in spans.values()) < 150
    if path == "full_whole":
        assert spans["vartrix::decode.early"]["parent"] == "vartrix::job"
        assert spans["vartrix::score.gather"]["parent"] == (
            "vartrix::score.bucket")
    if path == "full_stream":
        assert spans["vartrix::stream.window"]["n"] == 2


def _window_reads(data, records, pad):
    """(file bytes, spans) of the padded windows [pos - pad, end + pad) of
    the biallelic records, merged per chromosome where they overlap or lie
    under WINDOW_GAP bases apart: bytes from each span's first base to its
    last, line ends included."""
    entries = {e.name: e
               for e in FastaIndex.from_file(data["fasta"] + ".fai").entries}
    wins = {}
    for r in records:
        if len(r.alleles) <= 2:
            e = entries[r.chrom]
            wins.setdefault(r.chrom, []).append(
                (max(0, r.pos - pad), min(e.length, r.pos + len(r.ref) + pad)))
    total = n_spans = 0
    for chrom, ws in wins.items():
        e = entries[chrom]
        merged = []
        for lo, hi in sorted(ws):
            if merged and lo < merged[-1][1] + WINDOW_GAP:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        for lo, hi in merged:
            n_spans += 1
            total += (hi - 1) // e.linebases * e.linewidth \
                + (hi - 1) % e.linebases + 1 \
                - (lo // e.linebases * e.linewidth + lo % e.linebases)
    return total, n_spans


def test_counters_exact(data, tmp_path, monkeypatch):
    shipped = [0]
    launch_part, device_haps = sw_cuda._launch_part, sw_cuda.device_haps

    def spy_part(fn, dev, hap, read_bits, xc, lens, ir, ia):
        shipped[0] += xc.size + 4 * (ir.size + ia.size) + (
            0 if lens is None else 4 * lens.size)
        return launch_part(fn, dev, hap, read_bits, xc, lens, ir, ia)

    def spy_haps(hap_mat, dev):
        shipped[0] += (hap_mat.packed.size + 4 * hap_mat.lens.size
                       if isinstance(hap_mat, sw_torch.PackedHaps)
                       else hap_mat.size)
        return device_haps(hap_mat, dev)

    monkeypatch.setattr(sw_cuda, "_launch_part", spy_part)
    monkeypatch.setattr(sw_cuda, "device_haps", spy_haps)
    got = run(data, tmp_path, "--fetch", "whole")
    c = got["counters"]

    records = read_vcf_records(data["vcf"])
    pargs = PipelineArgs()
    works = prepare_variants(records, IndexedFasta(data["fasta"]), pargs)
    collect_reads(BamReader(data["bam"]), works,
                  load_barcodes(data["barcodes"]), pargs)
    scored = sum(len(w.cell_indices) for w in works)
    assert scored > 0
    assert c["collect.reads_scored"] == scored
    assert c["decode.records"] == sum(
        1 for _ in BamReader(data["bam"]).records())
    assert c["decode.chunks"] == 1  # the whole file
    assert c["score.h2d_bytes"] == shipped[0] > 0
    # the haplotypes read their merged windows, no whole chromosome
    read, n_spans = _window_reads(data, records, pargs.padding)
    assert c["fasta.bytes_read"] == read > 0
    assert c["fasta.windows"] == n_spans > 0
    assert "fasta.chrom_fills" not in c
    assert c["score.buckets"] >= 1 and c["score.chunks"] >= 1
    assert c["route.read.p2"] + c.get("route.read.p4", 0) + c.get(
        "route.read.dense", 0) == c["score.chunks"]
    assert c["route.hap.p4"] + c.get("route.hap.dense", 0) == c[
        "score.buckets"]
    # the plain version launches no kernel
    assert not any(k.startswith("launch.") for k in c)
    assert got["kernel_launches"] == dict.fromkeys(
        ("sw_pair", "sw_banded", "band_build", "band_index"), 0)


def test_cram_reference_fills_whole_chromosomes(data, tmp_path):
    """A CRAM's reference-based decode walks whole chromosomes through the
    FASTA's whole-chromosome cache; the haplotypes read their windows."""
    cram = str(tmp_path / "reads.cram")
    bam = BamReader(data["bam"])
    write_cram(cram, list(zip(bam.ref_names, bam.ref_lens)), bam.records(),
               fasta_path=data["fasta"])
    write_crai(cram, fasta_path=data["fasta"])
    c = run(dict(data, bam=cram), tmp_path, "--host", "python")["counters"]
    assert c["fasta.chrom_fills"] > 0
    assert c["fasta.windows"] > 0


def test_kernel_launches_sums_the_modes():
    assert driver.kernel_launches(
        {"launch.sw_pair.pair": 3, "launch.sw_pair.rows": 2,
         "launch.sw_banded.rows": 1, "launch.band_build.pair": 7,
         "launch.band_index": 4, "score.chunks": 9}) == {
        "sw_pair": 5, "sw_banded": 1, "band_build": 7, "band_index": 4}


def test_counters_per_run(data, tmp_path):
    got = []
    for k in range(2):
        (tmp_path / str(k)).mkdir()
        got.append(run(data, tmp_path / str(k), "--fetch", "whole")[
            "counters"])
    assert got[0] == got[1]


def test_runs_keep_each_recording_job(data, tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "_runs", trace.deque(maxlen=2))
    got = []
    for k in range(3):
        (tmp_path / str(k)).mkdir()
        got.append(run(data, tmp_path / str(k), "--fetch", "whole"))
    (tmp_path / "n").mkdir()
    run(data, tmp_path / "n", "--fetch", "whole", metrics=False)
    (tmp_path / "p").mkdir()
    run(data, tmp_path / "p", "--fetch", "whole", "--profile-dir",
        str(tmp_path / "p" / "prof"))
    runs = trace.runs()
    # the last two recording jobs, the one without --metrics-json left out
    assert [r["profiled"] for r in runs] == [False, True]
    assert runs[0]["spans"] == got[2]["spans"]
    assert runs[0]["counters"] == got[2]["counters"]
    assert runs[1]["counters"] == got[2]["counters"]


def _annotations(events):
    return [(e["name"], e["tid"], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_in_a_profiler_trace(data, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=driver._all_threads()) as prof:
        got = run(data, tmp_path, "--fetch", "regions")
    path = str(tmp_path / "job.json")
    prof.export_chrome_trace(path)
    ann = _annotations(trace.load_events(path))
    names = {a[0] for a in ann}
    for phase in got["phase_seconds"]:
        assert f"vartrix::{phase}" in names, phase
    assert {"vartrix::plan", "vartrix::job"} <= names
    spans = got["spans"]
    assert names <= set(spans)
    main = next(t for n, t, _, _ in ann if n == "vartrix::job")
    # each span lies inside a span of its recorded parent
    for name, tid, b, e in ann:
        parent = spans[name]["parent"]
        if parent is None:
            continue
        assert any(pb - 1 <= b and e <= pe + 1 for pn, _, pb, pe in ann
                   if pn == parent), (name, parent)
    gathers = [t for n, t, _, _ in ann if n == "vartrix::score.gather"]
    if driver._all_threads() is not None:
        # the producer thread's gathers, with their thread's own id
        assert gathers and all(t != main for t in gathers)
    else:
        assert spans["vartrix::score.gather"]["n"] >= 1


def test_recorder_off_calls_no_clock_or_profiler(data, tmp_path,
                                                 monkeypatch):
    calls = {"clock": 0, "profiler": 0}

    class Clock:
        @staticmethod
        def perf_counter():
            calls["clock"] += 1
            return 0.0

    def profiler(name):
        calls["profiler"] += 1
        raise AssertionError("record_function with the recorder off")

    monkeypatch.setattr(trace, "time", Clock)
    monkeypatch.setattr(trace, "record_function", profiler)
    run(data, tmp_path, "--fetch", "whole", metrics=False)
    assert calls == {"clock": 0, "profiler": 0}
    assert trace.span("vartrix::x") is trace._OFF
    assert trace.spans() == {} and trace.phase_seconds() == {}
    # counters stay on
    assert trace.counters()["decode.records"] > 0


@pytest.mark.parametrize("extra,phase", [([], "score"),
                                         (["--stream", "4"], "stream")],
                         ids=["score", "stream"])
def test_profile_dir_holds_one_window_span(data, tmp_path, extra, phase):
    prof = tmp_path / "trace"
    got = run(data, tmp_path, "--profile-dir", str(prof), *extra)
    events = trace.load_events(str(prof / f"{phase}.pt.trace.json"))
    ann = _annotations(events)
    assert [a[0] for a in ann].count(f"vartrix::{phase}") == 1
    s = trace.device_summary(events, phase)
    (_, _, b, e), = [a for a in ann if a[0] == f"vartrix::{phase}"]
    assert s["window_us"] == pytest.approx(e - b)
    # the phase's timer is its span's, which opens once the profiler runs
    assert round(got["spans"][f"vartrix::{phase}"]["s"], 4) == \
        got["phase_seconds"][phase]
    # the spans inside the window are in the trace too
    assert "vartrix::score.bucket" in {a[0] for a in ann}


def test_recorder_nesting_threads_and_self_time():
    trace.reset(record=True)
    seen = {}
    with trace.span("vartrix::a"):
        with trace.span("vartrix::a.b"):
            with trace.span("vartrix::a.b.c"):
                pass

        def work():
            with trace.span("vartrix::w"):
                seen["thread"] = threading.get_ident()

        t = threading.Thread(target=trace.carry(work))
        t.start()
        t.join()
        with trace.phase("p") as sp:
            trace.count("k", 2)
            trace.count("k")
    s = trace.spans()
    assert s["vartrix::a"]["parent"] is None
    assert s["vartrix::a.b"]["parent"] == "vartrix::a"
    assert s["vartrix::a.b.c"]["parent"] == "vartrix::a.b"
    assert s["vartrix::w"]["parent"] == "vartrix::a"
    assert s["vartrix::p"]["parent"] == "vartrix::a"
    assert seen["thread"] != threading.get_ident()
    a = s["vartrix::a"]
    same_thread = s["vartrix::a.b"]["s"] + s["vartrix::p"]["s"]
    assert a["self_s"] == pytest.approx(a["s"] - same_thread, abs=1e-9)
    assert s["vartrix::a.b"]["self_s"] == pytest.approx(
        s["vartrix::a.b"]["s"] - s["vartrix::a.b.c"]["s"], abs=1e-9)
    assert trace.phase_seconds() == {"p": sp.seconds}
    assert trace.counters() == {"k": 3}
    trace.reset(record=False)
    assert trace.spans() == {} and trace.counters() == {}


def test_recorder_under_threads():
    # more threads than cores, switching often: no count or span is lost
    n_threads, n_each = 4 * (os.cpu_count() or 1), 200
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.reset(record=True)
        with trace.span("vartrix::root"):
            def work():
                for _ in range(n_each):
                    with trace.span("vartrix::w"):
                        trace.count("k")

            threads = [threading.Thread(target=trace.carry(work))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert trace.counters() == {"k": n_threads * n_each}
    w = trace.spans()["vartrix::w"]
    assert w["n"] == n_threads * n_each and w["parent"] == "vartrix::root"
    trace.reset(record=False)


@pytest.mark.cuda
@pytest.mark.parametrize("sw_mode", ["full", "banded"])
def test_launch_counters_on_card(data, tmp_path, sw_mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    out = tmp_path / "o.mtx"
    driver._main(["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
                  "-c", data["barcodes"], "-o", str(out), "--sw-mode",
                  sw_mode, "--metrics-json", str(tmp_path / "m.json")])
    with open(tmp_path / "m.json") as f:
        got = json.load(f)
    c = got["counters"]
    assert got["kernel_launches"] == driver.kernel_launches(c)
    kernels = (["sw_pair"] if sw_mode == "full"
               else ["sw_banded", "band_build", "band_index"])
    for k, n in got["kernel_launches"].items():
        assert (n > 0) == (k in kernels), (k, n)
    if sw_mode == "banded":
        # band_bounds waits for its count pass: a sync span per chunk
        assert got["spans"]["vartrix::score.sync"]["n"] > c["score.chunks"]
    assert np.isfinite(got["spans"]["vartrix::score"]["s"])
    assert os.path.getsize(out) > 0
