"""--profile-dir in the port writes a torch.profiler chrome trace of the
scoring phase (and of the --stream phase), and the trace reader that
chip_smoke.py uses for the device idle share: the window is the phase's
span, busy time the union of the device's kernel, memcpy and memset
intervals inside it."""

import os

import pytest
import torch

from vartrix_tpu_torch.driver import _main as port_main
from vartrix_tpu_torch.utils import trace
from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scorer's many small ops on one thread: with the suite's
    workers sharing the cores, spinning intra-op threads slow it 50x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("prof")), SynthConfig(
        n_variants=6, n_cells=10, reads_per_variant=8, seed=61))


@pytest.mark.parametrize("extra,phase", [([], "score"),
                                         (["--stream", "4"], "stream")],
                         ids=["score", "stream"])
def test_profile_dir_writes_trace(data, tmp_path, extra, phase):
    prof = tmp_path / "trace"
    port_main(["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
               "-c", data["barcodes"], "-o", str(tmp_path / "o.mtx"),
               "--device", "cpu", "--backend", "torch",
               "--profile-dir", str(prof), *extra])
    assert os.listdir(prof) == [f"{phase}.pt.trace.json"]
    events = trace.load_events(str(prof / f"{phase}.pt.trace.json"))
    s = trace.device_summary(events, phase)
    assert s["window_us"] > 0
    # on the CPU the trace holds host activity only
    assert s["busy_us"] == 0 and s["idle_share"] == 1.0
    assert any(e.get("cat") == "cpu_op" for e in events)


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def test_device_summary_on_hand_made_events():
    events = [
        _x("vartrix::score", "user_annotation", 100, 1000),
        _x("vartrix::score", "gpu_user_annotation", 100, 1000),
        _x("aten::empty", "cpu_op", 110, 50),
        # two kernels on two streams overlapping by 50 us
        _x("void sw_pair16x2_kernel<true, true>(...)", "kernel", 200, 100),
        _x("void sw_pair16x2_kernel<true, true>(...)", "kernel", 250, 100),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 400, 20,
           bytes=4096),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 430, 10,
           bytes=512),
        _x("Memset (Device)", "gpu_memset", 440, 5),
        # clipped at the window's end: 40 of its 100 us are inside
        _x("void other_kernel()", "kernel", 1060, 100),
        # outside the window: not counted
        _x("void sw_pair16x2_kernel<true, true>(...)", "kernel", 10, 20),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1200, 30,
           bytes=99),
        {"ph": "i", "name": "instant", "cat": "kernel", "ts": 500},
    ]
    s = trace.device_summary(events, "score")
    assert s["window_us"] == 1000
    assert s["busy_us"] == 150 + 20 + 10 + 5 + 40
    assert s["idle_share"] == pytest.approx(1 - 225 / 1000)
    assert trace.kernel_count(s, "sw_pair") == 2
    assert s["kernels"]["void other_kernel()"] == {"n": 1, "us": 40.0}
    assert s["copies"]["HtoD"] == {"n": 1, "us": 20.0, "bytes": 4096}
    assert s["copies"]["DtoH"] == {"n": 1, "us": 10.0, "bytes": 512}
    assert s["memset_us"] == 5
    # the window's host time before the first device interval (the kernel
    # at 200) and after the last (clipped at the window's end)
    assert s["lead_us"] == 100 and s["tail_us"] == 0
    with pytest.raises(ValueError, match="vartrix::stream"):
        trace.device_summary(events, "stream")
    idle = trace.device_summary(events[:3], "score")
    assert idle["lead_us"] == idle["tail_us"] == idle["window_us"] == 1000


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),
    ([(0, 10), (2, 3)], 10.0),
    ([(20, 30), (0, 10)], 20.0),
    ([(0, 10), (10, 20)], 20.0),
])
def test_union_length(intervals, want):
    assert trace.union_length(intervals) == want
