"""The port stands alone: no module of vartrix_tpu_torch, and neither
chip_smoke.py nor chip_ab_dispatch.py, imports jax or vartrix_tpu; importing the driver leaves jax
unloaded; the native library is the port's own build, from its own source;
and a run never falls back to the CPU on its own."""

import ast
import os
import socket
import subprocess
import sys

import pytest
import torch

from torch_cpu import one_torch_thread  # noqa: F401
import vartrix_tpu_torch
from vartrix_tpu_torch import driver
from vartrix_tpu_torch.io.bam import BamReader
from vartrix_tpu_torch.io.cram import write_crai, write_cram
from vartrix_tpu_torch.ops import _build
from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

PKG = os.path.dirname(vartrix_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)
SOURCES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")]
    + [os.path.join(ROOT, f)
       for f in ("chip_smoke.py", "chip_ab_dispatch.py")])
FORBIDDEN = ("jax", "jaxlib", "vartrix_tpu")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"
    with open(path) as f:
        text = f.read()
    for name in ('_native/', '"_native"', "'_native'"):
        assert name not in text, f"{path} names vartrix_tpu/_native"


def test_driver_import_leaves_jax_unloaded():
    code = ("import sys, vartrix_tpu_torch.driver, vartrix_tpu_torch.ops."
            "sw_cuda, vartrix_tpu_torch.parallel.mesh, vartrix_tpu_torch."
            "parallel.multihost, vartrix_tpu_torch.core.device_agg; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'vartrix_tpu' not in sys.modules, 'reference loaded'")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True)


def test_native_library_is_the_ports_own_build():
    path = _build.genomio_library()
    assert path.startswith(os.path.join(ROOT, "build", "vartrix_tpu_torch"))
    assert os.path.exists(path)
    assert _build.GENOMIO_SRC == os.path.join(PKG, "csrc", "genomio.cpp")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("iso")), SynthConfig(
        n_variants=4, n_cells=10, reads_per_variant=6, seed=11))


def _argv(data, tmp_path, *extra):
    return ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
            "-c", data["barcodes"], "-o", str(tmp_path / "o.mtx"), *extra]


def test_no_gpu_without_device_cpu_exits(tmp_path, data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--backend", "torch"]):
        with pytest.raises(SystemExit) as e:
            driver._main(_argv(data, tmp_path, *extra))
        assert e.value.code != 0
    assert not (tmp_path / "o.mtx").exists()


def test_cuda_backend_on_cpu_refused(tmp_path, data):
    with pytest.raises(SystemExit) as e:
        driver._main(_argv(data, tmp_path, "--backend", "cuda",
                           "--device", "cpu"))
    assert e.value.code != 0
    assert not (tmp_path / "o.mtx").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("extra", [
    ["--host", "python"], ["CRAM input"], ["--device-agg"],
    ["--mesh-devices", "2"], ["--distributed", "127.0.0.1:{port},1,0"],
], ids=lambda a: a[0])
def test_formerly_unported_options_run(tmp_path, data, extra, caplog):
    argv = _argv(data, tmp_path, "--device", "cpu", "--backend", "torch")
    if extra[0] == "--distributed":  # a group of one process
        argv += [extra[0], extra[1].format(port=_free_port())]
    elif extra == ["CRAM input"]:
        b = BamReader(data["bam"])
        cram = str(tmp_path / "reads.cram")
        write_cram(cram, list(zip(b.ref_names, b.ref_lens)), b.records(),
                   fasta_path=data["fasta"])
        write_crai(cram, fasta_path=data["fasta"])
        argv[argv.index("-b") + 1] = cram
    else:
        argv += extra
    driver._main(argv)
    assert "not yet ported" not in caplog.text
    assert (tmp_path / "o.mtx").read_text().startswith("%%MatrixMarket")
    assert (tmp_path / "o.mtx").read_bytes() == _reference_run(data,
                                                               tmp_path)


def _reference_run(data, tmp_path):
    """The same run without the option: its matrix bytes."""
    (tmp_path / "plain").mkdir()
    driver._main(_argv(data, tmp_path / "plain", "--device", "cpu",
                       "--backend", "torch"))
    return (tmp_path / "plain" / "o.mtx").read_bytes()


def test_device_cpu_torch_runs(tmp_path, data):
    driver._main(_argv(data, tmp_path, "--device", "cpu", "--backend",
                       "torch"))
    assert (tmp_path / "o.mtx").read_text().startswith("%%MatrixMarket")
