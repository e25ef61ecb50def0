"""The port's shard merge: --num-shards partials merged by the port's
merge_partials (and its `python -m` entry) byte-equal to the JAX
package's merge of the same partials, and CSR-equal to the unsharded run;
a shape mismatch raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.parallel.multihost import _mtx_header as jax_mtx_header
from vartrix_tpu.parallel.multihost import merge_partials as jax_merge
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.driver import _main as port_main
from vartrix_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("merge")), SynthConfig(
        n_variants=11, n_cells=25, reads_per_variant=15, seed=41))


def _run(data, out, *extra):
    port_main(["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
               "-c", data["barcodes"], "-o", str(out), "--device", "cpu",
               "--backend", "torch", *extra])
    return str(out)


def _canonical(path):
    """(shape, sorted (row, col) keys, values) of a .mtx; values compare
    NaN-aware."""
    m = scipy.io.mmread(path).tocoo()
    order = np.lexsort((m.col, m.row))
    return m.shape, np.stack([m.row, m.col])[:, order], m.data[order]


@pytest.mark.parametrize("mode", [["-s", "consensus"], ["-s", "alt_frac"]],
                         ids=["consensus", "alt_frac"])
def test_merged_shards_equal_jax_merge_and_unsharded(data, tmp_path, mode):
    whole = _run(data, tmp_path / "whole.mtx", *mode)
    parts = [_run(data, tmp_path / f"part{i}.mtx", *mode, "--num-shards", "4",
                  "--shard-index", str(i)) for i in range(4)]
    for p in parts:
        assert multihost._mtx_header(p) == jax_mtx_header(p)
    multihost.merge_partials(str(tmp_path / "port.mtx"), parts)
    jax_merge(str(tmp_path / "jax.mtx"), parts)
    got = (tmp_path / "port.mtx").read_bytes()
    assert got == (tmp_path / "jax.mtx").read_bytes()
    (sa, ka, va), (sb, kb, vb) = _canonical(str(tmp_path / "port.mtx")), \
        _canonical(whole)
    assert sa == sb and np.array_equal(ka, kb) and len(va) > 0
    assert np.array_equal(va, vb, equal_nan=True)


def test_merge_cli_entry(data, tmp_path):
    parts = [_run(data, tmp_path / f"part{i}.mtx", "--num-shards", "3",
                  "--shard-index", str(i)) for i in range(3)]
    out = str(tmp_path / "merged.mtx")
    subprocess.run([sys.executable, "-m", "vartrix_tpu_torch.parallel.multihost",
                    out, *parts], cwd=ROOT, check=True)
    jax_merge(str(tmp_path / "jax.mtx"), parts)
    assert (tmp_path / "jax.mtx").read_bytes() == open(out, "rb").read()


def test_shape_mismatch_raises(tmp_path):
    a, b = tmp_path / "a.mtx", tmp_path / "b.mtx"
    a.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "% written by sprs\n3 4 1\n1 1 1\n")
    b.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "% written by sprs\n3 5 1\n2 2 1\n")
    with pytest.raises(ValueError, match="shape"):
        multihost.merge_partials(str(tmp_path / "o.mtx"), [str(a), str(b)])


@pytest.mark.parametrize("n,shards", [(11, 4), (3, 5), (0, 2), (100, 1)])
def test_shard_ranges_tile_the_rows(n, shards):
    from vartrix_tpu.parallel.multihost import shard_range as jax_shard_range

    ranges = [multihost.shard_range(n, shards, i) for i in range(shards)]
    assert ranges == [jax_shard_range(n, shards, i) for i in range(shards)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    with pytest.raises(ValueError):
        multihost.shard_range(n, shards, shards)
