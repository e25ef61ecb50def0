"""The port's seeded data generator writes byte-identical FASTA, VCF, BAM,
BAI and barcode files to the JAX package's for the same config."""

import os

import numpy as np
import pytest

from vartrix_tpu.utils import synth as jax_synth
from vartrix_tpu_torch.utils import synth as port_synth

CONFIGS = {
    "pipeline_test": dict(n_variants=8, n_cells=25, reads_per_variant=25,
                          seed=77, spliced_frac=0.3, indel_frac=0.2),
    "background_no_umi": dict(n_variants=12, n_cells=30, reads_per_variant=10,
                              seed=5, umi=False, background_reads=200),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dataset_byte_identical(tmp_path, name):
    cfg = CONFIGS[name]
    got = port_synth.generate_dataset(str(tmp_path / "port"),
                                      port_synth.SynthConfig(**cfg))
    exp = jax_synth.generate_dataset(str(tmp_path / "jax"),
                                     jax_synth.SynthConfig(**cfg))
    assert got.keys() == exp.keys()
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert "reads.bam.bai" in files
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f
    for k, v in exp.items():
        if not isinstance(v, str):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
