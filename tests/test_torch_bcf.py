"""BCF input in the port: records read from write_bcf files equal the JAX
package's (empty ALT, multiallelic and long alleles included), both
writers give the same bytes, and a BCF run's matrix is byte-equal to the
JAX package's and to the port's VCF run."""

import pytest
import torch

from vartrix_tpu.driver import _main as jax_main
from vartrix_tpu.io import bcf as jbcf
from vartrix_tpu.io.vcf import VcfRecord as JaxVcfRecord
from vartrix_tpu.io.vcf import read_vcf_records as jax_read_vcf
from vartrix_tpu.utils.synth import SynthConfig, generate_dataset
from vartrix_tpu_torch.driver import _main as port_main
from vartrix_tpu_torch.io import bcf as pbcf
from vartrix_tpu_torch.io.vcf import VcfRecord, is_bcf, read_vcf_records

SPECIAL = [("c1", 10, b"AT", []),
           ("c1", 50, b"A", [b"C", b"G"]),
           ("c1", 99, b"G", [b"G" + b"A" * 20]),  # overflow-length allele
           ("c2", 5, b"C" * 16, [b"T"])]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scorer's many small ops on one thread: with the suite's
    workers sharing the cores, spinning intra-op threads slow it 50x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(recs):
    return [(r.chrom, r.pos, r.ref, r.alts) for r in recs]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("bcf")), SynthConfig(
        n_variants=12, n_cells=25, reads_per_variant=15, seed=31,
        indel_frac=0.3))


def test_special_records_equal_to_jax(tmp_path):
    contigs = [("c1", 1000), ("c2", 500)]
    pbcf.write_bcf(str(tmp_path / "p.bcf"), contigs,
                   [VcfRecord(*r) for r in SPECIAL])
    jbcf.write_bcf(str(tmp_path / "j.bcf"), contigs,
                   [JaxVcfRecord(*r) for r in SPECIAL])
    assert (tmp_path / "p.bcf").read_bytes() == (tmp_path / "j.bcf").read_bytes()
    got = read_vcf_records(str(tmp_path / "p.bcf"))  # detected by content
    assert is_bcf(str(tmp_path / "p.bcf"))
    assert _fields(got) == SPECIAL
    assert _fields(got) == _fields(jbcf.read_bcf_records(str(tmp_path / "p.bcf")))


def test_dataset_records_equal_to_jax(data, tmp_path):
    recs = read_vcf_records(data["vcf"])
    contigs = [(c, 100_000) for c in data["chroms"]]
    path = str(tmp_path / "v.bcf")
    pbcf.write_bcf(path, contigs, recs)
    assert _fields(pbcf.read_bcf_records(path)) == _fields(recs)
    assert _fields(read_vcf_records(path)) == _fields(jax_read_vcf(path))


def test_not_a_bcf_raises(tmp_path):
    from vartrix_tpu_torch.io.bam_writer import bgzf_compress

    path = tmp_path / "x.bcf"
    path.write_bytes(bgzf_compress(b"VCF not binary"))
    with pytest.raises(ValueError, match="not a BCF"):
        pbcf.read_bcf_records(str(path))


@pytest.mark.parametrize("mode", [["-s", "consensus"],
                                  ["-s", "coverage", "--umi"]],
                         ids=["consensus", "coverage_umi"])
def test_bcf_run_byte_equal_to_jax(data, tmp_path, mode):
    bcf = str(tmp_path / "v.bcf")
    pbcf.write_bcf(bcf, [(c, 100_000) for c in data["chroms"]],
                   read_vcf_records(data["vcf"]))

    def run(main, vcf, tag, extra):
        out = tmp_path / f"{tag}.mtx"
        main(["-v", vcf, "-b", data["bam"], "-f", data["fasta"], "-c",
              data["barcodes"], "-o", str(out), "--ref-matrix",
              str(tmp_path / f"{tag}_ref.mtx"), *mode, *extra])
        return out.read_bytes(), (tmp_path / f"{tag}_ref.mtx").exists()

    port = ["--device", "cpu", "--backend", "torch"]
    got = run(port_main, bcf, "p_bcf", port)
    assert got == run(port_main, data["vcf"], "p_vcf", port)
    assert got == run(jax_main, bcf, "j_bcf",
                      ["--host", "native", "--backend", "cpu"])
    assert got[0].count(b"\n") > 3
