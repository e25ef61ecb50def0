"""The port's haplotypes from the variants' padded windows
(core/pipeline.prepare_variants over IndexedFasta.fetch_spans_upper)
against the JAX package's whole-chromosome construction: every work's
reference and alternate haplotype, skip flag and filter metrics equal, on
generated FASTAs in four line layouts and VCFs that reach each corner of
the window arithmetic. The tolerance is exact equality."""

import numpy as np
import pytest

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu.core import pipeline as jpipe
from vartrix_tpu.io.fasta import IndexedFasta as JaxFasta
from vartrix_tpu.io.vcf import read_vcf_records as jax_vcf
from vartrix_tpu_torch.core import pipeline as ppipe
from vartrix_tpu_torch.io.fasta import IndexedFasta
from vartrix_tpu_torch.io.vcf import read_vcf_records
from vartrix_tpu_torch.utils import trace

G = ppipe.WINDOW_GAP
PAD = 100
LENS = {"c1": 2 * G + 30_011, "c2": 12_345, "c3": 150, "c4": 9_000}
# line layouts: (bases a line, line end); None: one line a chromosome
LAYOUTS = {"lines60": (60, b"\n"), "lines61": (61, b"\n"),
           "crlf60": (60, b"\r\n"), "one_line": (None, b"\n")}


def _genome():
    rng = np.random.default_rng(19)
    seqs = {c: bytearray(rng.choice(list(b"ACGT"), n).astype(np.uint8)
                         .tobytes()) for c, n in LENS.items()}
    c1, c2, c4 = seqs["c1"], seqs["c2"], seqs["c4"]
    c1[2000:2010] = b"N" * 10
    c1[5000] = ord("N")
    c1[8000:9000] = c1[8000:9000].lower()   # soft-masked
    c1[9500] = ord("n")                     # upper-cased to N
    c2[0:500] = c2[0:500].lower()
    c2[12_300:12_302] = b"NN"               # near the end
    c4[4000] = ord("R")                     # IUPAC, not in the default set
    return {c: bytes(s) for c, s in seqs.items()}


def _write_fasta(path, seqs, layout):
    lb, end = LAYOUTS[layout]
    with open(path, "wb") as f, open(path + ".fai", "w") as fai:
        for name, seq in seqs.items():
            f.write(b">" + name.encode() + end)
            width = lb or len(seq)
            fai.write(f"{name}\t{len(seq)}\t{f.tell()}\t{width}\t"
                      f"{width + len(end)}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + end)


def _gaps():
    """c1's windows: two overlapping, one under G bases past the span's
    end, one exactly G past it, one far; c2's alone. Three spans on c1."""
    a = 900 + PAD                      # window [900, 1101)
    b = a + 50                         # [950, 1151): overlaps
    c = 1151 + G - 1 + PAD             # starts G - 1 past 1151: merged
    d = c + 1 + PAD + G + PAD          # starts G past c's end: alone
    e = d + 10_000                     # far
    return [("c1", p, "A", "C") for p in (a, b, c, d, e)] + [
        ("c2", 6000, "G", "T")]


# scenario -> (VCF rows (chrom, 0-based pos, REF, ALT), args, row_range)
SCENARIOS = {
    "n_runs": ([("c1", p, r, "T") for p, r in (
        (2010, "A"), (1890, "A"), (2100, "A"), (2110, "A"), (1995, "AAAAA"),
        (2000, "A" * 10), (1900, "A"), (5101, "A"), (5100, "C"),
        (9450, "G"))] + [("c4", p, "A", "G") for p in (3899, 3900, 4101)]
        + [("c1", 3000, "A", "N")], {}, None),
    "soft_masked": ([("c1", p, "A", alt) for p, alt in (
        (8500, "g"), (7950, "T"), (8990, "tt"), (8100, "AcG"))]
        + [("c2", 100, "a", "C")], {}, None),
    "edges": ([("c1", 0, "A", "G"), ("c1", 50, "A", "G"),
               ("c2", LENS["c2"] - 50, "A", "G"),
               ("c2", LENS["c2"] - 2, "A" * 10, "G"),
               ("c2", LENS["c2"], "A", "G"),
               ("c2", LENS["c2"] + 150, "A", "G"),
               ("c3", 10, "A", "G"), ("c3", 140, "AAAAAAAAAAAAAAAA", "G"),
               ("c4", -1, "A", "G")], {}, None),
    "empty_alt_edge": ([("c2", LENS["c2"] - 1, "A", "."), ("c1", 0, "A", "."),
                        ("c2", LENS["c2"] + 5, "A", "."),
                        ("c2", LENS["c2"] + 2 * PAD, "A", "."),
                        ("c3", 0, "A" * 150, ".")], {}, None),
    "multiallelic": ([("c1", 3000, "A", "C,G"), ("c1", 3100, "A", "C"),
                      ("c4", 100, "A", "C,T"), ("c4", 200, "A", "C,T")],
                     {}, None),
    "unsorted": ([("c2", 9000, "A", "C"), ("c1", 20_000, "A", "G"),
                  ("c2", 300, "A", "C"), ("c1", 2005, "A", "G"),
                  ("c4", 4050, "A", "T"), ("c1", 150, "A", "G"),
                  ("c2", 9050, "A", "C")], {}, None),
    "gaps": (_gaps(), {}, None),
    "valid_chars": ([("c1", 2010, "A", "T"), ("c1", 8500, "A", "g"),
                     ("c4", 4050, "A", "T"), ("c1", 9450, "A", "N"),
                     ("c2", 700, "A", "C")], {"valid_chars": b"ACGTN"}, None),
    "row_range": ([("c1", 2010, "A", "T"), ("c2", 700, "A", "C,G"),
                   ("c1", 3000, "A", "G"), ("c4", 10, "A", "G"),
                   ("c2", 50, "A", "T"), ("c1", 26_000, "A", "G"),
                   ("c4", 8990, "A", "G")], {}, (2, 6)),
}


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("windows")
    seqs = _genome()
    out = {}
    for layout in LAYOUTS:
        out[layout] = str(d / f"{layout}.fa")
        _write_fasta(out[layout], seqs, layout)
    return out


def _write_vcf(path, rows):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for chrom, pos, ref, alt in rows:
            f.write(f"{chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t.\tPASS\t.\n")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_windows_equal_whole_chromosome_reference(fastas, tmp_path, layout,
                                                  scenario):
    rows, kw, row_range = SCENARIOS[scenario]
    vcf = str(tmp_path / "v.vcf")
    _write_vcf(vcf, rows)
    trace.reset(False)
    got = ppipe.prepare_variants(read_vcf_records(vcf),
                                 IndexedFasta(fastas[layout]),
                                 ppipe.PipelineArgs(padding=PAD, **kw),
                                 row_range=row_range)
    counters = trace.counters()
    want = jpipe.prepare_variants(jax_vcf(vcf), JaxFasta(fastas[layout]),
                                  jpipe.PipelineArgs(padding=PAD, **kw),
                                  row_range=row_range)
    assert len(got) == len(want) == len(rows)
    for g, w in zip(got, want):
        assert (g.row, g.skipped) == (w.row, w.skipped)
        assert g.rref == w.rref and g.alt_hap == w.alt_hap, g.row
        assert g.metrics.as_dict() == w.metrics.as_dict(), g.row
    # the windows path reads spans and fills no chromosome
    assert "fasta.chrom_fills" not in counters
    assert counters.get("fasta.windows", 0) >= 1
    if scenario == "gaps":
        assert counters["fasta.windows"] == 3 + 1
    skipped = sum(w.skipped for w in want)
    assert 0 < sum(not w.skipped for w in want)
    if scenario in ("n_runs", "valid_chars", "multiallelic", "row_range"):
        assert skipped > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_read_range_strips_from_any_column(fastas, layout):
    """The shared read and line strip against the sequence written, from
    every start column of a line and across line ends."""
    seq = _genome()["c2"]
    fa = IndexedFasta(fastas[layout])
    e = fa.index.by_name["c2"]
    for start in list(range(0, 130)) + [LENS["c2"] - 61, LENS["c2"] - 1]:
        for n in (1, 59, 60, 61, 122, 1000):
            end = min(start + n, LENS["c2"])
            assert fa._read_range(e, start, end) == seq[start:end]
    spans = [(0, 5), (5, 5), (61, 200), (LENS["c2"] - 7, LENS["c2"])]
    assert fa.fetch_spans_upper("c2", spans) == b"".join(
        seq[a:b] for a, b in spans).upper()
