"""fasta_mib: the program's counter fasta.bytes_read (bytes read from the
FASTA file, line ends included) in MiB, mean per unprofiled traced job
(the program's recorder, benchmark/spans.py)."""

from benchmark import spans


def read(r):
    n = spans.counter(r, "fasta.bytes_read")
    return None if n is None else n / 2 ** 20
