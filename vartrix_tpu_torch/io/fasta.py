"""Indexed FASTA (.fai) reader.

Equivalent capability to the reference's `bio::io::fasta::IndexedReader`
(used at reference src/main.rs:661,936-954): random access fetch of
[start, end) 0-based half-open subsequences via the samtools .fai index.

Two paths, which share only the low-level read and line-end strip
(`_read_range`: one positioned read, then a vectorised strip from any
start column):

  * windows (`fetch_spans_upper`): the haplotypes' padded windows, which
    core/pipeline.prepare_variants merges into a few spans a chromosome.
    Each span is read once and nothing is cached, so the work follows the
    variants, not the genome, as upstream's per-variant fetch
    (src/main.rs:936-954) does.
  * whole chromosomes (`fetch`, `fetch_upper`): the first request on a
    chromosome reads all of it into a one-chromosome cache. The CRAM
    reader's reference-based decode walks whole chromosomes, which this
    suits; core/haplotypes.construct_haplotypes, the single-variant
    constructor, uses it too.

Reads run in the recorder's span "vartrix::haplotypes.fasta" (utils/trace),
their upper-case in its child "vartrix::haplotypes.upper"; the counters
fasta.bytes_read (bytes read from the file, line ends included),
fasta.windows (spans read by `fetch_spans_upper`) and fasta.chrom_fills
(whole-chromosome cache fills) count the reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils import trace

FASTA_SPAN = "vartrix::haplotypes.fasta"
UPPER_SPAN = "vartrix::haplotypes.upper"


@dataclass(frozen=True)
class FaiEntry:
    name: str
    length: int
    offset: int
    linebases: int
    linewidth: int


class FastaIndex:
    """Parsed .fai index: ordered sequence records."""

    def __init__(self, entries: List[FaiEntry]):
        self.entries = entries
        self.by_name: Dict[str, FaiEntry] = {e.name: e for e in entries}

    @classmethod
    def from_file(cls, fai_path: str) -> "FastaIndex":
        entries = []
        with open(fai_path, "rt") as f:
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if not line:
                    continue
                parts = line.split("\t")
                entries.append(
                    FaiEntry(
                        name=parts[0],
                        length=int(parts[1]),
                        offset=int(parts[2]),
                        linebases=int(parts[3]),
                        linewidth=int(parts[4]),
                    )
                )
        return cls(entries)

    def sequences(self) -> List[FaiEntry]:
        return list(self.entries)

    def chrom_len(self, chrom: str) -> int:
        e = self.by_name.get(chrom)
        if e is None:
            raise KeyError(f"Requested chromosome {chrom} was not found in fasta")
        return e.length


class IndexedFasta:
    """Random-access FASTA reader backed by a .fai index.

    fetch(chrom, start, end) returns bytes of the 0-based half-open interval,
    exactly as the reference's fasta fetch+read does.
    """

    def __init__(self, fasta_path: str):
        fai_path = fasta_path + ".fai"
        if not os.path.exists(fai_path):
            raise FileNotFoundError(fai_path)
        self.path = fasta_path
        self.index = FastaIndex.from_file(fai_path)
        self._fh = open(fasta_path, "rb")
        self._cache_chrom = None
        self._cache_seq = b""
        self._cache_upper = None  # lazily derived from _cache_seq
        # per-chrom cache-miss counts: detects interleaved-chrom fetch
        # patterns (multi-ref CRAM ref_fetch, unsorted VCFs) where the
        # whole-chrom cache fill would thrash O(switches x chrom_len)
        self._miss_counts: Dict[str, int] = {}

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def chrom_len(self, chrom: str) -> int:
        return self.index.chrom_len(chrom)

    def fetch(self, chrom: str, start: int, end: int) -> bytes:
        e = self.index.by_name.get(chrom)
        if e is None:
            raise KeyError(f"Requested chromosome {chrom} was not found in fasta")
        start = max(0, min(start, e.length))
        end = max(start, min(end, e.length))
        if end == start:
            return b""
        if self._cache_chrom != chrom:
            with trace.span(FASTA_SPAN):
                if not self._fill(e, start, end):
                    return self._read_range(e, start, end)
        return self._cache_seq[start:end]

    def _fill(self, e: FaiEntry, start: int, end: int) -> bool:
        """On a cache miss: whether [start, end) of e's chromosome comes
        from the cache, which this fills, or from a windowed read.

        Single-chrom cache: the CRAM reader's reference-based decode asks
        for consecutive stretches of one chromosome at a time, so caching
        the CURRENT chromosome as raw bytes turns its fetches into
        slicing. One chromosome resident at a time (~250MB worst case on
        human chr1)."""
        chrom = e.name
        self._miss_counts[chrom] = self._miss_counts.get(chrom, 0) + 1
        # Interleaved-chrom pattern (this chrom already filled the cache
        # once and was evicted): a small request goes through the windowed
        # read instead of re-reading the whole chromosome again, keeping
        # I/O O(request) rather than O(switches x chrom_len).
        if self._miss_counts[chrom] > 1 and end - start <= 1 << 16:
            return False
        self._cache_chrom = chrom
        self._cache_seq = self._read_range(e, 0, e.length)
        self._cache_upper = None
        trace.count("fasta.chrom_fills")
        return True

    def fetch_upper(self, chrom: str, start: int, end: int) -> bytes:
        """fetch().upper() with the uppercase conversion done ONCE per
        cached chromosome instead of per call — haplotype construction
        makes 3 upper() fetches per variant, which at 100k-variant
        cohort scale is seconds of redundant byte work."""
        e = self.index.by_name.get(chrom)
        if e is None:
            raise KeyError(f"Requested chromosome {chrom} was not found in fasta")
        start = max(0, min(start, e.length))
        end = max(start, min(end, e.length))
        if end == start:
            return b""
        if self._cache_chrom != chrom or self._cache_upper is None:
            with trace.span(FASTA_SPAN):
                if self._cache_chrom != chrom and not self._fill(e, start,
                                                                 end):
                    return self._read_range(e, start, end).upper()
                with trace.span(UPPER_SPAN):
                    self._cache_upper = self._cache_seq.upper()
        return self._cache_upper[start:end]

    def fetch_spans_upper(self, chrom: str,
                          spans: Sequence[Tuple[int, int]]) -> bytes:
        """The bases of each [start, end) of `spans`, upper-cased, end to
        end in one bytes object: span k's begin at the sum of the earlier
        spans' lengths. Spans lie within the chromosome; an empty one
        reads nothing. One positioned read per span and one upper-case
        per call; the whole-chromosome cache is neither read nor
        filled."""
        e = self.index.by_name.get(chrom)
        if e is None:
            raise KeyError(f"Requested chromosome {chrom} was not found in fasta")
        with trace.span(FASTA_SPAN):
            parts = [self._read_range(e, a, b) for a, b in spans if b > a]
            trace.count("fasta.windows", len(parts))
            with trace.span(UPPER_SPAN):
                return b"".join(parts).upper()

    def _read_range(self, e: FaiEntry, start: int, end: int) -> bytes:
        """The bases [start, end) of e's sequence (0 <= start < end <=
        e.length): one positioned read of the file's bytes from the first
        base to the last, then the line ends stripped as the columns at or
        past linebases of a [lines, linewidth] view, its first line
        entered at the start's column."""
        lb, lw = e.linebases, e.linewidth
        first, col0 = divmod(start, lb)
        last, col1 = divmod(end - 1, lb)
        size = (last - first) * lw + col1 - col0 + 1
        at = e.offset + first * lw + col0
        if lw == lb:
            raw = os.pread(self._fh.fileno(), size, at)
            trace.count("fasta.bytes_read", len(raw))
            return raw
        rows = last - first + 1
        buf = np.empty(rows * lw, np.uint8)
        got = os.preadv(self._fh.fileno(),
                        [memoryview(buf)[col0:col0 + size]], at)
        trace.count("fasta.bytes_read", got)
        n = end - start
        if got < size:  # a file shorter than its index: the bases read
            full, rem = divmod(col0 + got, lw)
            n = full * lb + min(rem, lb) - col0
        bases = buf.reshape(rows, lw)[:, :lb].reshape(-1)
        return bases[col0:col0 + n].tobytes()
