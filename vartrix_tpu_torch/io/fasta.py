"""Indexed FASTA (.fai) reader.

Equivalent capability to the reference's `bio::io::fasta::IndexedReader`
(used at reference src/main.rs:661,936-954): random access fetch of
[start, end) 0-based half-open subsequences via the samtools .fai index.

Reads from the file, the whole-chromosome cache fill among them, run in
the recorder's span "vartrix::haplotypes.fasta" (utils/trace), the cached
chromosome's upper-case in its child "vartrix::haplotypes.upper"; the
counters fasta.bytes_read (bytes read from the file, line ends included)
and fasta.chrom_fills count the reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

from ..utils import trace

FASTA_SPAN = "vartrix::haplotypes.fasta"


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

        Single-chrom cache: haplotype construction fetches 3 windows per
        variant and VCFs are chrom-sorted, so caching the CURRENT
        chromosome as raw bytes turns 100k-variant cohorts' fetch cost
        from ~2s of seek+read+strip into pure slicing. One chromosome
        resident at a time (~250MB worst case on human chr1)."""
        chrom = e.name
        self._miss_counts[chrom] = self._miss_counts.get(chrom, 0) + 1
        # Interleaved-chrom pattern (this chrom already filled the cache
        # once and was evicted): a small request goes through the windowed
        # read instead of re-reading the whole chromosome again, keeping
        # I/O O(request) rather than O(switches x chrom_len). The
        # chrom-sorted haplotype path misses each chrom exactly once and
        # is unaffected.
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
                with trace.span("vartrix::haplotypes.upper"):
                    self._cache_upper = self._cache_seq.upper()
        return self._cache_upper[start:end]

    def _read_range(self, e, start: int, end: int) -> bytes:
        line_full, line_blen = e.linebases, e.linewidth
        first_line = start // line_full
        last_line = (end - 1) // line_full
        f_off = e.offset + first_line * line_blen + (start - first_line * line_full)
        l_off = e.offset + last_line * line_blen + ((end - 1) - last_line * line_full)
        self._fh.seek(f_off)
        raw = self._fh.read(l_off - f_off + 1)
        trace.count("fasta.bytes_read", len(raw))
        # strip line terminators (anything beyond the per-line base count)
        if line_blen == line_full:
            return raw
        n = end - start
        if start % line_full == 0:
            # line-aligned read (the whole-chromosome cache fill):
            # vectorized strip via a [rows, line_blen] view
            import numpy as np
            full_rows = len(raw) // line_blen
            arr = np.frombuffer(raw[: full_rows * line_blen], np.uint8)
            body = arr.reshape(full_rows, line_blen)[:, :line_full].tobytes()
            tail = raw[full_rows * line_blen :][:line_full]
            return (body + tail)[:n]
        out = bytearray()
        pos = start
        i = 0
        while len(out) < n:
            line_rem = line_full - (pos % line_full)
            take = min(line_rem, n - len(out))
            out += raw[i : i + take]
            i += take + (line_blen - line_full)  # skip terminator bytes
            pos += take
        return bytes(out)
