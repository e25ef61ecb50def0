"""BAM reading: BGZF inflate, the header, and the Python record path.

BamHeader inflates BGZF blocks only until the whole header (magic, SAM
text, reference list) is in hand: the names and lengths input validation
checks the VCF against. The native path decodes records with the columnar
decoder (io/bam_native.py). The Python host path (--host python) and the
CRAM codec (io/cram.py) decode them here: BamRecord (pos, mapq, flag,
CIGAR, packed SEQ, aux tags), with htslib's overlap semantics (rec.pos <
end and endpos(rec) > start; endpos = pos + ref-consumed CIGAR length, or
pos + 1 when nothing is ref-consuming), and BamReader over a whole file.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Tuple

SEQ_NT16 = b"=ACMGRSVTWYHKDBN"

_REF_CONSUMING = (0, 2, 3, 7, 8)  # CIGAR M D N = X

FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


def bgzf_decompress(data: bytes, stop_after: int = 0) -> bytes:
    """Inflate a BGZF byte stream (a series of gzip members). With
    stop_after > 0, stop once at least that many bytes are inflated."""
    out = []
    got = 0
    pos = 0
    n = len(data)
    while pos < n:
        if stop_after and got >= stop_after:
            break
        if n - pos >= 28 and data[pos : pos + 4] == b"\x1f\x8b\x08\x04":
            xlen = struct.unpack_from("<H", data, pos + 10)[0]
            # scan extra subfields for BC (BGZF block size)
            bsize = None
            xoff = pos + 12
            xend = xoff + xlen
            while xoff + 4 <= xend:
                si1, si2 = data[xoff], data[xoff + 1]
                slen = struct.unpack_from("<H", data, xoff + 2)[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", data, xoff + 4)[0] + 1
                xoff += 4 + slen
            if bsize is None:
                raise ValueError("gzip member without BGZF BC subfield")
            out.append(zlib.decompress(data[xend : pos + bsize - 8],
                                       wbits=-15))
            got += len(out[-1])
            pos += bsize
        else:
            # plain gzip
            d = zlib.decompressobj(wbits=31)
            out.append(d.decompress(data[pos:]))
            got += len(out[-1])
            pos = n - len(d.unused_data)
            if not d.eof:
                break
    return b"".join(out)


def _header_end(data: bytes) -> int:
    """Byte length of the complete header in `data`, or -1 if truncated."""
    if len(data) < 12:
        return -1
    l_text = struct.unpack_from("<i", data, 4)[0]
    if l_text < 0 or len(data) < 12 + l_text:
        return -1
    n_ref = struct.unpack_from("<i", data, 8 + l_text)[0]
    end = 12 + l_text
    for _ in range(max(n_ref, 0)):
        if len(data) < end + 8:
            return -1
        end += 8 + struct.unpack_from("<i", data, end)[0]
    return end if len(data) >= end else -1


def parse_header(data: bytes, path: str) -> Tuple[List[str], List[int], int]:
    """(reference names, lengths, offset of the first record) of an
    inflated BAM stream; raises ValueError when it is not one or its header
    is cut short."""
    if data[:4] != b"BAM\x01" or _header_end(data) < 0:
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    names: List[str] = []
    lens: List[int] = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        names.append(data[off + 4 : off + 4 + l_name - 1].decode())
        lens.append(struct.unpack_from("<i", data, off + 4 + l_name)[0])
        off += 8 + l_name
    return names, lens, off


class BamHeader:
    """Reference names and lengths of a BAM file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        need = 12
        data = bgzf_decompress(raw, stop_after=need)
        while _header_end(data) < 0:
            need = max(need * 4, len(data) + 1)
            grown = bgzf_decompress(raw, stop_after=need)
            if len(grown) <= len(data):
                break  # whole file inflated; parse_header reports it
            data = grown
        self._set_header(data, path)

    def _set_header(self, data: bytes, path: str) -> int:
        self.ref_names, self.ref_lens, off = parse_header(data, path)
        self.tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
        return off


class BamRecord:
    __slots__ = (
        "tid", "pos", "mapq", "flag", "cigar", "_buf", "_seq_off", "l_seq",
        "_aux_off", "_name_off", "_name_len",
    )

    def __init__(self, buf: bytes, tid: int, pos: int, mapq: int, flag: int,
                 cigar: List[Tuple[int, int]], seq_off: int, l_seq: int,
                 aux_off: int, name_off: int, name_len: int):
        self._buf = buf
        self.tid = tid
        self.pos = pos
        self.mapq = mapq
        self.flag = flag
        self.cigar = cigar
        self._seq_off = seq_off
        self.l_seq = l_seq
        self._aux_off = aux_off
        self._name_off = name_off
        self._name_len = name_len

    @property
    def qname(self) -> bytes:
        return self._buf[self._name_off : self._name_off + self._name_len]

    def seq_bytes(self) -> bytes:
        """Decoded sequence, uppercase nucleotide characters (like
        rust-htslib rec.seq().as_bytes())."""
        packed = self._buf[self._seq_off : self._seq_off + (self.l_seq + 1) // 2]
        out = bytearray(self.l_seq)
        for i in range(self.l_seq):
            b = packed[i >> 1]
            nib = (b >> 4) if (i & 1) == 0 else (b & 0xF)
            out[i] = SEQ_NT16[nib]
        return bytes(out)

    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    def is_duplicate(self) -> bool:
        return bool(self.flag & FLAG_DUP)

    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    def aux_string(self, tag: bytes) -> Optional[bytes]:
        """Value of a Z-type aux tag, or None (the reference accepts
        Aux::String only, src/main.rs:737-757)."""
        buf, off, end = self._buf, self._aux_off, len(self._buf)
        while off + 3 <= end:
            t = buf[off : off + 2]
            typ = buf[off + 2 : off + 3]
            off += 3
            if typ in (b"Z", b"H"):
                nul = buf.index(b"\x00", off)
                if t == tag and typ == b"Z":
                    return buf[off:nul]
                off = nul + 1
            elif typ == b"A" or typ == b"c" or typ == b"C":
                off += 1
            elif typ == b"s" or typ == b"S":
                off += 2
            elif typ in (b"i", b"I", b"f"):
                off += 4
            elif typ == b"B":
                sub = buf[off : off + 1]
                cnt = struct.unpack_from("<i", buf, off + 1)[0]
                size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[sub]
                off += 5 + cnt * size
            else:
                raise ValueError(f"unknown aux type {typ!r}")
        return None

    def ref_len(self) -> int:
        """Reference bases consumed by the alignment."""
        return sum(l for op, l in self.cigar if op in _REF_CONSUMING)

    def endpos(self) -> int:
        """htslib bam_endpos: pos + ref_len, or pos+1 if nothing consumed."""
        rl = self.ref_len()
        return self.pos + rl if rl > 0 else self.pos + 1

    def aligned_ref_intervals(self, include_dels: bool = True):
        """Ref-coordinate intervals covered by aligned bases (M/=/X; D when
        include_dels). N (ref-skip) and soft clips never count: the
        semantics of rust-htslib read_pos(.., false, true) used by the
        reference's useful_alignment (src/main.rs:790-806)."""
        r = self.pos
        for op, l in self.cigar:
            if op in (0, 7, 8):  # M = X
                yield (r, r + l)
                r += l
            elif op == 2:  # D
                if include_dels:
                    yield (r, r + l)
                r += l
            elif op == 3:  # N
                r += l


def _find_cg_cigar(buf: bytes, off: int) -> Optional[List[Tuple[int, int]]]:
    """Real CIGAR from a CG:B,I aux tag (BAM long-CIGAR convention for
    records with > 65535 ops: the in-record cigar is a kSmN placeholder
    and the true ops live in CG)."""
    end = len(buf)
    while off + 3 <= end:
        t = buf[off : off + 2]
        typ = buf[off + 2 : off + 3]
        off += 3
        if typ in (b"Z", b"H"):
            off = buf.index(b"\x00", off) + 1
        elif typ in (b"A", b"c", b"C"):
            off += 1
        elif typ in (b"s", b"S"):
            off += 2
        elif typ in (b"i", b"I", b"f"):
            off += 4
        elif typ == b"B":
            sub = buf[off : off + 1]
            cnt = struct.unpack_from("<i", buf, off + 1)[0]
            size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2,
                    b"i": 4, b"I": 4, b"f": 4}[sub]
            if t == b"CG" and sub == b"I":
                vals = struct.unpack_from(f"<{cnt}I", buf, off + 5)
                return [(v & 0xF, v >> 4) for v in vals]
            off += 5 + cnt * size
        else:
            return None
    return None


def _decode_record(buf: bytes) -> BamRecord:
    (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_refid, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    name_off, name_len = off, l_read_name - 1  # exclude trailing NUL
    off += l_read_name
    cigar = []
    for k in range(n_cigar):
        v = struct.unpack_from("<I", buf, off + 4 * k)[0]
        cigar.append((v & 0xF, v >> 4))
    off += 4 * n_cigar
    seq_off = off
    off += (l_seq + 1) // 2
    off += l_seq  # qual
    if (n_cigar == 2 and l_seq > 0 and cigar[0] == (4, l_seq)
            and cigar[1][0] == 3):
        # kSmN placeholder: the true CIGAR is in the CG:B,I tag (htslib's
        # long-CIGAR convention, which the reference inherits)
        real = _find_cg_cigar(buf, off)
        if real is not None:
            cigar = real
    return BamRecord(buf, refid, pos, mapq, flag, cigar, seq_off, l_seq,
                     off, name_off, name_len)


class BamReader(BamHeader):
    """Whole-file BAM reader (inflates the file into memory) yielding
    BamRecords: the Python host path's record source."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] == b"CRAM":
            raise ValueError(f"{path}: is a CRAM file; BamReader decodes BAM "
                             "only (io/cram.CramReader reads CRAM)")
        self._data = bgzf_decompress(raw)
        self._records_off = self._set_header(self._data, path)

    def records(self) -> Iterator[BamRecord]:
        data = self._data
        off = self._records_off
        n = len(data)
        while off + 4 <= n:
            bs = struct.unpack_from("<i", data, off)[0]
            yield _decode_record(data[off + 4 : off + 4 + bs])
            off += 4 + bs

    def fetch(self, chrom: str, start: int, end: int) -> Iterator[BamRecord]:
        """Records overlapping 0-based half-open [start, end) on chrom, in
        file order (htslib overlap semantics)."""
        tid = self.tid_by_name.get(chrom)
        if tid is None:
            raise KeyError(f"chromosome {chrom} not in BAM header")
        for rec in self.records():
            if rec.tid != tid:
                continue
            if rec.pos < end and rec.endpos() > start:
                yield rec
