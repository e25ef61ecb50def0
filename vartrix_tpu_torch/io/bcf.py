"""BCF2 binary VCF reading (and writing, for tests/tooling).

Covers what the reference consumes through htslib's bcf::Reader
(reference src/main.rs:221-234,615-623): record iteration with
rid->contig-name resolution, 0-based positions, and allele lists. INFO,
FILTER, and FORMAT fields are skipped structurally (typed-value walking)
but not decoded — the engine doesn't use them.

Format: BGZF-compressed "BCF\\2\\x02" stream; records carry typed values
(descriptor byte: low 4 bits = type {1:int8, 2:int16, 3:int32, 5:float,
7:char}, high 4 bits = length, 15 = overflow length as a following typed
scalar).
"""

from __future__ import annotations

import struct
from typing import List

from .bam import bgzf_decompress
from .vcf import VcfRecord

_TYPE_SIZES = {0: 0, 1: 1, 2: 2, 3: 4, 5: 4, 7: 1}


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def _typed_descriptor(self):
        d = self.buf[self.off]
        self.off += 1
        typ = d & 0xF
        length = d >> 4
        if length == 15:
            length = self._typed_int()
        return typ, length

    def _typed_int(self) -> int:
        typ, length = self._typed_descriptor()
        assert typ in (1, 2, 3) and length == 1, "expected typed scalar int"
        return self._read_int(typ)

    def _read_int(self, typ: int) -> int:
        if typ == 1:
            v = struct.unpack_from("<b", self.buf, self.off)[0]
        elif typ == 2:
            v = struct.unpack_from("<h", self.buf, self.off)[0]
        else:
            v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += _TYPE_SIZES[typ]
        return v

    def typed_string(self) -> bytes:
        typ, length = self._typed_descriptor()
        assert typ in (0, 7), f"expected char vector, got type {typ}"
        s = self.buf[self.off : self.off + length]
        self.off += length
        return s

    def skip_typed(self) -> None:
        typ, length = self._typed_descriptor()
        self.off += _TYPE_SIZES[typ] * length


def _parse_contigs(header_text: str) -> List[str]:
    """Contig names ordered by IDX (explicit ##contig IDX= or declaration
    order), which defines the rid -> name mapping."""
    contigs = []
    for line in header_text.splitlines():
        if not line.startswith("##contig=<"):
            continue
        body = line[len("##contig=<"):].rstrip(">")
        fields = {}
        for part in body.split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                fields[k] = v
        name = fields.get("ID")
        idx = int(fields["IDX"]) if "IDX" in fields else len(contigs)
        contigs.append((idx, name))
    contigs.sort()
    return [name for _, name in contigs]


def read_bcf_records(path: str) -> List[VcfRecord]:
    with open(path, "rb") as f:
        raw = f.read()
    data = bgzf_decompress(raw)
    if data[:3] != b"BCF":
        raise ValueError(f"{path}: not a BCF file")
    l_text = struct.unpack_from("<I", data, 5)[0]
    header_text = data[9 : 9 + l_text].rstrip(b"\x00").decode()
    contigs = _parse_contigs(header_text)
    off = 9 + l_text
    out: List[VcfRecord] = []
    n = len(data)
    while off + 8 <= n:
        l_shared, l_indiv = struct.unpack_from("<II", data, off)
        rec_start = off + 8
        c = _Cursor(data, rec_start)
        rid, pos, _rlen = struct.unpack_from("<iii", data, c.off)
        c.off += 12
        c.off += 4  # qual (float)
        n_info, n_allele = struct.unpack_from("<HH", data, c.off)
        c.off += 4
        c.off += 4  # n_fmt << 24 | n_sample
        c.skip_typed()  # ID
        alleles = [c.typed_string() for _ in range(n_allele)]
        if not alleles:
            raise ValueError("BCF record without alleles")
        ref = alleles[0]
        alts = [a for a in alleles[1:]]
        out.append(VcfRecord(
            chrom=contigs[rid], pos=pos, ref=ref, alts=alts))
        off = rec_start + l_shared + l_indiv
    return out


def write_bcf(path: str, contigs: List[tuple], records: List[VcfRecord]) -> None:
    """Minimal BCF writer (tests and chip_smoke.py turn a dataset's VCF
    into BCF with it). contigs: [(name, length)]."""
    from .bam_writer import bgzf_compress

    header_lines = ["##fileformat=VCFv4.2"]
    for i, (name, length) in enumerate(contigs):
        header_lines.append(f"##contig=<ID={name},length={length},IDX={i}>")
    header_lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
    text = ("\n".join(header_lines) + "\n").encode() + b"\x00"
    rid_by_name = {name: i for i, (name, _) in enumerate(contigs)}

    def typed_string(s: bytes) -> bytes:
        if len(s) < 15:
            return bytes([(len(s) << 4) | 7]) + s
        return bytes([0xF7, 0x13]) + struct.pack("<i", len(s)) + s

    body = b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
    for rec in records:
        alleles = rec.alleles
        shared = struct.pack("<iii", rid_by_name[rec.chrom], rec.pos,
                             len(rec.ref))
        shared += struct.pack("<f", float("nan"))  # QUAL missing
        shared += struct.pack("<HH", 0, len(alleles))  # n_info, n_allele
        shared += struct.pack("<I", 0)  # n_fmt<<24 | n_sample
        shared += b"\x07"  # ID: empty char vector
        for a in alleles:
            shared += typed_string(a)
        shared += b"\x00"  # FILTER: empty vector (type 0, len 0)
        body += struct.pack("<II", len(shared), 0) + shared
    with open(path, "wb") as f:
        f.write(bgzf_compress(body))
