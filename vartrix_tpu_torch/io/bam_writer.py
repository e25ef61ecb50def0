"""BAM writing: BGZF compression + record encoding.

Used by the synthetic-workload generator (benchmarks, large-scale tests)
and for round-trip testing of the reader. Produces standard BGZF/BAM that
htslib-based tools can read, including the BGZF EOF marker block.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

SEQ_NT16_IDX = {c: i for i, c in enumerate(b"=ACMGRSVTWYHKDBN")}
CIGAR_OP_IDX = {c: i for i, c in enumerate("MIDNSHP=X")}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """Compress into BGZF blocks (<=~64KB payload each) + EOF block."""
    out = []
    step = 0xFF00
    for i in range(0, len(data), step) or [0]:
        chunk = data[i : i + step]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        out.append(header + cdata + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    if not data:
        out = []
    out.append(BGZF_EOF)
    return b"".join(out)


def encode_record(
    qname: bytes,
    flag: int,
    tid: int,
    pos: int,
    mapq: int,
    cigar: Sequence[Tuple[int, int]],
    seq: bytes,
    qual: Optional[bytes] = None,
    tags: Sequence[Tuple[bytes, bytes]] = (),
) -> bytes:
    """Encode one alignment record (without the leading block_size field).
    tags: (2-byte tag, Z-string value) pairs."""
    l_seq = len(seq)
    packed = bytearray((l_seq + 1) // 2)
    for i, c in enumerate(seq):
        nib = SEQ_NT16_IDX.get(c, 15)
        if i % 2 == 0:
            packed[i // 2] |= nib << 4
        else:
            packed[i // 2] |= nib
    if qual is None:
        qual = bytes([30]) * l_seq
    ref_consumed = sum(l for op, l in cigar if op in (0, 2, 3, 7, 8))
    end = pos + max(ref_consumed, 1)
    # reg2bin from the SAM spec
    def reg2bin(b, e):
        e -= 1
        if b >> 14 == e >> 14:
            return ((1 << 15) - 1) // 7 + (b >> 14)
        if b >> 17 == e >> 17:
            return ((1 << 12) - 1) // 7 + (b >> 17)
        if b >> 20 == e >> 20:
            return ((1 << 9) - 1) // 7 + (b >> 20)
        if b >> 23 == e >> 23:
            return ((1 << 6) - 1) // 7 + (b >> 23)
        if b >> 26 == e >> 26:
            return ((1 << 3) - 1) // 7 + (b >> 26)
        return 0

    cg_tag = b""
    rec_cigar = list(cigar)
    if len(rec_cigar) > 0xFFFF:
        # BAM long-CIGAR convention: in-record placeholder kSmN, true
        # ops in a CG:B,I aux tag (htslib behavior for >65535 ops)
        cg_tag = b"CGBI" + struct.pack("<i", len(rec_cigar))
        for op, l in rec_cigar:
            cg_tag += struct.pack("<I", (l << 4) | op)
        rec_cigar = [(4, l_seq), (3, max(ref_consumed, 0))]
    body = struct.pack(
        "<iiBBHHHiiii",
        tid, pos, len(qname) + 1, mapq, reg2bin(pos, end),
        len(rec_cigar), flag, l_seq, -1, -1, 0,
    )
    body += qname + b"\x00"
    for op, l in rec_cigar:
        body += struct.pack("<I", (l << 4) | op)
    body += bytes(packed) + qual
    for tag, val in tags:
        body += tag + b"Z" + val + b"\x00"
    body += cg_tag
    return struct.pack("<i", len(body)) + body


def _rec_span(rec: bytes) -> Tuple[int, int, int]:
    """(tid, pos, end) of an encoded record (end = pos + ref-consumed
    CIGAR length, min 1 — htslib placement semantics)."""
    tid, pos = struct.unpack_from("<ii", rec, 4)
    l_read_name = rec[4 + 8]
    n_cigar = struct.unpack_from("<H", rec, 4 + 12)[0]
    off = 4 + 32 + l_read_name
    ref_len = 0
    for k in range(n_cigar):
        v = struct.unpack_from("<I", rec, off + 4 * k)[0]
        if (v & 0xF) in (0, 2, 3, 7, 8):
            ref_len += v >> 4
    return tid, pos, pos + max(ref_len, 1)


def _reg2bin(b: int, e: int) -> int:
    e -= 1
    if b >> 14 == e >> 14:
        return ((1 << 15) - 1) // 7 + (b >> 14)
    if b >> 17 == e >> 17:
        return ((1 << 12) - 1) // 7 + (b >> 17)
    if b >> 20 == e >> 20:
        return ((1 << 9) - 1) // 7 + (b >> 20)
    if b >> 23 == e >> 23:
        return ((1 << 6) - 1) // 7 + (b >> 23)
    if b >> 26 == e >> 26:
        return ((1 << 3) - 1) // 7 + (b >> 26)
    return 0


def write_bam(
    path: str,
    refs: List[Tuple[str, int]],
    records: Iterable[bytes],
    write_index: bool = True,
) -> None:
    """records: pre-encoded via encode_record, in coordinate order.
    Writes a REAL .bai alongside (bins + chunks + 16kb linear index) so
    the indexed region-fetch path works on generated files exactly as on
    htslib-indexed ones."""
    header_text = (
        b"@HD\tVN:1.6\tSO:coordinate\n"
        + b"".join(f"@SQ\tSN:{n}\tLN:{l}\n".encode() for n, l in refs)
    )
    head = b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
    head += struct.pack("<i", len(refs))
    for name, length in refs:
        nb = name.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    recs = list(records)
    stream = head + b"".join(recs)

    # compress, tracking each block's compressed offset
    step = 0xFF00
    out = []
    block_coff = []  # compressed offset of block holding stream[i*step:]
    csum = 0
    for i in range(0, len(stream), step) or [0]:
        chunk = stream[i : i + step]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        block = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
            + cdata + struct.pack("<II", zlib.crc32(chunk), len(chunk))
        )
        block_coff.append(csum)
        out.append(block)
        csum += len(block)
    if not stream:
        out, block_coff = [], [0]
    eof_coff = csum
    out.append(BGZF_EOF)
    with open(path, "wb") as f:
        f.write(b"".join(out))
    if not write_index:
        return

    def voff(u: int) -> int:
        if u >= len(stream):
            return eof_coff << 16
        return (block_coff[u // step] << 16) | (u % step)

    # per-ref bins {bin: [(vbeg, vend)]} and 16kb linear index
    bins: List[dict] = [dict() for _ in refs]
    intervals: List[List[int]] = [[] for _ in refs]
    u = len(head)
    for rec in recs:
        vbeg, vend = voff(u), voff(u + len(rec))
        u += len(rec)
        tid, pos, end = _rec_span(rec)
        if tid < 0 or tid >= len(refs):
            continue
        b = _reg2bin(pos, end)
        chunks = bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        iv = intervals[tid]
        for w in range(pos >> 14, ((end - 1) >> 14) + 1):
            while len(iv) <= w:
                iv.append(0)
            if iv[w] == 0 or vbeg < iv[w]:
                iv[w] = vbeg
    parts = [b"BAI\x01", struct.pack("<i", len(refs))]
    for tid in range(len(refs)):
        bd = bins[tid]
        parts.append(struct.pack("<i", len(bd)))
        for b in sorted(bd):
            chunks = bd[b]
            parts.append(struct.pack("<Ii", b, len(chunks)))
            for cb, ce in chunks:
                parts.append(struct.pack("<QQ", cb, ce))
        iv = intervals[tid]
        # fill linear-index gaps with the previous value (htslib practice;
        # improves min-offset pruning for empty windows)
        last = 0
        for w in range(len(iv)):
            if iv[w] == 0:
                iv[w] = last
            else:
                last = iv[w]
        parts.append(struct.pack("<i", len(iv)))
        for v in iv:
            parts.append(struct.pack("<Q", v))
    with open(path + ".bai", "wb") as f:
        f.write(b"".join(parts))
