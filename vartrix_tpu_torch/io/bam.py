"""BAM header reading: the reference sequence names and lengths that input
validation checks the VCF against.

Inflates BGZF blocks only until the whole header (magic, SAM text, reference
list) is in hand; records are decoded by the native columnar decoder
(io/bam_native.py).
"""

from __future__ import annotations

import struct
import zlib
from typing import List


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
                break  # whole file inflated; the checks below report it
            data = grown
        if data[:4] != b"BAM\x01" or _header_end(data) < 0:
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            self.ref_names.append(data[off + 4 : off + 4 + l_name - 1].decode())
            self.ref_lens.append(
                struct.unpack_from("<i", data, off + 4 + l_name)[0])
            off += 8 + l_name
        self.tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
