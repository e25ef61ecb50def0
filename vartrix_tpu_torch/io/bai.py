"""BAI/CSI index parsing, the merged region plan, and index building.

Re-provides the part of htslib's index machinery the native path needs
(the reference fetches each variant's reads through bam::IndexedReader,
reference src/main.rs:822-826):

  * BAI: per-reference R-tree bins (5 levels, 16 kb leaves) of chunk lists
    in BGZF virtual offsets (coffset << 16 | uoffset), plus a 16 kb
    linear index; CSI: the same with any (min_shift, depth), BGZF-wrapped;
  * reg2bins candidate-bin enumeration;
  * one merged chunk plan over every variant window, which the native
    columnar loader decodes (io/bam_native.py ColumnarBam(chunks=)) and
    the Python record path streams (RegionStream over LazyBgzf, a
    random-access BGZF reader);
  * build_bai / build_csi, the `samtools index` capability, and its CLI:
    ``python -m vartrix_tpu_torch.io.bai FILE [...]``, which writes a .crai
    for a CRAM (io/cram.write_crai).
"""

from __future__ import annotations

import bisect
import os
import struct
import zlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

from .bam import (BamRecord, _decode_record, _header_end, bgzf_decompress,
                  parse_header)
from .bam_writer import _reg2bin, bgzf_compress


def reg2bins(beg: int, end: int) -> List[int]:
    """Candidate bins overlapping [beg, end), per the SAM spec."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def reg2bins_csi(beg: int, end: int, min_shift: int, depth: int) -> List[int]:
    """Candidate bins for a CSI index with arbitrary (min_shift, depth)."""
    end -= 1
    bins = []
    t, s = 0, min_shift + 3 * depth
    for level in range(depth + 1):
        bins.extend(range(t + (beg >> s), t + (end >> s) + 1))
        t += 1 << (3 * level)
        s -= 3
    return bins


def _merge_sorted(chunks: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sort chunks and merge the overlapping ones."""
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
        else:
            merged.append((cb, ce))
    return merged


class CsiIndex:
    """CSI (coordinate-sorted index) parser — the generalized-depth
    flavor of BAI (the reference accepts .csi in place of .bai,
    src/main.rs:523-529). BGZF-compressed; bins carry a loffset."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        data = bgzf_decompress(raw) if raw[:2] == b"\x1f\x8b" else raw
        if data[:4] != b"CSI\x01":
            raise ValueError(f"{path}: not a CSI index")
        self.min_shift, self.depth, l_aux = struct.unpack_from("<iii", data, 4)
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, _loffset, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bd[bin_id] = chunks
            self.bins.append(bd)

    def chunks_for_region(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if ref_id >= len(self.bins):
            return []
        bd = self.bins[ref_id]
        chunks = []
        for b in reg2bins_csi(beg, end, self.min_shift, self.depth):
            chunks.extend(bd.get(b, ()))
        return _merge_sorted(chunks)


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        # per ref: {bin_id: [(chunk_beg, chunk_end)]}, linear ioffsets
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.intervals: List[List[int]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bd[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.bins.append(bd)
            self.intervals.append(ioff)

    def chunks_for_region(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged candidate chunks (virtual-offset ranges) for a region,
        pruned by the linear index."""
        if ref_id >= len(self.bins):
            return []
        bd = self.bins[ref_id]
        intv = self.intervals[ref_id]
        min_off = 0
        iv = beg >> 14
        if iv < len(intv):
            min_off = intv[iv]
        chunks = []
        for b in reg2bins(beg, end):
            for cb, ce in bd.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        return _merge_sorted(chunks)


class LazyBgzf:
    """Random-access BGZF reader with an LRU block cache."""

    def __init__(self, path: str, cache_blocks: int = 64):
        self._f = open(path, "rb")
        self._cache: OrderedDict[int, Tuple[bytes, int]] = OrderedDict()
        self._cache_blocks = cache_blocks

    def close(self):
        self._f.close()

    def block(self, coffset: int) -> Tuple[bytes, int]:
        """-> (inflated payload, next block's coffset)."""
        hit = self._cache.get(coffset)
        if hit is not None:
            self._cache.move_to_end(coffset)
            return hit
        f = self._f
        f.seek(coffset)
        header = f.read(18)
        if len(header) < 18:
            return b"", coffset
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = header[12:] + f.read(xlen - 6) if xlen > 6 else header[12:12 + xlen]
        bsize = None
        xoff = 0
        while xoff + 4 <= len(extra):
            si1, si2 = extra[xoff], extra[xoff + 1]
            slen = struct.unpack_from("<H", extra, xoff + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, xoff + 4)[0] + 1
            xoff += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC subfield")
        cdata = f.read(bsize - 12 - xlen - 8)
        payload = zlib.decompress(cdata, wbits=-15)
        entry = (payload, coffset + bsize)
        self._cache[coffset] = entry
        if len(self._cache) > self._cache_blocks:
            self._cache.popitem(last=False)
        return entry

    def read_at(self, voffset: int, n: int) -> bytes:
        """Read n uncompressed bytes starting at a virtual offset."""
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        out = bytearray()
        while len(out) < n:
            payload, nxt = self.block(coffset)
            if not payload and nxt == coffset:
                break
            out += payload[uoffset : uoffset + (n - len(out))]
            coffset, uoffset = nxt, 0
        return bytes(out)


class IndexedBamReader:
    """BAM reader that fetches a region through its BAI/CSI index,
    inflating only the BGZF blocks the region's chunks touch."""

    def __init__(self, bam_path: str, bai_path: str | None = None):
        if bai_path is None:
            bai_path = bam_path + ".bai"
            if not os.path.exists(bai_path) and os.path.exists(bam_path + ".csi"):
                bai_path = bam_path + ".csi"
        if bai_path.endswith(".csi"):
            self.index: "BaiIndex | CsiIndex" = CsiIndex(bai_path)
        else:
            self.index = BaiIndex(bai_path)
        self._bgzf = LazyBgzf(bam_path)
        # the header from the stream's start, read until it is whole
        n = 1 << 16
        hdr = self._bgzf.read_at(0, n)
        while _header_end(hdr) < 0 and len(hdr) == n:
            n *= 2
            hdr = self._bgzf.read_at(0, n)
        self.ref_names, self.ref_lens, _ = parse_header(hdr, bam_path)
        self.tid_by_name = {nm: i for i, nm in enumerate(self.ref_names)}

    def close(self):
        self._bgzf.close()

    def _records_in_chunk(self, cb: int, ce: int) -> Iterator[BamRecord]:
        """Decode every record in the virtual-offset range [cb, ce)."""
        voff = cb
        while voff < ce:
            head = self._bgzf.read_at(voff, 4)
            if len(head) < 4:
                break
            bs = struct.unpack_from("<i", head, 0)[0]
            buf = self._bgzf.read_at(voff, 4 + bs)[4:]
            rec = _decode_record(buf)
            # advance the virtual offset past this record
            coffset, uoffset = voff >> 16, voff & 0xFFFF
            remaining = 4 + bs
            while remaining > 0:
                payload, nxt = self._bgzf.block(coffset)
                avail = len(payload) - uoffset
                if avail > remaining:
                    uoffset += remaining
                    remaining = 0
                else:
                    remaining -= avail
                    coffset, uoffset = nxt, 0
            voff = (coffset << 16) | uoffset
            yield rec

    def fetch(self, chrom: str, start: int, end: int) -> Iterator[BamRecord]:
        """Records overlapping [start, end) on chrom, in file order."""
        tid = self.tid_by_name.get(chrom)
        if tid is None:
            raise KeyError(f"chromosome {chrom} not in BAM header")
        for cb, ce in self.index.chunks_for_region(tid, start, end):
            for rec in self._records_in_chunk(cb, ce):
                if rec.tid != tid or rec.pos >= end:
                    if rec.tid > tid or (rec.tid == tid and rec.pos >= end):
                        break
                    continue
                if rec.endpos() > start:
                    yield rec


class RegionStream:
    """A BamReader-like record stream that decodes only the blocks of a
    merged chunk plan: the Python host path's region fetch (the native
    path's is ColumnarBam(chunks=))."""

    def __init__(self, bam_path: str, chunks):
        self._r = IndexedBamReader(bam_path)
        self._chunks = chunks
        self.ref_names = self._r.ref_names
        self.ref_lens = self._r.ref_lens
        self.tid_by_name = self._r.tid_by_name

    def close(self):
        self._r.close()

    def records(self) -> Iterator[BamRecord]:
        for cb, ce in self._chunks:
            yield from self._r._records_in_chunk(cb, ce)


def merge_chunk_lists(chunk_lists, gap_bytes: int = 16384):
    """Union of per-region chunk lists into a sorted, disjoint plan.

    Overlapping chunks merge; chunks whose compressed-offset gap is at most
    gap_bytes are bridged (the few extra records decoded in the gap are
    dropped by the position join downstream, and one contiguous read beats
    two seeks). This is the batched equivalent of the reference's
    per-variant fetch (reference src/main.rs:822-826)."""
    allc = sorted(c for lst in chunk_lists for c in lst)
    merged = []
    for cb, ce in allc:
        if merged:
            pb, pe = merged[-1]
            if cb <= pe or ((cb >> 16) - (pe >> 16)) <= gap_bytes:
                if ce > pe:
                    merged[-1] = (pb, ce)
                continue
        merged.append((cb, ce))
    return merged


def plan_region_fetch(bam_path: str, loci, tid_by_name):
    """Merged chunk plan for a set of (chrom, start, end) loci.

    Returns (chunks list[(vbeg, vend)], covered_fraction) where
    covered_fraction estimates the share of the compressed file the plan
    decodes (the driver's density heuristic input), or (None, 1.0) when no
    BAI/CSI index is readable."""
    bai, csi = bam_path + ".bai", bam_path + ".csi"
    try:
        if os.path.exists(bai):
            idx = BaiIndex(bai)
        elif os.path.exists(csi):
            idx = CsiIndex(csi)
        else:
            return None, 1.0
    except Exception:
        return None, 1.0
    lists = []
    for chrom, start, end in loci:
        tid = tid_by_name.get(chrom)
        if tid is None:
            continue  # validation rejects unknown chroms before this
        lists.append(idx.chunks_for_region(tid, start, end))
    merged = merge_chunk_lists(lists)
    # decoded compressed bytes ~= chunk spans + one trailing block each
    # (typical BGZF block is 10-25KB compressed; 16KB is a fair estimate)
    covered = sum(((ce >> 16) - (cb >> 16) + 16384) for cb, ce in merged)
    frac = covered / max(os.path.getsize(bam_path), 1)
    return merged, min(frac, 1.0)


def _bam_records(bam_path: str) -> Tuple[int, Iterator[Tuple[int, int, int, int, int]]]:
    """(n_ref, records) of a BAM file read whole: each record as (vbeg,
    vend, tid, pos, ref_len), its virtual-offset span from the physical
    BGZF blocks and its aligned reference length from the CIGAR."""
    with open(bam_path, "rb") as f:
        raw = f.read()
    # walk physical blocks, recording (file_offset, uncompressed_offset)
    blk_file_off = []
    blk_u_off = []
    pos = 0
    total = 0
    while pos + 28 <= len(raw):
        if not (raw[pos] == 0x1F and raw[pos + 1] == 0x8B):
            raise ValueError(f"{bam_path}: not BGZF at {pos}")
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        xoff, xend = pos + 12, pos + 12 + xlen
        bsize = None
        while xoff + 4 <= xend:
            slen = struct.unpack_from("<H", raw, xoff + 2)[0]
            if raw[xoff] == 66 and raw[xoff + 1] == 67 and slen == 2:
                bsize = struct.unpack_from("<H", raw, xoff + 4)[0] + 1
            xoff += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC subfield")
        isize = struct.unpack_from("<I", raw, pos + bsize - 4)[0]
        blk_file_off.append(pos)
        blk_u_off.append(total)
        total += isize
        pos += bsize
    data = bgzf_decompress(raw)
    del raw

    def voff(u: int) -> int:
        # the block containing uncompressed offset u
        i = bisect.bisect_right(blk_u_off, u) - 1
        return (blk_file_off[i] << 16) | (u - blk_u_off[i])

    if data[:4] != b"BAM\x01":
        raise ValueError(f"{bam_path}: not a BAM stream")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 8 + l_name

    def records(off=off):
        n = len(data)
        while off + 4 <= n:
            bs = struct.unpack_from("<i", data, off)[0]
            if bs <= 0 or off + 4 + bs > n:
                break
            vbeg, vend = voff(off), voff(off + 4 + bs)
            tid, p0 = struct.unpack_from("<ii", data, off + 4)
            l_read_name = data[off + 4 + 8]
            n_cigar = struct.unpack_from("<H", data, off + 4 + 12)[0]
            coff = off + 4 + 32 + l_read_name
            ref_len = 0
            for k in range(n_cigar):
                v = struct.unpack_from("<I", data, coff + 4 * k)[0]
                if (v & 0xF) in (0, 2, 3, 7, 8):
                    ref_len += v >> 4
            off += 4 + bs
            yield vbeg, vend, tid, p0, ref_len

    return n_ref, records()


def _add_chunk(bins: Dict[int, List[Tuple[int, int]]], b: int,
               vbeg: int, vend: int) -> None:
    chunks = bins.setdefault(b, [])
    if chunks and chunks[-1][1] == vbeg:
        chunks[-1] = (chunks[-1][0], vend)
    else:
        chunks.append((vbeg, vend))


def build_bai(bam_path: str, bai_path: str | None = None) -> str:
    """Build a .bai for an arbitrary existing BAM (the `samtools index`
    capability): stream the BGZF blocks once, track every record's virtual
    offset and (tid, pos, end) from its fixed header + CIGAR, and emit
    bins/chunks plus the 16kb linear index."""
    n_ref, records = _bam_records(bam_path)
    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    intervals: List[List[int]] = [[] for _ in range(n_ref)]
    for vbeg, vend, tid, p0, ref_len in records:
        if tid < 0 or tid >= n_ref:
            continue
        end = p0 + max(ref_len, 1)
        _add_chunk(bins[tid], _reg2bin(p0, end), vbeg, vend)
        iv = intervals[tid]
        for w in range(p0 >> 14, ((end - 1) >> 14) + 1):
            while len(iv) <= w:
                iv.append(0)
            if iv[w] == 0 or vbeg < iv[w]:
                iv[w] = vbeg
    parts = [b"BAI\x01", struct.pack("<i", n_ref)]
    for tid in range(n_ref):
        bd = bins[tid]
        parts.append(struct.pack("<i", len(bd)))
        for b in sorted(bd):
            chunks = bd[b]
            parts.append(struct.pack("<Ii", b, len(chunks)))
            for cb, ce in chunks:
                parts.append(struct.pack("<QQ", cb, ce))
        iv = intervals[tid]
        # fill linear-index gaps with the previous value (htslib practice)
        last = 0
        for w in range(len(iv)):
            if iv[w] == 0:
                iv[w] = last
            else:
                last = iv[w]
        parts.append(struct.pack("<i", len(iv)))
        for v in iv:
            parts.append(struct.pack("<Q", v))
    bai_path = bai_path or bam_path + ".bai"
    with open(bai_path, "wb") as f:
        f.write(b"".join(parts))
    return bai_path


def build_csi(bam_path: str, csi_path: str | None = None,
              min_shift: int = 14, depth: int = 6) -> str:
    """Build a .csi for an existing BAM. With the default depth 6 the
    index covers positions up to 2^(14+3*6) = 2^32 — chromosomes longer
    than BAI's 2^29 limit (the spec corner the reference inherits from
    htslib: such BAMs are CSI-only). Layout mirrors htslib: BGZF-wrapped
    "CSI\\x01", per-bin loffset, chunks, no linear index."""

    def reg2bin_csi(beg: int, end: int) -> int:
        end -= 1
        l = depth
        s = min_shift
        t = ((1 << depth * 3) - 1) // 7
        while l > 0:
            if beg >> s == end >> s:
                return t + (beg >> s)
            s += 3
            t -= 1 << ((l - 1) * 3)
            l -= 1
        return 0

    n_ref, records = _bam_records(bam_path)
    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    loffs: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    for vbeg, vend, tid, p0, ref_len in records:
        if tid < 0 or tid >= n_ref or p0 < 0:
            continue
        end = p0 + max(ref_len, 1)
        b = reg2bin_csi(p0, end)
        _add_chunk(bins[tid], b, vbeg, vend)
        if b not in loffs[tid] or vbeg < loffs[tid][b]:
            loffs[tid][b] = vbeg
    parts = [b"CSI\x01", struct.pack("<iii", min_shift, depth, 0),
             struct.pack("<i", n_ref)]
    for tid in range(n_ref):
        bd = bins[tid]
        parts.append(struct.pack("<i", len(bd)))
        for b in sorted(bd):
            chunks = bd[b]
            parts.append(struct.pack("<IQi", b, loffs[tid][b], len(chunks)))
            for cb, ce in chunks:
                parts.append(struct.pack("<QQ", cb, ce))
    csi_path = csi_path or bam_path + ".csi"
    with open(csi_path, "wb") as f:
        f.write(bgzf_compress(b"".join(parts)))
    return csi_path


def index_main(argv=None) -> None:
    """CLI: python -m vartrix_tpu_torch.io.bai FILE [...] — builds a .bai
    for each BAM and a .crai for each CRAM (told apart by content), like
    `samtools index`."""
    import argparse

    p = argparse.ArgumentParser(
        prog="vartrix-index",
        description="Build a BAI (BAM) or CRAI (CRAM) index")
    p.add_argument("files", nargs="+", help="BAM/CRAM files to index")
    p.add_argument("-f", "--fasta", default=None,
                   help="Reference FASTA (CRAM with reference-based "
                        "compression only)")
    args = p.parse_args(argv)
    for path in args.files:
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"CRAM":
            from .cram import write_crai
            out = write_crai(path, fasta_path=args.fasta)
        else:
            out = build_bai(path)
        print(f"{path} -> {out}")


if __name__ == "__main__":
    index_main()
