"""Input kind "bam": writes a generated dataset (inputs/synth.py) as the
files a VarTrix run reads: the genome as FASTA with its .fai, the variants
as a VCF, the barcodes, and the reads as a coordinate-sorted BAM with its
.bai.

The BAM and .bai are byte for byte what the port's `io/bam_writer.write_bam`
writes for the same records (BGZF blocks of 0xFF00 bytes at zlib level 6,
bins, chunks and a 16 kb linear index; the tests hold them equal), built
here in bulk: records are laid out as rows of a byte matrix, the blocks
compressed on threads (zlib releases the interpreter lock), and the index
computed over arrays.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .synth import UMI_LEN, Dataset

BLOCK = 0xFF00
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
QNAME_DIGITS = 9
QUAL = 30

_NT16 = np.full(256, 15, np.uint8)
_NT16[np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)] = np.arange(16)


def write_fasta(ds: Dataset, path: str) -> None:
    """60 bases a line, and the .fai beside it."""
    width = 60
    clen = ds.chrom_len
    rows = -(-clen // width)
    offset = 0
    with open(path, "wb") as f, open(path + ".fai", "wt") as fai:
        for name, g in zip(ds.chroms, ds.genome):
            hdr = f">{name}\n".encode()
            f.write(hdr)
            offset += len(hdr)
            m = np.full((rows, width + 1), ord("\n"), np.uint8)
            flat = np.zeros(rows * width, np.uint8)
            flat[:clen] = g
            m[:, :width] = flat.reshape(rows, width)
            body = m.reshape(-1)
            last = clen - (rows - 1) * width  # bases on the last line
            f.write(body[: (rows - 1) * (width + 1) + last].tobytes() + b"\n")
            fai.write(f"{name}\t{clen}\t{offset}\t{width}\t{width + 1}\n")
            offset += clen + rows


def write_vcf(ds: Dataset, path: str) -> None:
    with open(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        for c in ds.chroms:
            f.write(f"##contig=<ID={c},length={ds.chrom_len}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for t, p, r, a in zip(ds.v_tid.tolist(), ds.v_pos.tolist(),
                              ds.v_ref, ds.v_alt):
            f.write(f"{ds.chroms[t]}\t{p + 1}\t.\t{r.decode()}\t"
                    f"{a.decode()}\t.\t.\t.\n")


def write_barcodes(ds: Dataset, path: str) -> None:
    with open(path, "wt") as f:
        f.write("\n".join(ds.barcodes) + "\n")


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM specification's reg2bin over arrays."""
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _header(ds: Dataset) -> bytes:
    text = (b"@HD\tVN:1.6\tSO:coordinate\n"
            + b"".join(f"@SQ\tSN:{n}\tLN:{ds.chrom_len}\n".encode()
                       for n in ds.chroms))
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(ds.chroms))
    for name in ds.chroms:
        nb = name.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i",
                                                              ds.chrom_len)
    return head


def _qnames(ids: np.ndarray) -> np.ndarray:
    """uint8 [n, 2 + QNAME_DIGITS]: "r" and the id's digits, NUL-ended."""
    out = np.empty((len(ids), 2 + QNAME_DIGITS), np.uint8)
    out[:, 0] = ord("r")
    v = ids.copy()
    for k in range(QNAME_DIGITS, 0, -1):
        out[:, k] = ord("0") + v % 10
        v //= 10
    out[:, -1] = 0
    return out


def record_bytes(ds: Dataset, ends: np.ndarray, lo: int, hi: int):
    """(uint8 [hi - lo, width] rows, int64 [hi - lo] lengths): records lo
    to hi of the dataset, each row's first `length` bytes its encoding
    (block_size included), CIGAR ops beyond n_cigar dropped by a shift of
    the bytes after them."""
    n = hi - lo
    L = ds.seq.shape[1]
    nc = ds.n_cigar[lo:hi]
    has_umi = ds.umi.shape[1] > 0
    name_len = 2 + QNAME_DIGITS
    cb_len = len(ds.barcodes[0]) if ds.barcodes else 0
    tail = (L + 1) // 2 + L + 3 + cb_len + 1 + (3 + UMI_LEN + 1 if has_umi
                                                else 0)
    width = 36 + name_len + 12 + tail
    rows = np.zeros((n, width), np.uint8)

    def put(col, values, dtype):
        b = np.ascontiguousarray(values, dtype=dtype).view(np.uint8)
        rows[:, col : col + b.size // max(n, 1)] = b.reshape(n, -1)

    length = 32 + name_len + 4 * nc + tail
    put(0, length, "<i4")
    put(4, ds.tid[lo:hi], "<i4")
    put(8, ds.pos[lo:hi], "<i4")
    rows[:, 12] = name_len
    rows[:, 13] = ds.mapq[lo:hi]
    put(14, reg2bin(ds.pos[lo:hi], ends[lo:hi]), "<u2")
    put(16, nc, "<u2")
    put(18, ds.flag[lo:hi], "<u2")
    put(20, np.full(n, L), "<i4")
    put(24, np.full(n, -1), "<i4")
    put(28, np.full(n, -1), "<i4")
    put(32, np.zeros(n), "<i4")
    rows[:, 36 : 36 + name_len] = _qnames(ds.qname_id[lo:hi])
    cig = ((ds.cigar_lens[lo:hi] << 4) | ds.cigar_ops[lo:hi]).astype("<u4")
    c0 = 36 + name_len
    rows[:, c0 : c0 + 12] = cig.view(np.uint8).reshape(n, 12)
    t = np.empty((n, tail), np.uint8)
    nib = _NT16[ds.seq[lo:hi]]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    k = (L + 1) // 2
    t[:, :k] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    t[:, k : k + L] = QUAL
    k += L
    t[:, k : k + 3] = np.frombuffer(b"CBZ", np.uint8)
    bc = np.frombuffer("".join(ds.barcodes).encode(), np.uint8).reshape(
        len(ds.barcodes), cb_len)
    t[:, k + 3 : k + 3 + cb_len] = bc[ds.cell[lo:hi]]
    t[:, k + 3 + cb_len] = 0
    k += 3 + cb_len + 1
    if has_umi:
        t[:, k : k + 3] = np.frombuffer(b"UBZ", np.uint8)
        t[:, k + 3 : k + 3 + UMI_LEN] = ds.umi[lo:hi]
        t[:, k + 3 + UMI_LEN] = 0
    # the tail follows the record's last CIGAR op
    for ncig in (1, 2, 3):
        sel = np.nonzero(nc == ncig)[0]
        if len(sel):
            c1 = c0 + 4 * ncig
            rows[sel, c1 : c1 + tail] = t[sel]
    return rows, length + 4


def _records_stream(ds: Dataset, ends: np.ndarray, block=1 << 17):
    """The records' bytes in order, and each record's offset in them."""
    parts, offs = [], [np.zeros(1, np.int64)]
    total = 0
    for lo in range(0, ds.n, block):
        hi = min(ds.n, lo + block)
        rows, lens = record_bytes(ds, ends, lo, hi)
        keep = np.arange(rows.shape[1])[None, :] < lens[:, None]
        parts.append(rows[keep])
        offs.append(total + np.cumsum(lens))
        total += int(lens.sum())
    stream = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return stream, np.concatenate(offs)


def _deflate(chunk: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2)
              + struct.pack("<H", len(cdata) + 25))
    return header + cdata + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def _bai(ds: Dataset, ends: np.ndarray, u_beg: np.ndarray,
         u_end: np.ndarray, block_coff: np.ndarray, stream_len: int,
         eof_coff: int) -> bytes:
    def voff(u):
        blk = np.minimum(u // BLOCK, len(block_coff) - 1)
        v = (block_coff[blk] << 16) | (u % BLOCK)
        return np.where(u >= stream_len, eof_coff << 16, v)

    vbeg, vend = voff(u_beg), voff(u_end)
    bins = reg2bin(ds.pos, ends)
    tid = ds.tid.astype(np.int64)
    n_refs = len(ds.chroms)
    parts = [b"BAI\x01", struct.pack("<i", n_refs)]
    # a chunk is a run of consecutive records in one (tid, bin)
    key = tid << 32 | bins
    new = np.ones(ds.n, bool)
    new[1:] = key[1:] != key[:-1]
    run_id = np.cumsum(new) - 1
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, ds.n - 1)
    r_key = key[first]
    r_beg, r_end = vbeg[first], vend[last]
    order = np.lexsort((first, r_key))  # by (tid, bin), then file order
    del run_id
    for t in range(n_refs):
        sel = order[(r_key[order] >> 32) == t]
        rb = r_key[sel] & 0xFFFFFFFF
        ub, starts = np.unique(rb, return_index=True)
        parts.append(struct.pack("<i", len(ub)))
        bounds = np.append(starts, len(sel))
        for k, b in enumerate(ub.tolist()):
            s = sel[bounds[k] : bounds[k + 1]]
            parts.append(struct.pack("<Ii", b, len(s)))
            parts.append(np.stack([r_beg[s], r_end[s]], axis=1).astype(
                "<u8").tobytes())
        on = tid == t
        if not on.any():
            parts.append(struct.pack("<i", 0))
            continue
        w0 = ds.pos[on] >> 14
        w1 = (ends[on] - 1) >> 14
        nwin = int(w1.max()) + 1
        first_v = np.full(nwin, np.iinfo(np.int64).max, np.int64)
        span = w1 - w0
        vb = vbeg[on]
        for d in range(int(span.max()) + 1):
            k = span >= d
            np.minimum.at(first_v, w0[k] + d, vb[k])
        unset = first_v == np.iinfo(np.int64).max
        filled = np.where(unset, 0, first_v)
        # a window no record touches takes the one before it
        idx = np.where(unset, 0, np.arange(nwin))
        np.maximum.accumulate(idx, out=idx)
        iv = filled[idx]
        parts.append(struct.pack("<i", nwin))
        parts.append(iv.astype("<u8").tobytes())
    return b"".join(parts)


def write_bam(ds: Dataset, path: str, threads: int = 8) -> None:
    """The BAM at path and its index at path + ".bai"."""
    ends = ds.ref_end()
    head = _header(ds)
    recs, rec_off = _records_stream(ds, ends)
    stream = np.concatenate([np.frombuffer(head, np.uint8), recs])
    chunks = [stream[i : i + BLOCK].tobytes()
              for i in range(0, len(stream), BLOCK)]
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        blocks = list(ex.map(_deflate, chunks))
    sizes = np.array([len(b) for b in blocks], np.int64)
    block_coff = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    eof_coff = int(sizes.sum())
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(BGZF_EOF)
    u = len(head) + rec_off
    bai = _bai(ds, ends, u[:-1], u[1:], block_coff, len(stream), eof_coff)
    with open(path + ".bai", "wb") as f:
        f.write(bai)


def write(ds: Dataset, outdir: str, threads: int = 8) -> dict:
    """Writes every input file into outdir; returns their paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = {"fasta": os.path.join(outdir, "genome.fa"),
             "vcf": os.path.join(outdir, "variants.vcf"),
             "barcodes": os.path.join(outdir, "barcodes.tsv"),
             "bam": os.path.join(outdir, "reads.bam")}
    write_fasta(ds, paths["fasta"])
    write_vcf(ds, paths["vcf"])
    write_barcodes(ds, paths["barcodes"])
    write_bam(ds, paths["bam"], threads)
    return paths
