"""CRAM 3.0 reading and writing.

The reference accepts CRAM via htslib (reference src/main.rs:530-535).
This module implements the CRAM 3.0 container format from the
specification: ITF8/LTF8 varints, containers/blocks, the compression
header (preservation map, data-series encoding map, tag encoding map),
slice decoding, and reference-based sequence reconstruction.

Supported block compression methods: raw, gzip, rANS 4x8 (order 0 and
1), bzip2, and lzma — reading AND writing (bzip2/lzma via the stdlib
here; the native decoder links libbz2/liblzma).

Supported data-series codecs: EXTERNAL, HUFFMAN (canonical, incl. the
0-bit single-symbol case), BETA, GAMMA, SUBEXP, GOLOMB(_RICE),
BYTE_ARRAY_LEN, BYTE_ARRAY_STOP — the full CRAM 3.0 integer-codec set;
the writer can emit them too (codec_profile="mixed"/"exotic").

The writer emits a deliberately simple, legal profile (everything
EXTERNAL, gzip blocks) used by tests and tooling; the reader handles
both that profile and the htslib-style one.

Integration: `CramReader.records()` yields the same BamRecord objects as
io/bam.py (decoded via transcoding to BAM record binary), so every
downstream consumer (including the columnar native path via
`transcode_to_bam`) works unchanged.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# varints

def read_itf8(buf: bytes, off: int) -> Tuple[int, int]:
    """Prefix widths per the spec: 0/10/110/1110/1111 -> 7/14/21/28/32 bits."""
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        v = ((b0 & 0x3F) << 8) | buf[off + 1]
        return v, off + 2
    if b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        return v, off + 3
    if b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (buf[off + 1] << 16) | (buf[off + 2] << 8) | buf[off + 3]
        return v, off + 4
    v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) | (buf[off + 2] << 12) \
        | (buf[off + 3] << 4) | (buf[off + 4] & 0x0F)
    if v >= 1 << 31:
        v -= 1 << 32
    return v, off + 5


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 1 << 7:
        return bytes([v])
    if v < 1 << 14:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 1 << 21:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 1 << 28:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def read_ltf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    if n == 0:
        return b0, off + 1
    if n == 8:
        v = int.from_bytes(buf[off + 1 : off + 9], "big")
        if v >= 1 << 63:
            v -= 1 << 64
        return v, off + 9
    v = b0 & (0xFF >> (n + 1))
    for k in range(n):
        v = (v << 8) | buf[off + 1 + k]
    return v, off + 1 + n


def write_ltf8(v: int) -> bytes:
    if v < 0:
        return b"\xFF" + (v & ((1 << 64) - 1)).to_bytes(8, "big")
    for n in range(8):  # n extra bytes; first byte holds 7-n value bits
        if v < (1 << (7 + 7 * n)):
            prefix = (0xFF << (8 - n)) & 0xFF
            first = prefix | (v >> (8 * n))
            rest = (v & ((1 << (8 * n)) - 1)).to_bytes(n, "big") if n else b""
            return bytes([first]) + rest
    return b"\xFF" + v.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# rANS 4x8 decoder (CRAM spec section 13; order-0 and order-1)

RANS_LOW = 1 << 23


def _cum_from_freqs(freqs):
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    return cum


def rans_decode_4x8(data: bytes, raw_size: int) -> bytes:
    order = data[0]
    # n_in = struct.unpack_from("<I", data, 1)[0]
    n_out = struct.unpack_from("<I", data, 5)[0]
    assert n_out == raw_size, (n_out, raw_size)
    off = 9
    if order == 0:
        return _rans0_decode(data, off, n_out)
    return _rans1_decode(data, off, n_out)


def _read_freq_table0(data: bytes, off: int):
    """Order-0 frequency table: (symbol, ITF8 freq) pairs with RLE over
    consecutive symbols; a next-symbol byte of 0 terminates."""
    freqs = [0] * 256
    sym = data[off]; off += 1
    last_sym = sym
    rle = 0
    while True:
        f, off = read_itf8(data, off)
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = data[off]; off += 1
            if sym == last_sym + 1:
                rle = data[off]; off += 1
            if sym == 0:
                break
        last_sym = sym
    return freqs, off


def _rans0_decode(data: bytes, off: int, n_out: int) -> bytes:
    freqs, off = _read_freq_table0(data, off)
    cum = _cum_from_freqs(freqs)
    total = cum[256]
    assert total <= 4096
    # symbol lookup table over 4096 slots
    lookup = bytearray(4096)
    for s in range(256):
        for slot in range(cum[s], cum[s + 1]):
            lookup[slot] = s
    states = list(struct.unpack_from("<4I", data, off))
    off += 16
    out = bytearray(n_out)
    for i in range(n_out):
        j = i & 3
        x = states[j]
        slot = x & 0xFFF
        s = lookup[slot]
        out[i] = s
        x = freqs[s] * (x >> 12) + slot - cum[s]
        while x < RANS_LOW and off < len(data):
            x = (x << 8) | data[off]
            off += 1
        states[j] = x
    return bytes(out)


def _rans1_decode(data: bytes, off: int, n_out: int) -> bytes:
    # order-1: per-context frequency tables
    freqs = [[0] * 256 for _ in range(256)]
    cums = [None] * 256
    lookups: List[Optional[bytearray]] = [None] * 256
    ctx = data[off]; off += 1
    last_ctx = ctx
    rle_ctx = 0
    while True:
        # inner order-0 table for this context
        f, off2 = _read_freq_table0(data, off)
        off = off2
        freqs[ctx] = f
        if rle_ctx > 0:
            rle_ctx -= 1
            ctx += 1
        else:
            nxt = data[off]; off += 1
            ctx = nxt
            if ctx == 0:
                break
            if ctx == last_ctx + 1:
                rle_ctx = data[off]; off += 1
        last_ctx = ctx
    for c in range(256):
        cums[c] = _cum_from_freqs(freqs[c])
    states = list(struct.unpack_from("<4I", data, off))
    off += 16
    out = bytearray(n_out)
    isz4 = n_out >> 2  # state j decodes the j-th quarter; state 3 the tail
    last = [0, 0, 0, 0]

    def decode_one(j, pos, off):
        x = states[j]
        c = last[j]
        cum = cums[c]
        lk = lookups[c]
        if lk is None:
            lk = bytearray(4096)
            for s_ in range(256):
                for t in range(cum[s_], cum[s_ + 1]):
                    lk[t] = s_
            lookups[c] = lk
        slot = x & 0xFFF
        s = lk[slot]
        out[pos] = s
        x = freqs[c][s] * (x >> 12) + slot - cum[s]
        while x < RANS_LOW and off < len(data):
            x = (x << 8) | data[off]
            off += 1
        states[j] = x
        last[j] = s
        return off

    for i in range(isz4):
        for j in range(4):
            off = decode_one(j, j * isz4 + i, off)
    for pos in range(4 * isz4, n_out):
        off = decode_one(3, pos, off)
    return bytes(out)


def _norm_freqs_4096(counts):
    """Normalize symbol counts to sum exactly 4096 (present symbols keep
    freq >= 1), the htslib rans_static convention."""
    total = sum(counts)
    if total == 0:
        return None
    freqs = [0] * 256
    # largest-remainder scaling with a floor of 1 for present symbols
    scaled = [(c * 4096) // total if c else 0 for c in counts]
    for i in range(256):
        if counts[i] and scaled[i] == 0:
            scaled[i] = 1
    diff = 4096 - sum(scaled)
    # push the difference onto the most frequent symbol (always safe:
    # its scaled value is >= everyone else's, and diff >= -(255))
    imax = max(range(256), key=lambda i: scaled[i])
    scaled[imax] += diff
    if scaled[imax] <= 0:
        return None  # degenerate distribution; caller falls back
    return scaled


def _write_freq_table0(freqs) -> bytes:
    """Order-0 table in the spec's RLE layout, emitting exactly the byte
    sequence _read_freq_table0 consumes: [s0] then per explicit symbol
    freq(s) [next_sym] [rle iff next_sym == prev+1] with RLE-advanced
    symbols contributing freqs only; terminated by symbol byte 0."""
    syms = [s for s in range(256) if freqs[s]]
    # maximal consecutive runs: (start, length)
    runs = []
    i = 0
    while i < len(syms):
        j = i
        while j + 1 < len(syms) and syms[j + 1] == syms[j] + 1:
            j += 1
        runs.append((syms[i], j - i + 1))
        i = j + 1
    out = bytearray()
    out.append(runs[0][0])  # initial symbol byte (no RLE check)
    last = None
    for gi, (start, length) in enumerate(runs):
        if gi == 0:
            out += write_itf8(freqs[start])
            if length > 1:
                out.append(start + 1)       # consecutive -> RLE byte follows
                out.append(length - 2)      # extra symbols after start+1
                for k in range(1, length):
                    out += write_itf8(freqs[start + k])
        else:
            out.append(start)
            if start == last + 1:
                out.append(length - 1)      # RLE covers the whole run
                for k in range(length):
                    out += write_itf8(freqs[start + k])
            else:
                out += write_itf8(freqs[start])
                if length > 1:
                    out.append(start + 1)
                    out.append(length - 2)
                    for k in range(1, length):
                        out += write_itf8(freqs[start + k])
        last = start + length - 1
    out.append(0)
    return bytes(out)


def _rans_renorm_encode(x, freq, out):
    x_max = ((RANS_LOW >> 12) << 8) * freq
    while x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
    return x


def rans_encode_4x8(raw: bytes, order: int = 0) -> Optional[bytes]:
    """rANS 4x8 encoder (CRAM spec section 13), order 0 or 1 — the block
    method htslib emits by default. Returns None for inputs the simple
    normalizer cannot handle (caller falls back to gzip)."""
    n = len(raw)
    if n == 0:
        return None
    if order == 0:
        counts = [0] * 256
        for b in raw:
            counts[b] += 1
        freqs = _norm_freqs_4096(counts)
        if freqs is None:
            return None
        cum = _cum_from_freqs(freqs)
        table = _write_freq_table0(freqs)
        states = [RANS_LOW] * 4
        body = bytearray()
        for i in range(n - 1, -1, -1):
            j = i & 3
            s = raw[i]
            x = _rans_renorm_encode(states[j], freqs[s], body)
            states[j] = ((x // freqs[s]) << 12) + (x % freqs[s]) + cum[s]
        body.reverse()
        head = struct.pack("<B", 0) + struct.pack("<II", 0, n)
        payload = head + table + struct.pack("<4I", *states) + bytes(body)
        return payload[:1] + struct.pack("<I", len(payload) - 9) + payload[5:]
    if order == 1:
        if n < 4:
            return None
        isz4 = n >> 2
        # (context, symbol) pair counts per the decoder's quarter scheme
        counts = [[0] * 256 for _ in range(256)]
        starts = [0 * isz4, 1 * isz4, 2 * isz4, 3 * isz4]
        seq_ctx = [0] * n  # context of each position
        for j in range(4):
            last = 0
            lo = j * isz4
            hi = (j + 1) * isz4 if j < 3 else n
            for p in range(lo, hi):
                seq_ctx[p] = last
                counts[last][raw[p]] += 1
                last = raw[p]
        freqs1 = [None] * 256
        cums1 = [None] * 256
        for c in range(256):
            if sum(counts[c]) == 0:
                continue
            f = _norm_freqs_4096(counts[c])
            if f is None:
                return None
            freqs1[c] = f
            cums1[c] = _cum_from_freqs(f)
        # context table with RLE over contexts, mirroring _rans1_decode's
        # exact read sequence (same structure as the order-0 table, with
        # an inner order-0 table where a frequency would sit)
        ctxs = [c for c in range(256) if freqs1[c] is not None]
        runs = []
        i = 0
        while i < len(ctxs):
            j2 = i
            while j2 + 1 < len(ctxs) and ctxs[j2 + 1] == ctxs[j2] + 1:
                j2 += 1
            runs.append((ctxs[i], j2 - i + 1))
            i = j2 + 1
        table = bytearray()
        table.append(runs[0][0])
        lastc = None
        for gi, (start, length) in enumerate(runs):
            if gi == 0:
                table += _write_freq_table0(freqs1[start])
                if length > 1:
                    table.append(start + 1)
                    table.append(length - 2)
                    for k in range(1, length):
                        table += _write_freq_table0(freqs1[start + k])
            else:
                table.append(start)
                if start == lastc + 1:
                    table.append(length - 1)
                    for k in range(length):
                        table += _write_freq_table0(freqs1[start + k])
                else:
                    table += _write_freq_table0(freqs1[start])
                    if length > 1:
                        table.append(start + 1)
                        table.append(length - 2)
                        for k in range(1, length):
                            table += _write_freq_table0(freqs1[start + k])
            lastc = start + length - 1
        table.append(0)
        # encode in exact reverse of the decoder's (state, pos) sequence
        order_seq = []
        for i2 in range(isz4):
            for j in range(4):
                order_seq.append((j, j * isz4 + i2))
        for pos in range(4 * isz4, n):
            order_seq.append((3, pos))
        states = [RANS_LOW] * 4
        body = bytearray()
        for j, pos in reversed(order_seq):
            s = raw[pos]
            c = seq_ctx[pos]
            f = freqs1[c][s]
            cum = cums1[c][s]
            x = _rans_renorm_encode(states[j], f, body)
            states[j] = ((x // f) << 12) + (x % f) + cum
        body.reverse()
        head = struct.pack("<B", 1) + struct.pack("<II", 0, n)
        payload = head + bytes(table) + struct.pack("<4I", *states) + bytes(body)
        return payload[:1] + struct.pack("<I", len(payload) - 9) + payload[5:]
    raise ValueError(f"rans order {order}")


# ---------------------------------------------------------------------------
# rANS Nx16 (CRAM 3.1 block method 5, hts-specs CRAMcodecs "rANS Nx16"):
# 16-bit renormalization, 4- or 32-way state interleave, and the bit-PACK
# / RLE / STRIPE / CAT byte transforms composed around the entropy stage.
# Encode pipeline: PACK -> RLE -> rANS; decode inverts. Sizes are uint7
# varints (big-endian 7-bit groups, high bit = continuation).
#
# The writer and both decoders (this module + native/cramio.cpp) share
# this implementation's conventions and are round-trip tested against
# each other; bit-level parity with htslib's encoder output cannot be
# verified in this environment (no htslib/egress) — see PARITY.md.
# ---------------------------------------------------------------------------

NX16_ORDER1 = 0x01
NX16_X32 = 0x04
NX16_STRIPE = 0x08
NX16_NOSZ = 0x10
NX16_CAT = 0x20
NX16_RLE = 0x40
NX16_PACK = 0x80
RANS_NX16_LOW = 1 << 15


def read_uint7(data: bytes, off: int) -> Tuple[int, int]:
    v = 0
    while True:
        c = data[off]
        off += 1
        v = (v << 7) | (c & 0x7F)
        if not c & 0x80:
            return v, off


def write_uint7(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    out.reverse()
    return bytes(out)


def _read_alphabet_nx16(data: bytes, off: int) -> Tuple[List[int], int]:
    """Symbol list in the spec's RLE layout (same scheme as the 4x8
    frequency table's symbol stream): ascending symbols, a byte equal to
    prev+1 is followed by a run-extension count, terminated by 0."""
    syms = []
    sym = data[off]; off += 1
    last = sym
    rle = 0
    while True:
        syms.append(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = data[off]; off += 1
            if sym == last + 1:
                rle = data[off]; off += 1
            if sym == 0:
                break
        last = sym
    return syms, off


def _write_alphabet_nx16(syms: List[int]) -> bytes:
    """Exact inverse of _read_alphabet_nx16 (syms ascending, non-empty)."""
    runs = []
    i = 0
    while i < len(syms):
        j = i
        while j + 1 < len(syms) and syms[j + 1] == syms[j] + 1:
            j += 1
        runs.append((syms[i], j - i + 1))
        i = j + 1
    out = bytearray()
    for gi, (start, length) in enumerate(runs):
        out.append(start)
        if length > 1:
            out.append(start + 1)
            out.append(length - 2)
    out.append(0)
    return bytes(out)


def _norm_to_pow2(freqs: List[int], bits: int) -> List[int]:
    """Decoder-side renormalization to sum 1<<bits (no-op when already
    normalized, which is what our writer emits)."""
    tot = sum(freqs)
    want = 1 << bits
    if tot == want or tot == 0:
        return freqs
    scaled = [(f * want) // tot if f else 0 for f in freqs]
    for i in range(256):
        if freqs[i] and scaled[i] == 0:
            scaled[i] = 1
    imax = max(range(256), key=lambda i: scaled[i])
    scaled[imax] += want - sum(scaled)
    return scaled


def _nx16_decode_entropy0(data: bytes, off: int, n_out: int,
                          N: int) -> Tuple[bytes, int]:
    syms, off = _read_alphabet_nx16(data, off)
    freqs = [0] * 256
    for s in syms:
        freqs[s], off = read_uint7(data, off)
    freqs = _norm_to_pow2(freqs, 12)
    cum = _cum_from_freqs(freqs)
    lookup = bytearray(4096)
    for s in range(256):
        for slot in range(cum[s], cum[s + 1]):
            lookup[slot] = s
    states = list(struct.unpack_from(f"<{N}I", data, off))
    off += 4 * N
    out = bytearray(n_out)
    for i in range(n_out):
        j = i % N
        x = states[j]
        slot = x & 0xFFF
        s = lookup[slot]
        out[i] = s
        x = freqs[s] * (x >> 12) + slot - cum[s]
        while x < RANS_NX16_LOW and off + 1 < len(data):
            x = (x << 16) | (data[off] | (data[off + 1] << 8))
            off += 2
        states[j] = x
    return bytes(out), off


def _read_o1_table_nx16(tbl: bytes):
    """Order-1 frequency rows over a shared alphabet, zero-run encoded
    within each row."""
    syms, off = _read_alphabet_nx16(tbl, 0)
    freqs = {i: [0] * 256 for i in syms}
    for i in syms:
        run = 0
        for j in syms:
            if run > 0:
                run -= 1
                continue
            f, off = read_uint7(tbl, off)
            freqs[i][j] = f
            if f == 0:
                run = tbl[off]; off += 1
    return syms, freqs, off


def _nx16_decode_entropy1(data: bytes, off: int, n_out: int,
                          N: int) -> Tuple[bytes, int]:
    c = data[off]; off += 1
    shift = c >> 4
    if c & 1:  # table itself rANS-Nx16 compressed
        ulen, off = read_uint7(data, off)
        clen, off = read_uint7(data, off)
        tbl = rans_decode_nx16(data[off : off + clen], ulen)
        off += clen
        syms, freqs, _ = _read_o1_table_nx16(tbl)
    else:
        syms, freqs, tlen = _read_o1_table_nx16(data[off:])
        off += tlen
    cums = {}
    lookups = {}
    for i in syms:
        freqs[i] = _norm_to_pow2(freqs[i], shift)
        cums[i] = _cum_from_freqs(freqs[i])
    mask = (1 << shift) - 1
    states = list(struct.unpack_from(f"<{N}I", data, off))
    off += 4 * N
    out = bytearray(n_out)
    isz = n_out // N
    last = [0] * N

    def decode_one(j, pos, off):
        x = states[j]
        ctx = last[j]
        cum = cums.get(ctx)
        if cum is None:  # context never seen by the encoder
            raise ValueError("rANS Nx16 order-1: missing context table")
        lk = lookups.get(ctx)
        if lk is None:
            lk = bytearray(1 << shift)
            for s_ in syms:
                for t in range(cum[s_], cum[s_ + 1]):
                    lk[t] = s_
            lookups[ctx] = lk
        slot = x & mask
        s = lk[slot]
        out[pos] = s
        x = freqs[ctx][s] * (x >> shift) + slot - cum[s]
        while x < RANS_NX16_LOW and off + 1 < len(data):
            x = (x << 16) | (data[off] | (data[off + 1] << 8))
            off += 2
        states[j] = x
        last[j] = s
        return off

    for i in range(isz):
        for j in range(N):
            off = decode_one(j, j * isz + i, off)
    for pos in range(N * isz, n_out):
        off = decode_one(N - 1, pos, off)
    return bytes(out), off


def rans_decode_nx16(data: bytes, n_out: Optional[int] = None) -> bytes:
    """Decode one complete rANS Nx16 stream (flags byte first). n_out is
    required iff the stream carries the NOSZ flag."""
    flags = data[0]
    off = 1
    if not flags & NX16_NOSZ:
        n_out, off = read_uint7(data, off)
    if n_out is None:
        raise ValueError("rANS Nx16: NOSZ stream needs an explicit size")
    if flags & NX16_STRIPE:
        N = data[off]; off += 1
        clens = []
        for _ in range(N):
            cl, off = read_uint7(data, off)
            clens.append(cl)
        out = bytearray(n_out)
        for j in range(N):
            ulen = n_out // N + (1 if n_out % N > j else 0)
            sub = rans_decode_nx16(data[off : off + clens[j]], ulen)
            off += clens[j]
            out[j::N] = sub
        return bytes(out)
    N = 32 if flags & NX16_X32 else 4
    # transform metadata, parse order mirrors the encode pipeline
    pack_map = None
    if flags & NX16_PACK:
        n_pack_sym = data[off]; off += 1
        pack_map = data[off : off + n_pack_sym]
        off += n_pack_sym
        pack_len, off = read_uint7(data, off)
    rle_syms = rle_meta = None
    if flags & NX16_RLE:
        meta_len, off = read_uint7(data, off)
        rle_out_len, off = read_uint7(data, off)
        if meta_len & 1:
            meta = data[off : off + (meta_len >> 1)]
            off += meta_len >> 1
        else:
            comp_len, off = read_uint7(data, off)
            meta = rans_decode_nx16(data[off : off + comp_len],
                                    meta_len >> 1)
            off += comp_len
        n_sym = meta[0]
        if n_sym == 0:
            n_sym = 256
        rle_syms = set(meta[1 : 1 + n_sym])
        rle_meta = (meta, 1 + n_sym)
    # entropy stage target length
    if flags & NX16_RLE:
        ent_len = rle_out_len
    elif flags & NX16_PACK:
        ent_len = pack_len
    else:
        ent_len = n_out
    if flags & NX16_CAT:
        buf = data[off : off + ent_len]
    elif ent_len == 0:
        buf = b""
    elif flags & NX16_ORDER1:
        buf, _ = _nx16_decode_entropy1(data, off, ent_len, N)
    else:
        buf, _ = _nx16_decode_entropy0(data, off, ent_len, N)
    if flags & NX16_RLE:
        meta, moff = rle_meta
        out = bytearray()
        for b in buf:
            out.append(b)
            if b in rle_syms:
                run, moff = read_uint7(meta, moff)
                out += bytes([b]) * run
        buf = bytes(out)
    if flags & NX16_PACK:
        np_ = len(pack_map)
        if np_ <= 1:
            buf = bytes([pack_map[0]]) * n_out if n_out else b""
        else:
            bpv = 1 if np_ <= 2 else (2 if np_ <= 4 else 4)
            per = 8 // bpv
            mask = (1 << bpv) - 1
            out = bytearray(n_out)
            for i in range(n_out):
                v = buf[i // per] >> (bpv * (i % per))
                out[i] = pack_map[v & mask]
            buf = bytes(out)
    if len(buf) != n_out:
        raise ValueError(f"rANS Nx16 size mismatch: {len(buf)} != {n_out}")
    return buf


def _nx16_renorm_encode(x: int, freq: int, shift: int, body: bytearray) -> int:
    x_max = ((RANS_NX16_LOW >> shift) << 16) * freq
    while x >= x_max:
        body.append((x >> 8) & 0xFF)  # high byte first: the final
        body.append(x & 0xFF)         # reversal restores LE u16 order
        x >>= 16
    return x


def _nx16_encode_entropy0(raw: bytes, N: int) -> Optional[bytes]:
    counts = [0] * 256
    for b in raw:
        counts[b] += 1
    freqs = _norm_freqs_4096(counts)
    if freqs is None:
        return None
    cum = _cum_from_freqs(freqs)
    syms = [s for s in range(256) if freqs[s]]
    table = bytearray(_write_alphabet_nx16(syms))
    for s in syms:
        table += write_uint7(freqs[s])
    states = [RANS_NX16_LOW] * N
    body = bytearray()
    for i in range(len(raw) - 1, -1, -1):
        j = i % N
        s = raw[i]
        x = _nx16_renorm_encode(states[j], freqs[s], 12, body)
        states[j] = ((x // freqs[s]) << 12) + (x % freqs[s]) + cum[s]
    body.reverse()
    return bytes(table) + struct.pack(f"<{N}I", *states) + bytes(body)


def _nx16_encode_entropy1(raw: bytes, N: int) -> Optional[bytes]:
    n = len(raw)
    if n < N:
        return None
    isz = n // N
    counts = {}
    seq_ctx = bytearray(n)
    for j in range(N):
        last = 0
        lo = j * isz
        hi = (j + 1) * isz if j < N - 1 else n
        for p in range(lo, hi):
            seq_ctx[p] = last
            row = counts.setdefault(last, [0] * 256)
            row[raw[p]] += 1
            last = raw[p]
    present = set(counts.keys())
    for row in counts.values():
        present.update(s for s in range(256) if row[s])
    syms = sorted(present)
    freqs = {}
    cums = {}
    for i in syms:
        row = counts.get(i)
        if row is None or sum(row) == 0:
            # context appears as a symbol but never precedes anything;
            # emit an all-zero row (nothing is ever decoded from it)
            freqs[i] = [0] * 256
            continue
        f = _norm_freqs_4096(row)
        if f is None:
            return None
        freqs[i] = f
        cums[i] = _cum_from_freqs(f)
    table = bytearray(_write_alphabet_nx16(syms))
    for i in syms:
        row = freqs[i]
        j_idx = 0
        while j_idx < len(syms):
            f = row[syms[j_idx]]
            table += write_uint7(f)
            if f == 0:
                # count following zero freqs in this row
                run = 0
                while (j_idx + 1 + run < len(syms)
                       and run < 255
                       and row[syms[j_idx + 1 + run]] == 0):
                    run += 1
                table.append(run)
                j_idx += run
            j_idx += 1
    order_seq = []
    for i in range(isz):
        for j in range(N):
            order_seq.append((j, j * isz + i))
    for pos in range(N * isz, n):
        order_seq.append((N - 1, pos))
    states = [RANS_NX16_LOW] * N
    body = bytearray()
    for j, pos in reversed(order_seq):
        s = raw[pos]
        c = seq_ctx[pos]
        f = freqs[c][s]
        x = _nx16_renorm_encode(states[j], f, 12, body)
        states[j] = ((x // f) << 12) + (x % f) + cums[c][s]
    body.reverse()
    head = bytes([12 << 4])  # shift 12, uncompressed table
    return head + bytes(table) + struct.pack(f"<{N}I", *states) + bytes(body)


def _nx16_pack(raw: bytes):
    """(pack_map, packed) when <=16 distinct symbols, else None."""
    syms = sorted(set(raw))
    if len(syms) > 16 or not raw:
        return None
    idx = {s: k for k, s in enumerate(syms)}
    np_ = len(syms)
    if np_ <= 1:
        return bytes(syms), b""
    bpv = 1 if np_ <= 2 else (2 if np_ <= 4 else 4)
    per = 8 // bpv
    out = bytearray((len(raw) + per - 1) // per)
    for i, b in enumerate(raw):
        out[i // per] |= idx[b] << (bpv * (i % per))
    return bytes(syms), bytes(out)


def _nx16_rle(raw: bytes):
    """(rle_syms, literals, run_meta) — symbols whose every occurrence
    is followed by a uint7 run count in the meta stream."""
    if not raw:
        return None
    run_gain = [0] * 256
    i = 0
    while i < len(raw):
        j = i
        while j + 1 < len(raw) and raw[j + 1] == raw[i]:
            j += 1
        run_gain[raw[i]] += (j - i) - 1  # saved bytes minus varint cost
        i = j + 1
    syms = {s for s in range(256) if run_gain[s] > 0}
    if not syms:
        return None
    lits = bytearray()
    meta = bytearray()
    i = 0
    while i < len(raw):
        b = raw[i]
        lits.append(b)
        if b in syms:
            j = i
            while j + 1 < len(raw) and raw[j + 1] == b:
                j += 1
            meta += write_uint7(j - i)
            i = j + 1
        else:
            i += 1
    return syms, bytes(lits), bytes(meta)


def rans_encode_nx16(raw: bytes, order: int = 0, x32: bool = False,
                     pack: bool = False, rle: bool = False,
                     stripe: bool = False,
                     cat: bool = False) -> Optional[bytes]:
    """Encode one rANS Nx16 stream (flags byte + uint7 size + payload).
    Returns None when the requested combination cannot represent the
    input (caller falls back to another method)."""
    n = len(raw)
    flags = 0
    out = bytearray()
    if stripe:
        N = 4
        flags |= NX16_STRIPE
        out.append(flags)
        out += write_uint7(n)
        subs = []
        for j in range(N):
            enc = rans_encode_nx16(raw[j::N], order=order, x32=x32)
            if enc is None:
                return None
            # substreams carry NOSZ (length is derivable)
            enc = bytes([enc[0] | NX16_NOSZ]) + enc[1 + len(
                write_uint7(len(raw[j::N]))):]
            subs.append(enc)
        out.append(N)
        for s in subs:
            out += write_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)
    N = 32 if x32 else 4
    if x32:
        flags |= NX16_X32
    pack_blob = b""
    data = raw
    if pack:
        p = _nx16_pack(data)
        if p is None:
            return None
        pmap, data = p
        flags |= NX16_PACK
        pack_blob = bytes([len(pmap)]) + pmap + write_uint7(len(data))
    rle_blob = b""
    if rle and data:
        r = _nx16_rle(data)
        if r is None:
            return None
        syms, data, run_meta = r
        flags |= NX16_RLE
        n_sym = len(syms)
        meta = bytes([0 if n_sym == 256 else n_sym]) + bytes(sorted(syms)) \
            + run_meta
        rle_blob = (write_uint7((len(meta) << 1) | 1)
                    + write_uint7(len(data)) + meta)
    if cat or len(data) < 4 * N or len(set(data)) <= 1:
        flags |= NX16_CAT
        body = bytes(data)
    elif order == 1:
        body = _nx16_encode_entropy1(data, N)
        if body is None:
            return None
        flags |= NX16_ORDER1
    else:
        body = _nx16_encode_entropy0(data, N)
        if body is None:
            return None
    out.append(flags)
    out += write_uint7(n)
    out += pack_blob
    out += rle_blob
    out += body
    return bytes(out)


# ---------------------------------------------------------------------------
# blocks

METHOD_RAW, METHOD_GZIP, METHOD_BZIP2, METHOD_LZMA, METHOD_RANS = 0, 1, 2, 3, 4
# CRAM 3.1 additions: rANS Nx16 is implemented; the remaining 3.1 codecs
# raise a named, actionable error instead of a generic method number
METHOD_RANSNX16, METHOD_ARITH, METHOD_FQZCOMP, METHOD_TOK3 = 5, 6, 7, 8
CRAM31_CODEC_NAMES = {6: "adaptive arithmetic", 7: "fqzcomp", 8: "name tokeniser"}
CT_FILE_HEADER, CT_COMP_HEADER, CT_SLICE_HEADER, CT_EXTERNAL, CT_CORE = 0, 1, 2, 4, 5


class Block:
    def __init__(self, method: int, content_type: int, content_id: int,
                 data: bytes, raw_size: Optional[int] = None):
        self.method = method
        self.content_type = content_type
        self.content_id = content_id
        self.data = data
        self.raw_size = len(data) if raw_size is None else raw_size


def read_block(buf: bytes, off: int) -> Tuple[Block, int]:
    method = buf[off]
    ctype = buf[off + 1]
    off += 2
    cid, off = read_itf8(buf, off)
    csize, off = read_itf8(buf, off)
    rsize, off = read_itf8(buf, off)
    payload = buf[off : off + csize]
    off += csize
    off += 4  # crc32
    if method == METHOD_RAW:
        data = payload
    elif method == METHOD_GZIP:
        data = zlib.decompress(payload, wbits=31)
    elif method == METHOD_BZIP2:
        import bz2
        data = bz2.decompress(payload)
    elif method == METHOD_LZMA:
        import lzma
        data = lzma.decompress(payload)
    elif method == METHOD_RANS:
        data = rans_decode_4x8(payload, rsize)
    elif method == METHOD_RANSNX16:
        data = rans_decode_nx16(payload, rsize)
    elif method in CRAM31_CODEC_NAMES:
        raise NotImplementedError(
            f"CRAM 3.1 codec {CRAM31_CODEC_NAMES[method]} (block method "
            f"{method}) is not supported; re-encode the file with "
            "standard codecs (e.g. samtools view --output-fmt-option "
            "version=3.0)")
    else:
        raise NotImplementedError(f"CRAM block compression method {method}")
    if len(data) != rsize:
        raise ValueError(f"block raw size mismatch: {len(data)} != {rsize}")
    return Block(method, ctype, cid, data), off


def skip_block(buf: bytes, off: int) -> int:
    """Advance past a block without decompressing its payload."""
    off += 2  # method, content type
    _cid, off = read_itf8(buf, off)
    csize, off = read_itf8(buf, off)
    _rsize, off = read_itf8(buf, off)
    return off + csize + 4  # payload + crc32


def write_block(b: Block, compress: bool = True,
                method_hint: str = "gzip") -> bytes:
    raw = b.data
    comp, method = raw, METHOD_RAW
    if compress and len(raw) > 32:
        if method_hint in ("rans0", "rans1"):
            r = rans_encode_4x8(raw, 0 if method_hint == "rans0" else 1)
            if r is not None and len(r) < len(raw):
                comp, method = r, METHOD_RANS
        elif method_hint.startswith("ransnx16"):
            # CRAM 3.1 rANS Nx16 block. "ransnx16" = order-0;
            # "ransnx16o1" = order-1; "ransnx16mix" rotates through the
            # transform combinations deterministically per block so one
            # written file exercises every decoder path (the 3.1
            # decoder-hardening profile, like codec_profile="exotic"
            # does for the 3.0 record codecs).
            if method_hint == "ransnx16mix":
                opts = [dict(order=0), dict(order=1),
                        dict(order=0, pack=True), dict(order=0, rle=True),
                        dict(order=1, x32=True), dict(order=0, stripe=True),
                        dict(order=0, pack=True, rle=True)][
                    (b.content_id + len(raw)) % 7]
            else:
                opts = dict(order=1 if method_hint.endswith("o1") else 0)
            r = rans_encode_nx16(raw, **opts)
            if r is None:
                r = rans_encode_nx16(raw, order=0)
            if r is not None and len(r) < len(raw):
                comp, method = r, METHOD_RANSNX16
        elif method_hint == "bzip2":
            import bz2
            bzd = bz2.compress(raw)
            if len(bzd) < len(raw):
                comp, method = bzd, METHOD_BZIP2
        elif method_hint == "lzma":
            import lzma
            xz = lzma.compress(raw)
            if len(xz) < len(raw):
                comp, method = xz, METHOD_LZMA
        if method is METHOD_RAW:
            co = zlib.compressobj(6, zlib.DEFLATED, 31)
            gz = co.compress(raw) + co.flush()
            if len(gz) < len(raw):
                comp, method = gz, METHOD_GZIP
    out = bytes([method, b.content_type]) + write_itf8(b.content_id)
    out += write_itf8(len(comp)) + write_itf8(len(raw)) + comp
    out += struct.pack("<I", zlib.crc32(out))
    return out


CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001000100ee63014b")


# ---------------------------------------------------------------------------
# core bit reader (MSB first)

class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


# ---------------------------------------------------------------------------
# encodings

C_NULL, C_EXTERNAL, C_GOLOMB, C_HUFFMAN, C_BYTE_ARRAY_LEN, C_BYTE_ARRAY_STOP, \
    C_BETA, C_SUBEXP, C_GOLOMB_RICE, C_GAMMA = range(10)


class Encoding:
    """Decodes one data series value; kind is 'int', 'byte' or 'bytes'."""

    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        p = params
        if codec == C_EXTERNAL:
            self.content_id, _ = read_itf8(p, 0)
        elif codec == C_HUFFMAN:
            off = 0
            n, off = read_itf8(p, off)
            self.alphabet = []
            for _ in range(n):
                v, off = read_itf8(p, off)
                self.alphabet.append(v)
            n2, off = read_itf8(p, off)
            lens = []
            for _ in range(n2):
                v, off = read_itf8(p, off)
                lens.append(v)
            self.lens = lens
            # canonical codes: sort by (len, symbol)
            order = sorted(range(n), key=lambda i: (lens[i], self.alphabet[i]))
            codes = {}
            code, prev_len = 0, 0
            for i in order:
                l = lens[i]
                code <<= (l - prev_len)
                codes[(l, code)] = self.alphabet[i]
                code += 1
                prev_len = l
            self.codes = codes
            self.single = n == 1 and lens[0] == 0
        elif codec == C_BETA:
            off = 0
            self.offset, off = read_itf8(p, off)
            self.nbits, off = read_itf8(p, off)
        elif codec == C_GAMMA:
            self.offset, _ = read_itf8(p, 0)
        elif codec == C_SUBEXP:
            off = 0
            self.offset, off = read_itf8(p, off)
            self.k, off = read_itf8(p, off)
        elif codec == C_GOLOMB or codec == C_GOLOMB_RICE:
            off = 0
            self.offset, off = read_itf8(p, off)
            self.m, off = read_itf8(p, off)
            if self.m <= 0:
                raise ValueError("golomb m must be positive")
        elif codec == C_BYTE_ARRAY_LEN:
            off = 0
            lc, off = read_itf8(p, off)
            ln, off = read_itf8(p, off)
            self.len_enc = Encoding(lc, p[off : off + ln])
            off += ln
            vc, off = read_itf8(p, off)
            vn, off = read_itf8(p, off)
            self.val_enc = Encoding(vc, p[off : off + vn])
        elif codec == C_BYTE_ARRAY_STOP:
            self.stop = p[0]
            self.content_id, _ = read_itf8(p, 1)
        elif codec == C_NULL:
            pass
        else:
            raise NotImplementedError(f"CRAM encoding codec {codec}")

    def read_int(self, core: BitReader, ext: Dict[int, "ExtStream"]) -> int:
        if self.codec == C_EXTERNAL:
            return ext[self.content_id].read_itf8()
        if self.codec == C_HUFFMAN:
            if self.single:
                return self.alphabet[0]
            l, code = 0, 0
            while True:
                code = (code << 1) | core.read_bits(1)
                l += 1
                v = self.codes.get((l, code))
                if v is not None:
                    return v
                if l > 31:
                    raise ValueError("bad huffman stream")
        if self.codec == C_BETA:
            return core.read_bits(self.nbits) - self.offset
        if self.codec == C_GAMMA:
            # Elias gamma of (value + offset): z zeros, then the z+1-bit
            # binary of the value (MSB 1 is the terminator)
            z = 0
            while core.read_bits(1) == 0:
                z += 1
            v = (1 << z) | (core.read_bits(z) if z else 0)
            return v - self.offset
        if self.codec == C_SUBEXP:
            # n ones + 0; n == 0 -> k-bit value, else (k+n-1)-bit value
            # with the implicit top bit (htslib cram_codecs semantics)
            n = 0
            while core.read_bits(1) == 1:
                n += 1
            if n == 0:
                v = core.read_bits(self.k)
            else:
                b = self.k + n - 1
                v = (1 << b) | core.read_bits(b)
            return v - self.offset
        if self.codec in (C_GOLOMB, C_GOLOMB_RICE):
            # unary quotient (ones then 0) + truncated-binary remainder
            q = 0
            while core.read_bits(1) == 1:
                q += 1
            m = self.m
            b = (m - 1).bit_length()
            t = (1 << b) - m
            if b == 0:  # m == 1: no remainder bits
                r = 0
            else:
                r = core.read_bits(b - 1)
                if r >= t:
                    r = ((r << 1) | core.read_bits(1)) - t
            return q * m + r - self.offset
        raise NotImplementedError(f"int read from codec {self.codec}")

    def read_byte(self, core: BitReader, ext: Dict[int, "ExtStream"]) -> int:
        if self.codec == C_EXTERNAL:
            return ext[self.content_id].read_byte()
        return self.read_int(core, ext)

    def read_bytes(self, n_hint: Optional[int], core: BitReader,
                   ext: Dict[int, "ExtStream"]) -> bytes:
        if self.codec == C_BYTE_ARRAY_STOP:
            return ext[self.content_id].read_until(self.stop)
        if self.codec == C_BYTE_ARRAY_LEN:
            n = self.len_enc.read_int(core, ext)
            ve = self.val_enc
            if ve.codec == C_EXTERNAL:
                return ext[ve.content_id].read(n)
            return bytes(ve.read_byte(core, ext) for _ in range(n))
        if self.codec == C_EXTERNAL:
            assert n_hint is not None
            return ext[self.content_id].read(n_hint)
        raise NotImplementedError(f"bytes read from codec {self.codec}")


class ExtStream:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def read_byte(self) -> int:
        b = self.data[self.off]
        self.off += 1
        return b

    def read_itf8(self) -> int:
        v, self.off = read_itf8(self.data, self.off)
        return v

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.off)
        out = self.data[self.off : end]
        self.off = end + 1
        return out


# encoding builders for the writer
def enc_external(content_id: int) -> bytes:
    p = write_itf8(content_id)
    return write_itf8(C_EXTERNAL) + write_itf8(len(p)) + p


def enc_byte_array_stop(stop: int, content_id: int) -> bytes:
    p = bytes([stop]) + write_itf8(content_id)
    return write_itf8(C_BYTE_ARRAY_STOP) + write_itf8(len(p)) + p


def enc_byte_array_len_ext(len_id: int, val_id: int) -> bytes:
    le = enc_external(len_id)
    ve = enc_external(val_id)
    p = le + ve
    return write_itf8(C_BYTE_ARRAY_LEN) + write_itf8(len(p)) + p


def enc_byte_array_len(len_enc: bytes, val_enc: bytes) -> bytes:
    """BYTE_ARRAY_LEN with arbitrary nested length/value encodings
    (already serialized as codec+len+params blobs)."""
    p = len_enc + val_enc
    return write_itf8(C_BYTE_ARRAY_LEN) + write_itf8(len(p)) + p


def enc_huffman(lens_by_symbol: Dict[int, int]) -> bytes:
    """Canonical HUFFMAN params: alphabet + code lengths (the decoders
    reconstruct codes in (len, symbol) order — Encoding.__init__)."""
    syms = sorted(lens_by_symbol)
    p = write_itf8(len(syms)) + b"".join(write_itf8(s) for s in syms)
    p += write_itf8(len(syms)) + b"".join(
        write_itf8(lens_by_symbol[s]) for s in syms)
    return write_itf8(C_HUFFMAN) + write_itf8(len(p)) + p


def enc_beta(offset: int, nbits: int) -> bytes:
    p = write_itf8(offset) + write_itf8(nbits)
    return write_itf8(C_BETA) + write_itf8(len(p)) + p


def enc_gamma(offset: int) -> bytes:
    p = write_itf8(offset)
    return write_itf8(C_GAMMA) + write_itf8(len(p)) + p


def enc_subexp(offset: int, k: int) -> bytes:
    p = write_itf8(offset) + write_itf8(k)
    return write_itf8(C_SUBEXP) + write_itf8(len(p)) + p


def enc_golomb(offset: int, m: int) -> bytes:
    p = write_itf8(offset) + write_itf8(m)
    return write_itf8(C_GOLOMB) + write_itf8(len(p)) + p


def gamma_write(core: "BitWriter", v: int, offset: int) -> None:
    u = v + offset
    if u < 1:
        raise ValueError("gamma value + offset must be >= 1")
    z = u.bit_length() - 1
    core.write_bits(0, z)
    core.write_bits(u, z + 1)


def subexp_write(core: "BitWriter", v: int, offset: int, k: int) -> None:
    u = v + offset
    if u < 0:
        raise ValueError("subexp value + offset must be >= 0")
    if u < (1 << k):
        core.write_bits(0, 1)
        core.write_bits(u, k)
    else:
        b = u.bit_length() - 1
        n = b - k + 1
        core.write_bits((1 << n) - 1, n)
        core.write_bits(0, 1)
        core.write_bits(u & ((1 << b) - 1), b)


def golomb_write(core: "BitWriter", v: int, offset: int, m: int) -> None:
    u = v + offset
    if u < 0:
        raise ValueError("golomb value + offset must be >= 0")
    q, r = divmod(u, m)
    core.write_bits((1 << q) - 1, q)
    core.write_bits(0, 1)
    b = (m - 1).bit_length()
    if b:
        t = (1 << b) - m
        if r < t:
            core.write_bits(r, b - 1)
        else:
            core.write_bits(r + t, b)


class BitWriter:
    """MSB-first bit accumulator — the write twin of BitReader; feeds
    the slice CORE block for HUFFMAN/BETA-coded data series."""

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.buf.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def getvalue(self) -> bytes:
        if self.nbits:
            return bytes(self.buf) + bytes([self.cur << (8 - self.nbits)])
        return bytes(self.buf)


def huffman_code_lengths(freqs: Dict[int, int]) -> Dict[int, int]:
    """Code length per symbol from frequencies (standard Huffman merge);
    a single-symbol alphabet gets length 0 (the spec's 0-bit case)."""
    import heapq

    if not freqs:
        raise ValueError("empty alphabet")
    if len(freqs) == 1:
        return {next(iter(freqs)): 0}
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(sorted(freqs.items()))]
    heapq.heapify(heap)
    lens = {s: 0 for s in freqs}
    tie = len(heap)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lens[s] += 1
        heapq.heappush(heap, (f1 + f2, tie, s1 + s2))
        tie += 1
    return lens


def canonical_codes(lens_by_symbol: Dict[int, int]) -> Dict[int, Tuple[int, int]]:
    """symbol -> (len, code) with the decoders' canonical convention:
    sequential codes assigned in (len, symbol) order."""
    order = sorted(lens_by_symbol.items(), key=lambda kv: (kv[1], kv[0]))
    codes: Dict[int, Tuple[int, int]] = {}
    code, prev_len = 0, 0
    for sym, l in order:
        code <<= l - prev_len
        codes[sym] = (l, code)
        code += 1
        prev_len = l
    return codes


# ---------------------------------------------------------------------------
# compression header

INT_SERIES = {"BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
              "NF", "TL", "FN", "FP", "DL", "RS", "PD", "HC", "MQ"}
BYTE_SERIES = {"BA", "QS", "BS", "FC"}
ARRAY_SERIES = {"RN", "IN", "SC", "BB", "QQ"}


class CompressionHeader:
    def __init__(self):
        self.pres: Dict[str, object] = {"RN": True, "AP": False, "RR": True}
        self.sub_matrix = b"\x00" * 5
        self.tag_dict: List[List[Tuple[bytes, int]]] = [[]]
        self.encodings: Dict[str, Encoding] = {}
        self.tag_encodings: Dict[int, Encoding] = {}

    @classmethod
    def parse(cls, data: bytes) -> "CompressionHeader":
        h = cls()
        off = 0
        # preservation map
        _size, off = read_itf8(data, off)
        nkeys, off = read_itf8(data, off)
        for _ in range(nkeys):
            key = data[off : off + 2].decode()
            off += 2
            if key in ("RN", "AP", "RR"):
                h.pres[key] = bool(data[off])
                off += 1
            elif key == "SM":
                h.sub_matrix = data[off : off + 5]
                off += 5
            elif key == "TD":
                blen, off = read_itf8(data, off)
                blob = data[off : off + blen]
                off += blen
                h.tag_dict = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    triples = []
                    for i in range(0, len(line), 3):
                        t = line[i : i + 3]
                        if len(t) == 3:
                            triples.append((t[:2], t[2]))
                    h.tag_dict.append(triples)
                if not h.tag_dict:
                    h.tag_dict = [[]]
            else:
                raise NotImplementedError(f"preservation key {key}")
        # data series encodings
        _size, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        for _ in range(n):
            key = data[off : off + 2].decode()
            off += 2
            codec, off = read_itf8(data, off)
            plen, off = read_itf8(data, off)
            h.encodings[key] = Encoding(codec, data[off : off + plen])
            off += plen
        # tag encodings
        _size, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        for _ in range(n):
            tkey, off = read_itf8(data, off)
            codec, off = read_itf8(data, off)
            plen, off = read_itf8(data, off)
            h.tag_encodings[tkey] = Encoding(codec, data[off : off + plen])
            off += plen
        return h

    def sub_base(self, ref_base: int, code: int) -> int:
        """Substituted base from the SM matrix: for reference base r, the
        byte's 2-bit fields rank the 4 alternatives in ACGTN order."""
        bases = b"ACGTN"
        try:
            ri = bases.index(ref_base)
        except ValueError:
            ri = 4
        byte = self.sub_matrix[ri]
        alts = [b for b in bases if b != bases[ri]]
        for i, alt in enumerate(alts):
            if ((byte >> (6 - 2 * i)) & 3) == code:
                return alt
        return ord("N")


# ---------------------------------------------------------------------------
# CRAM flags

BF_UNMAPPED = 0x4
CF_QS_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8


class CramRecordData:
    __slots__ = ("bf", "ri", "pos", "mapq", "read_len", "seq", "cigar",
                 "qual", "name", "tags")

    def __init__(self):
        self.bf = 0
        self.ri = -1
        self.pos = 0   # 0-based
        self.mapq = 0
        self.read_len = 0
        self.seq = b""
        self.cigar: List[Tuple[int, int]] = []
        self.qual = b""
        self.name = b""
        self.tags: List[Tuple[bytes, bytes, bytes]] = []  # (tag, type, raw value)


def _decode_slice_records(ch: CompressionHeader, slice_ref: int,
                          slice_start: int, n_records: int,
                          core: BitReader, ext: Dict[int, ExtStream],
                          ref_fetch) -> List[CramRecordData]:
    """Decode all records of one slice (CRAM 3.0 codec order; mirrors the
    spec's section 8.4 / htslib cram_decode)."""
    E = ch.encodings

    def rint(key):
        return E[key].read_int(core, ext)

    def rbyte(key):
        return E[key].read_byte(core, ext)

    def rbytes(key, n=None):
        return E[key].read_bytes(n, core, ext)

    out = []
    last_pos = slice_start
    for _ in range(n_records):
        r = CramRecordData()
        r.bf = rint("BF")
        cf = rint("CF")
        if slice_ref == -2:
            r.ri = rint("RI")
        else:
            r.ri = slice_ref
        r.read_len = rint("RL")
        ap = rint("AP")
        if ch.pres.get("AP"):
            pos1 = last_pos + ap
        else:
            pos1 = ap
        last_pos = pos1
        r.pos = pos1 - 1
        rint("RG")
        if ch.pres.get("RN"):
            r.name = rbytes("RN")
        if cf & CF_DETACHED:
            rint("MF")
            if not ch.pres.get("RN"):
                r.name = rbytes("RN")
            rint("NS"); rint("NP"); rint("TS")
        elif cf & CF_MATE_DOWNSTREAM:
            rint("NF")
        tl = rint("TL")
        for (tag, typ) in ch.tag_dict[tl]:
            tkey = (tag[0] << 16) | (tag[1] << 8) | typ
            enc = ch.tag_encodings[tkey]
            raw = enc.read_bytes(None, core, ext)
            r.tags.append((tag, bytes([typ]), raw))
        if not (r.bf & BF_UNMAPPED):
            fn = rint("FN")
            feats = []
            fpos = 0
            for _f in range(fn):
                fc = rbyte("FC")
                fpos += rint("FP")
                feats.append((fc, fpos))
            # re-walk features reading payloads in order
            seq = bytearray(r.read_len)
            qual = bytearray(b"\xff" * r.read_len)
            cigar: List[Tuple[int, int]] = []
            rp = 1           # 1-based read position
            ref_p = r.pos    # 0-based reference position

            def add_cigar(op, ln):
                if ln <= 0:
                    return
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + ln)
                else:
                    cigar.append((op, ln))

            def copy_ref(upto):  # fill read positions [rp, upto) from ref
                nonlocal rp, ref_p
                n = upto - rp
                if n <= 0:
                    return
                refseq = ref_fetch(r.ri, ref_p, ref_p + n)
                seq[rp - 1 : rp - 1 + n] = refseq
                add_cigar(0, n)
                rp += n
                ref_p += n

            for (fc, fp) in feats:
                copy_ref(fp)
                c = chr(fc)
                if c == "b":
                    b = rbytes("BB")
                    seq[rp - 1 : rp - 1 + len(b)] = b
                    add_cigar(0, len(b))
                    rp += len(b)
                    ref_p += len(b)
                elif c == "X":
                    code = rbyte("BS")
                    refb = ref_fetch(r.ri, ref_p, ref_p + 1)
                    seq[rp - 1] = ch.sub_base(refb[0] if refb else ord("N"), code)
                    add_cigar(0, 1)
                    rp += 1
                    ref_p += 1
                elif c == "B":
                    seq[rp - 1] = rbyte("BA")
                    qual[rp - 1] = rbyte("QS")
                    add_cigar(0, 1)
                    rp += 1
                    ref_p += 1
                elif c == "i":
                    seq[rp - 1] = rbyte("BA")
                    add_cigar(1, 1)
                    rp += 1
                elif c == "I":
                    b = rbytes("IN")
                    seq[rp - 1 : rp - 1 + len(b)] = b
                    add_cigar(1, len(b))
                    rp += len(b)
                elif c == "S":
                    b = rbytes("SC")
                    seq[rp - 1 : rp - 1 + len(b)] = b
                    add_cigar(4, len(b))
                    rp += len(b)
                elif c == "D":
                    add_cigar(2, rint("DL"))
                    ref_p += cigar[-1][1] if cigar[-1][0] == 2 else 0
                elif c == "N":
                    ln = rint("RS")
                    add_cigar(3, ln)
                    ref_p += ln
                elif c == "P":
                    add_cigar(6, rint("PD"))
                elif c == "H":
                    add_cigar(5, rint("HC"))
                elif c == "q":
                    b = rbytes("QQ")
                    qual[rp - 1 : rp - 1 + len(b)] = b
                elif c == "Q":
                    qual[rp - 1] = rbyte("QS")
                else:
                    raise NotImplementedError(f"CRAM feature {c!r}")
            copy_ref(r.read_len + 1)
            r.seq = bytes(seq)
            r.cigar = cigar
            r.mapq = rint("MQ")
            if cf & CF_QS_STORED:
                r.qual = rbytes("QS", r.read_len)
            else:
                r.qual = bytes(qual)
        else:
            seq = bytes(rbyte("BA") for _ in range(r.read_len))
            r.seq = seq
            r.cigar = []
            if cf & CF_QS_STORED:
                r.qual = rbytes("QS", r.read_len)
            else:
                r.qual = b"\xff" * r.read_len
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# container-level reader

_UNSET = object()  # CramReader._crai sentinel: index not probed yet


def read_crai(path: str):
    """Parse a .crai index (gzipped TSV, htslib flavor): one entry per
    (slice, reference) as (seq_id, start0, span, container_offset,
    slice_offset, slice_size). Alignment starts are 1-based in the file."""
    import gzip
    entries = []
    with gzip.open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            seq, start1, span, coff, soff, ssize = (
                int(x) for x in line.split("\t")[:6])
            entries.append((seq, max(start1 - 1, 0), span, coff, soff, ssize))
    return entries


def _cont_geometry(raw: bytes, off: int):
    """-> (landmarks, blocks_off, block_bytes) for the container at off."""
    (length,) = struct.unpack_from("<i", raw, off)
    hoff = off + 4
    for _ in range(4):
        _v, hoff = read_itf8(raw, hoff)
    _v, hoff = read_ltf8(raw, hoff)
    _v, hoff = read_ltf8(raw, hoff)
    _nb, hoff = read_itf8(raw, hoff)
    n_land, hoff = read_itf8(raw, hoff)
    landmarks = []
    for _ in range(n_land):
        lm, hoff = read_itf8(raw, hoff)
        landmarks.append(lm)
    hoff += 4  # crc
    return landmarks, hoff, length


def _slice_headers(raw: bytes, off: int):
    """Per-slice geometry + header fields of the container at `off`:
    [(s_ref, s_start1, s_span, s_nrec, slice_offset, slice_size)], where
    slice_offset is relative to the blocks region (htslib .crai column 5)
    and slice_size spans the slice header block through its last data
    block (column 6)."""
    landmarks, boff, length = _cont_geometry(raw, off)
    blocks_len = length  # container `length` counts the block-region bytes
    out = []
    for i, lm in enumerate(landmarks):
        end = landmarks[i + 1] if i + 1 < len(landmarks) else blocks_len
        blk, _ = read_block(raw, boff + lm)
        if blk.content_type != CT_SLICE_HEADER:
            continue
        sh = blk.data
        p = 0
        s_ref, p = read_itf8(sh, p)
        s_start, p = read_itf8(sh, p)
        s_span, p = read_itf8(sh, p)
        s_nrec, p = read_itf8(sh, p)
        out.append((s_ref, s_start, s_span, s_nrec, lm, end - lm))
    return out


def write_crai(cram_path: str, crai_path: Optional[str] = None,
               fasta_path: Optional[str] = None) -> str:
    """Build a .crai for a CRAM file (htslib layout: one gzipped TSV line
    per (slice, reference) — seq_id, 1-based start, span, container
    offset, slice offset within the block region, slice size). Single-ref
    slices index straight from their slice headers (no record decode);
    multi-ref slices (ref_id == -2) are expanded per reference by decoding
    the container, the same way htslib does."""
    import gzip
    crai_path = crai_path or cram_path + ".crai"
    cr = CramReader(cram_path, fasta_path)
    lines = []
    for off in cr.container_offsets():
        headers = _slice_headers(cr._raw, off)
        recs = None
        pos = 0
        for (s_ref, s_start, s_span, s_nrec, s_off, s_size) in headers:
            if s_ref == -2:  # multi-ref slice: expand per reference
                if recs is None:
                    # pos stays cumulative over all earlier slices
                    recs = list(cr.container_records(off))
                sl = recs[pos : pos + s_nrec]
                by_ref: Dict[int, list] = {}
                for r in sl:
                    if r.tid < 0:
                        by_ref.setdefault(-1, [0, 0])
                        continue
                    e = r.endpos()
                    cur = by_ref.get(r.tid)
                    if cur is None:
                        by_ref[r.tid] = [r.pos, e]
                    else:
                        cur[0] = min(cur[0], r.pos)
                        cur[1] = max(cur[1], e)
                for ref in sorted(by_ref):
                    lo, hi = by_ref[ref]
                    start1 = lo + 1 if ref >= 0 else 0
                    span = max(hi - lo, 0) if ref >= 0 else 0
                    lines.append(
                        f"{ref}\t{start1}\t{span}\t{off}\t{s_off}\t{s_size}")
            elif s_ref == -1:
                lines.append(f"-1\t0\t0\t{off}\t{s_off}\t{s_size}")
            else:
                lines.append(f"{s_ref}\t{s_start}\t{s_span}\t{off}\t{s_off}"
                             f"\t{s_size}")
            pos += s_nrec
    with gzip.open(crai_path, "wt") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return crai_path


class CramReader:
    """Whole-file CRAM reader yielding io.bam.BamRecord objects.

    fasta_path supplies the reference for sequence reconstruction (the
    same FASTA the tool already requires); slices with embedded reference
    blocks use those instead.
    """

    def __init__(self, path: str, fasta_path: Optional[str] = None):
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != b"CRAM":
            raise ValueError(f"{path}: not a CRAM file")
        self.major, self.minor = raw[4], raw[5]
        if (self.major, self.minor) not in ((3, 0), (3, 1)):
            if self.major == 2:
                raise NotImplementedError(
                    f"{path}: CRAM {self.major}.{self.minor} is a legacy "
                    "format this reader does not support; re-encode it as "
                    "CRAM 3.x or BAM (e.g. samtools view -C "
                    "--output-fmt-option version=3.0)")
            raise NotImplementedError(
                f"{path}: CRAM version {self.major}.{self.minor} is not "
                "supported (3.0 and 3.1 are)")
        off = 26  # magic + version + 20-byte file id
        # first container: file header (SAM header text)
        hdr_blocks, off = self._read_container(raw, off)
        sam_text = hdr_blocks[0].data
        # htslib may prefix the text with an int32 length
        if len(sam_text) >= 4:
            (tlen,) = struct.unpack_from("<i", sam_text, 0)
            if 0 <= tlen <= len(sam_text) - 4:
                sam_text = sam_text[4 : 4 + tlen]
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for line in sam_text.decode(errors="replace").splitlines():
            if line.startswith("@SQ"):
                name = ln = None
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        name = fld[3:]
                    elif fld.startswith("LN:"):
                        ln = int(fld[3:])
                if name is not None:
                    self.ref_names.append(name)
                    self.ref_lens.append(ln or 0)
        self.tid_by_name = {n: i for i, n in enumerate(self.ref_names)}
        self._raw = raw
        self._data_off = off
        self._path = path
        self._crai = _UNSET
        self._offsets = None
        self._cont_cache: Dict[int, list] = {}  # LRU, capped (see fetch)
        self._fasta = None
        if fasta_path:
            from .fasta import IndexedFasta
            self._fasta = IndexedFasta(fasta_path)

    @staticmethod
    def _read_container(raw: bytes, off: int):
        """-> (blocks, new_off); None blocks at EOF."""
        (length,) = struct.unpack_from("<i", raw, off)
        off += 4
        _ref_id, off = read_itf8(raw, off)
        _start, off = read_itf8(raw, off)
        _span, off = read_itf8(raw, off)
        _n_rec, off = read_itf8(raw, off)
        _counter, off = read_ltf8(raw, off)
        _bases, off = read_ltf8(raw, off)
        n_blocks, off = read_itf8(raw, off)
        n_land, off = read_itf8(raw, off)
        for _ in range(n_land):
            _lm, off = read_itf8(raw, off)
        off += 4  # crc
        blocks = []
        for _ in range(n_blocks):
            b, off = read_block(raw, off)
            blocks.append(b)
        return blocks, off

    def _ref_fetch_fn(self, embedded: Dict[int, bytes], slice_ref: int,
                      slice_start0: int):
        fasta = self._fasta
        names = self.ref_names

        def fetch(ri: int, s: int, e: int) -> bytes:
            if e <= s:
                return b""
            emb = embedded.get(ri)
            if emb is not None:
                off0 = s - slice_start0
                return emb[off0 : off0 + (e - s)]
            if fasta is None:
                return b"N" * (e - s)
            return fasta.fetch(names[ri], s, e).upper()

        return fetch

    def container_offsets(self):
        """File offsets of every data container (skips file header + EOF).
        Blocks are skipped structurally (no decompression); the walk is
        computed once and cached."""
        if self._offsets is not None:
            return self._offsets
        raw = self._raw
        off = self._data_off
        n = len(raw)
        out = []
        while off < n:
            if raw[off : off + 4] == b"\x0f\x00\x00\x00" and \
               raw[off : off + len(CRAM_EOF)] == CRAM_EOF:
                break
            out.append(off)
            (length,) = struct.unpack_from("<i", raw, off)
            hoff = off + 4
            for _ in range(3):
                _v, hoff = read_itf8(raw, hoff)
            _v, hoff = read_itf8(raw, hoff)
            _v, hoff = read_ltf8(raw, hoff)
            _v, hoff = read_ltf8(raw, hoff)
            n_blocks, hoff = read_itf8(raw, hoff)
            n_land, hoff = read_itf8(raw, hoff)
            for _ in range(n_land):
                _lm, hoff = read_itf8(raw, hoff)
            hoff += 4  # crc
            for _ in range(n_blocks):
                hoff = skip_block(raw, hoff)
            off = hoff
        self._offsets = out
        return out

    def records(self):
        for off in self.container_offsets():
            yield from self.container_records(off)

    def container_records(self, off):
        """Decode all records of the single data container starting at `off`."""
        raw = self._raw
        from .bam_writer import encode_record
        from .bam import _decode_record

        # container header
        (length,) = struct.unpack_from("<i", raw, off)
        hoff = off + 4
        ref_id, hoff = read_itf8(raw, hoff)
        start, hoff = read_itf8(raw, hoff)
        _span, hoff = read_itf8(raw, hoff)
        _n_rec, hoff = read_itf8(raw, hoff)
        _counter, hoff = read_ltf8(raw, hoff)
        _bases, hoff = read_ltf8(raw, hoff)
        n_blocks, hoff = read_itf8(raw, hoff)
        n_land, hoff = read_itf8(raw, hoff)
        for _ in range(n_land):
            _lm, hoff = read_itf8(raw, hoff)
        hoff += 4  # crc
        boff = hoff  # container length counts block bytes; we walk by count
        blocks = []
        for _ in range(n_blocks):
            b, boff = read_block(raw, boff)
            blocks.append(b)
        if not blocks:
            return
        if blocks[0].content_type != CT_COMP_HEADER:
            return  # skip containers we don't understand
        ch = CompressionHeader.parse(blocks[0].data)
        bi = 1
        while bi < len(blocks):
            if blocks[bi].content_type != CT_SLICE_HEADER:
                bi += 1
                continue
            sh = blocks[bi].data
            soff = 0
            s_ref, soff = read_itf8(sh, soff)
            s_start, soff = read_itf8(sh, soff)
            _s_span, soff = read_itf8(sh, soff)
            s_nrec, soff = read_itf8(sh, soff)
            _s_counter, soff = read_ltf8(sh, soff)
            s_nblocks, soff = read_itf8(sh, soff)
            n_ids, soff = read_itf8(sh, soff)
            for _ in range(n_ids):
                _cid, soff = read_itf8(sh, soff)
            emb_ref_id, soff = read_itf8(sh, soff)
            bi += 1
            core = BitReader(b"")
            ext: Dict[int, ExtStream] = {}
            embedded: Dict[int, bytes] = {}
            for k in range(s_nblocks):
                blk = blocks[bi + k]
                if blk.content_type == CT_CORE:
                    core = BitReader(blk.data)
                elif blk.content_type == CT_EXTERNAL:
                    if blk.content_id == emb_ref_id and emb_ref_id >= 0:
                        embedded[s_ref] = blk.data
                    ext[blk.content_id] = ExtStream(blk.data)
            bi += s_nblocks
            fetch = self._ref_fetch_fn(embedded, s_ref, s_start - 1)
            recs = _decode_slice_records(
                ch, s_ref, s_start, s_nrec, core, ext, fetch)
            for r in recs:
                tags = [(t, raw_v) for (t, typ, raw_v) in r.tags
                        if typ == b"Z"]
                buf = encode_record(
                    qname=r.name or b"*",
                    flag=r.bf, tid=r.ri, pos=r.pos, mapq=r.mapq,
                    cigar=r.cigar, seq=r.seq,
                    qual=r.qual if len(r.qual) == len(r.seq) else None,
                    tags=tags)
                yield _decode_record(buf[4:])

    def _load_crai(self):
        """Parse `<path>.crai` once; None when absent or unparseable (the
        reference only existence-checks the index, src/main.rs:530-535, so
        an invalid index degrades to the linear scan rather than erroring)."""
        if self._crai is not _UNSET:
            return self._crai
        self._crai = None
        try:
            entries = read_crai(self._path + ".crai")
            offsets = set(self.container_offsets())
            # sanity: every index entry must point at a real container
            if entries and all(e[3] in offsets for e in entries):
                self._crai = entries
        except Exception:
            self._crai = None
        return self._crai

    def containers_for_loci(self, loci):
        """Sorted offsets of containers whose .crai entries overlap ANY
        (chrom, start, end) locus — the batched form of the reference's
        per-variant fetch, for CRAM. None when no valid index exists."""
        entries = self._load_crai()
        if entries is None:
            return None
        wanted: Dict[int, list] = {}
        for chrom, s, e in loci:
            tid = self.tid_by_name.get(chrom)
            if tid is not None:
                wanted.setdefault(tid, []).append((s, e))
        offs = set()
        for seq, start0, span, coff, _soff, _ssize in entries:
            for s, e in wanted.get(seq, ()):
                if start0 < e and start0 + span > s:
                    offs.add(coff)
                    break
        return sorted(offs)

    def records_for_containers(self, offs):
        """Records of the given containers, each decoded once, in file
        order (a position-superset stream for downstream joins)."""
        for off in offs:
            yield from self.container_records(off)

    def fetch(self, chrom: str, start: int, end: int):
        """Region iteration. With a valid .crai, decodes only containers
        whose index entries overlap [start, end) (decoded containers are
        memoized across fetches); otherwise scans the whole file."""
        tid = self.tid_by_name.get(chrom)
        if tid is None:
            raise KeyError(f"chromosome {chrom} not in CRAM header")
        entries = self._load_crai()
        if entries is None:
            offs = self.container_offsets()
        else:
            offs = sorted({e[3] for e in entries
                           if e[0] == tid and e[1] < end and
                           e[1] + e[2] > start})
        for off in offs:
            recs = self._cont_cache.get(off)
            if recs is None:
                recs = list(self.container_records(off))
                # bounded LRU: fetches walk loci in coordinate order, so a
                # handful of recent containers covers the reuse without
                # pinning the whole file's decoded records in memory
                if len(self._cont_cache) >= 8:
                    self._cont_cache.pop(next(iter(self._cont_cache)))
                self._cont_cache[off] = recs
            else:  # refresh recency
                self._cont_cache.pop(off)
                self._cont_cache[off] = recs
            for rec in recs:
                if rec.tid == tid and rec.pos < end and rec.endpos() > start:
                    yield rec


# ---------------------------------------------------------------------------
# writer

_SERIES_IDS = {name: i + 1 for i, name in enumerate(
    ["BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS", "NF",
     "TL", "FN", "FC", "FP", "DL", "BB", "QQ", "BS", "BA", "QS", "IN", "SC",
     "HC", "PD", "RS", "MQ"])}
_TAG_ID_BASE = 100


def write_cram(path: str, refs: List[Tuple[str, int]], records,
               records_per_container: int = 10000,
               fasta_path: Optional[str] = None,
               block_method: str = "gzip",
               embed_ref: bool = False,
               codec_profile: str = "external",
               slices_per_container: int = 1,
               version: Optional[Tuple[int, int]] = None) -> None:
    """Write a CRAM 3.0/3.1 file from BamRecord-like objects (io/bam.py).

    Profile: multi-ref slices, absolute positions, read names preserved,
    every data series EXTERNAL, Z tags only. Without a reference,
    sequences are stored verbatim via 'b'/'I'/'S' features (RR=false);
    with fasta_path, aligned bases are encoded REFERENCE-BASED —
    implicit matches plus 'X' substitution features (the htslib-style
    profile, exercising the same decode path).

    block_method selects the data-block compressor: "gzip" (default),
    "rans0" or "rans1" (rANS 4x8 — htslib's default for short-read
    data; falls back per block when rANS doesn't shrink it), or the
    CRAM 3.1 rANS Nx16 family: "ransnx16" (order-0), "ransnx16o1",
    "ransnx16mix" (rotates order/PACK/RLE/X32/STRIPE per block — the
    decoder-hardening profile).

    version defaults to (3, 0), or (3, 1) automatically when an Nx16
    block_method is requested; passing (3, 0) with an Nx16 method is an
    error (method 5 only exists in 3.1).

    embed_ref=True (requires fasta_path) writes SINGLE-REF slices that
    carry their reference segment as an embedded block — the htslib
    "embedded reference" profile: such CRAMs decode with no external
    FASTA at all. Records are grouped by reference id.

    codec_profile="mixed" swaps in htslib-style codecs (canonical
    multi-symbol HUFFMAN, BETA positions, BYTE_ARRAY_LEN tags — core
    bits) and slices_per_container>1 emits multi-slice containers; see
    _write_data_container. Both exist to exercise the decoder paths
    real htslib files use.
    """
    recs = list(records)
    ref_fetch = None
    if fasta_path is not None:
        from .fasta import IndexedFasta
        fa = IndexedFasta(fasta_path)
        names = [n for n, _ in refs]
        ref_fetch = lambda ri, s, e: fa.fetch(names[ri], s, e).upper()
    if version is None:
        version = (3, 1) if block_method.startswith("ransnx16") else (3, 0)
    elif block_method.startswith("ransnx16") and tuple(version) < (3, 1):
        raise ValueError("rANS Nx16 blocks require CRAM version (3, 1)")
    out = bytearray()
    out += b"CRAM" + bytes(version) + path.encode()[:20].ljust(20, b"\x00")

    sam = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    hdr_block = write_block(Block(0, CT_FILE_HEADER, 0, sam.encode()))
    out += _container_header(len(hdr_block), ref_id=0, start=0, span=0,
                             n_rec=0, counter=0, bases=0, n_blocks=1,
                             landmarks=[0])
    out += hdr_block

    if embed_ref:
        if ref_fetch is None:
            raise ValueError("embed_ref requires fasta_path")
        # group into runs of a single reference id
        groups: List[List] = []
        for rec in recs:
            if groups and groups[-1][0].tid == rec.tid \
                    and len(groups[-1]) < records_per_container:
                groups[-1].append(rec)
            else:
                groups.append([rec])
        counter = 0
        for chunk in groups:
            out += _write_data_container(chunk, counter, ref_fetch,
                                         block_method,
                                         slice_ref=chunk[0].tid,
                                         codec_profile=codec_profile)
            counter += len(chunk)
    else:
        for cstart in range(0, max(len(recs), 1), records_per_container):
            chunk = recs[cstart : cstart + records_per_container]
            if not chunk and recs:
                break
            out += _write_data_container(
                chunk, cstart, ref_fetch, block_method,
                codec_profile=codec_profile,
                slices_per_container=slices_per_container)
            if not recs:
                break
    out += CRAM_EOF
    with open(path, "wb") as f:
        f.write(bytes(out))


def _container_header(length, ref_id, start, span, n_rec, counter, bases,
                      n_blocks, landmarks) -> bytes:
    h = struct.pack("<i", length)
    h += write_itf8(ref_id) + write_itf8(start) + write_itf8(span)
    h += write_itf8(n_rec) + write_ltf8(counter) + write_ltf8(bases)
    h += write_itf8(n_blocks) + write_itf8(len(landmarks))
    for lm in landmarks:
        h += write_itf8(lm)
    h += struct.pack("<I", 0)  # crc (unchecked by our reader)
    return h


def _write_data_container(chunk, counter, ref_fetch=None,
                          block_method: str = "gzip",
                          slice_ref: int = -2,
                          codec_profile: str = "external",
                          slices_per_container: int = 1) -> bytes:
    """One data container.

    codec_profile:
      * "external" (default): every data series EXTERNAL — the simple
        legal profile the engine has always written.
      * "mixed": htslib-style codec mix — BF/RL/TL canonical HUFFMAN
        (multi-symbol, bits in the CORE block), CF/RG single-symbol
        HUFFMAN (0-bit), AP BETA-coded, CB tag BYTE_ARRAY_LEN with a
        HUFFMAN length (core) + EXTERNAL values. Exercises the decoder
        paths real htslib files use (reference src/main.rs:530-535
        accepts arbitrary htslib CRAMs).

    slices_per_container > 1 splits the records into that many
    contiguous slices sharing one compression header (the htslib
    multi-slice layout; landmarks point at each slice header block).
    Single-ref / embedded-ref containers (slice_ref >= 0) always use
    one slice.
    """
    # ---- pre-pass: per-record tags, tag dictionary, TL indices --------
    rec_tags_l = []
    tag_lines: List[bytes] = []
    line_index: Dict[bytes, int] = {}
    tls: List[int] = []
    for rec in chunk:
        rec_tags = []
        for tag in (b"CB", b"UB"):
            v = rec.aux_string(tag)
            if v is not None:
                rec_tags.append((tag, v))
        rec_tags_l.append(rec_tags)
        line = b"".join(t + b"Z" for t, _v in rec_tags)
        if line not in line_index:
            line_index[line] = len(tag_lines)
            tag_lines.append(line)
        tls.append(line_index[line])

    tag_cids: Dict[int, int] = {}  # tkey -> content id (record order)

    def tag_cid(tkey: int) -> int:
        if tkey not in tag_cids:
            tag_cids[tkey] = _TAG_ID_BASE + len(tag_cids)
        return tag_cids[tkey]

    for rec_tags in rec_tags_l:
        for tag, _v in rec_tags:
            tag_cid((tag[0] << 16) | (tag[1] << 8) | ord("Z"))

    # ---- mixed/exotic profiles: build core-bit code tables ------------
    huff: Dict[str, Dict[int, Tuple[int, int]]] = {}
    huff_lens: Dict[str, Dict[int, int]] = {}
    beta: Dict[str, Tuple[int, int]] = {}
    exotic: Dict[str, tuple] = {}  # key -> ("gamma",off)|("subexp",off,k)|("golomb",off,m)
    cb_len_codes = None
    cb_len_lens: Dict[int, int] = {}
    if codec_profile in ("mixed", "exotic") and chunk:
        from collections import Counter

        def add_huff(key, freqs):
            huff_lens[key] = huffman_code_lengths(freqs)
            huff[key] = canonical_codes(huff_lens[key])

        add_huff("BF", Counter(r.flag for r in chunk))
        add_huff("RL", Counter(r.l_seq for r in chunk))
        add_huff("CF", {CF_QS_STORED: 1})   # single-symbol -> 0 bits
        add_huff("RG", {0: 1})
        add_huff("TL", Counter(tls))
        max_ap = max((r.pos + 1 for r in chunk), default=0)
        beta["AP"] = (0, max(1, int(max_ap).bit_length()))
        cb_freqs = Counter(len(v) for rt in rec_tags_l
                           for t, v in rt if t == b"CB")
        if cb_freqs:
            cb_len_lens = huffman_code_lengths(cb_freqs)
            cb_len_codes = canonical_codes(cb_len_lens)
        if codec_profile == "exotic":
            # the spec's remaining int codecs, on series whose value
            # ranges suit them: MQ/RS subexponential, FN/DL gamma
            # (FN can be 0 -> offset 1; DL >= 1), FP-delta golomb
            exotic["MQ"] = ("subexp", 0, 5)
            exotic["RS"] = ("subexp", 0, 4)
            exotic["FN"] = ("gamma", 1)
            exotic["DL"] = ("gamma", 0)
            exotic["FP"] = ("golomb", 0, 16)
    elif codec_profile != "external":
        raise ValueError(f"unknown codec_profile {codec_profile!r}")

    CB_TKEY = (ord("C") << 16) | (ord("B") << 8) | ord("Z")

    # ---- serialize one slice ------------------------------------------
    def build_slice(sub, tls_sub, tags_sub):
        streams: Dict[str, bytearray] = {k: bytearray() for k in _SERIES_IDS}
        tag_streams: Dict[int, bytearray] = {}
        core = BitWriter()

        def wi(key, v):
            if key in huff:
                l, code = huff[key][v]
                if l:
                    core.write_bits(code, l)
            elif key in beta:
                boff, nb = beta[key]
                core.write_bits(v + boff, nb)
            elif key in exotic:
                spec = exotic[key]
                if spec[0] == "gamma":
                    gamma_write(core, v, spec[1])
                elif spec[0] == "subexp":
                    subexp_write(core, v, spec[1], spec[2])
                else:
                    golomb_write(core, v, spec[1], spec[2])
            else:
                streams[key] += write_itf8(v)

        def wb(key, v):
            streams[key].append(v)

        def warr(key, b):
            streams[key] += b + b"\x00"

        n_bases = 0
        for rec, tl, rec_tags in zip(sub, tls_sub, tags_sub):
            wi("BF", rec.flag)
            wi("CF", CF_QS_STORED)
            if slice_ref == -2:
                wi("RI", rec.tid)
            wi("RL", rec.l_seq)
            wi("AP", rec.pos + 1)
            wi("RG", 0)
            warr("RN", rec.qname)
            wi("TL", tl)
            for tag, v in rec_tags:
                tkey = (tag[0] << 16) | (tag[1] << 8) | ord("Z")
                ts = tag_streams.setdefault(tkey, bytearray())
                if cb_len_codes is not None and tkey == CB_TKEY:
                    # BYTE_ARRAY_LEN: HUFFMAN length (core) + raw bytes
                    l, code = cb_len_codes[len(v)]
                    if l:
                        core.write_bits(code, l)
                    ts += v
                else:
                    ts += v + b"\x00"
            seq = rec.seq_bytes()
            n_bases += len(seq)
            if not (rec.flag & 0x4):
                feats = []
                rp = 1
                ref_p = rec.pos
                for op, ln in rec.cigar:
                    if op in (0, 7, 8):
                        if ref_fetch is not None:
                            # reference-based: implicit matches + X subs
                            refseq = ref_fetch(rec.tid, ref_p, ref_p + ln)
                            run = seq[rp - 1 : rp - 1 + ln]
                            for k in range(ln):
                                rb = refseq[k] if k < len(refseq) else 0
                                if k >= len(refseq) or run[k] != rb:
                                    # substitution code from the default
                                    # SM matrix (codes 0..3, ACGTN \ ref)
                                    bases = b"ACGTN"
                                    ri_ = bases.index(rb) if rb in bases else 4
                                    alts = [x for x in bases
                                            if x != bases[ri_]]
                                    code = (alts.index(run[k])
                                            if run[k] in alts else None)
                                    if code is None:
                                        feats.append(("B", rp + k, run[k]))
                                    else:
                                        feats.append(("X", rp + k, code))
                            ref_p += ln
                        else:
                            feats.append(("b", rp, seq[rp - 1 : rp - 1 + ln]))
                        rp += ln
                    elif op == 1:
                        feats.append(("I", rp, seq[rp - 1 : rp - 1 + ln]))
                        rp += ln
                    elif op == 4:
                        feats.append(("S", rp, seq[rp - 1 : rp - 1 + ln]))
                        rp += ln
                    elif op == 2:
                        feats.append(("D", rp, ln))
                        ref_p += ln
                    elif op == 3:
                        feats.append(("N", rp, ln))
                        ref_p += ln
                    elif op == 5:
                        feats.append(("H", rp, ln))
                    elif op == 6:
                        feats.append(("P", rp, ln))
                wi("FN", len(feats))
                # two passes matching the decoders' core-bit order (spec
                # 8.4 / htslib cram_decode): ALL (FC, FP) pairs first,
                # then the payload series — matters when FP and a
                # payload series are both core-bit coded
                prev = 0
                for c, fp, payload in feats:
                    wb("FC", ord(c))
                    wi("FP", fp - prev)
                    prev = fp
                for c, fp, payload in feats:
                    if c == "b":
                        warr("BB", payload)
                    elif c == "X":
                        wb("BS", payload)
                    elif c == "B":
                        wb("BA", payload)
                        wb("QS", 30)
                    elif c == "I":
                        warr("IN", payload)
                    elif c == "S":
                        warr("SC", payload)
                    elif c == "D":
                        wi("DL", payload)
                    elif c == "N":
                        wi("RS", payload)
                    elif c == "H":
                        wi("HC", payload)
                    elif c == "P":
                        wi("PD", payload)
                wi("MQ", rec.mapq)
                streams["QS"] += b"\x1e" * rec.l_seq
            else:
                streams["BA"] += seq
                streams["QS"] += b"\x1e" * rec.l_seq
        return streams, tag_streams, core, n_bases

    # ---- split records into slices ------------------------------------
    k = 1 if slice_ref >= 0 else max(1, int(slices_per_container))
    if chunk and k > 1:
        per = (len(chunk) + k - 1) // k
        parts = [(chunk[i : i + per], tls[i : i + per],
                  rec_tags_l[i : i + per])
                 for i in range(0, len(chunk), per)]
    else:
        parts = [(chunk, tls, rec_tags_l)]

    built = [build_slice(*p) for p in parts]

    # ---- compression header (shared across slices) --------------------
    pres = bytearray()
    pres += b"RN" + b"\x01"
    pres += b"AP" + b"\x00"
    pres += b"RR" + b"\x00"
    pres += b"SM" + b"\x1b" * 5
    td_blob = b"\x00".join(tag_lines) + b"\x00" if tag_lines else b"\x00"
    pres += b"TD" + write_itf8(len(td_blob)) + td_blob
    pres_full = write_itf8(5) + pres  # nkeys=5
    pres_block = write_itf8(len(pres_full)) + pres_full

    used = set()
    for streams, _ts, _core, _nb in built:
        used.update(key for key in _SERIES_IDS if streams[key])

    enc_entries = bytearray()
    n_enc = 0
    for key, sid in _SERIES_IDS.items():
        # core-coded series carry no external stream, so their entries
        # must be emitted unconditionally
        if (key not in used and key not in ("FN",)
                and key not in huff and key not in beta
                and key not in exotic):
            if key not in ("BF", "CF", "RI", "RL", "AP", "RG", "TL"):
                continue
        if key in huff:
            enc = enc_huffman(huff_lens[key])
        elif key in beta:
            enc = enc_beta(*beta[key])
        elif key in exotic:
            spec = exotic[key]
            if spec[0] == "gamma":
                enc = enc_gamma(spec[1])
            elif spec[0] == "subexp":
                enc = enc_subexp(spec[1], spec[2])
            else:
                enc = enc_golomb(spec[1], spec[2])
        elif key in ("RN", "BB", "QQ", "IN", "SC"):
            enc = enc_byte_array_stop(0, sid)
        else:
            enc = enc_external(sid)
        enc_entries += key.encode() + enc
        n_enc += 1
    enc_full = write_itf8(n_enc) + enc_entries
    enc_block = write_itf8(len(enc_full)) + enc_full

    tag_entries = bytearray()
    for tkey, cid in tag_cids.items():
        if cb_len_codes is not None and tkey == CB_TKEY:
            tag_entries += write_itf8(tkey) + enc_byte_array_len(
                enc_huffman(cb_len_lens), enc_external(cid))
        else:
            tag_entries += write_itf8(tkey) + enc_byte_array_stop(0, cid)
    tag_full = write_itf8(len(tag_cids)) + tag_entries
    tag_block = write_itf8(len(tag_full)) + tag_full

    ch_block = write_block(Block(0, CT_COMP_HEADER, 0,
                                 bytes(pres_block + enc_block + tag_block)))

    # ---- slices: header + core + external blocks ----------------------
    slice_bufs = []
    n_blocks_total = 1  # comp header
    total_bases = 0
    c_start0, c_span = 0, 0
    sub_counter = counter
    for (sub, _tls_sub, _tags_sub), (streams, tag_streams, core, n_bases) \
            in zip(parts, built):
        data_blocks = []
        content_ids = []
        for key, sid in _SERIES_IDS.items():
            if streams[key]:
                data_blocks.append(write_block(Block(0, CT_EXTERNAL, sid,
                                                     bytes(streams[key])),
                                               method_hint=block_method))
                content_ids.append(sid)
        for tkey, ts in tag_streams.items():
            cid = tag_cids[tkey]
            data_blocks.append(write_block(Block(0, CT_EXTERNAL, cid,
                                                 bytes(ts)),
                                           method_hint=block_method))
            content_ids.append(cid)
        core_block = write_block(Block(0, CT_CORE, 0, core.getvalue()),
                                 compress=False)

        s_start0, s_span, emb_ref_id = 0, 0, -1
        if slice_ref >= 0 and sub:
            s_start0 = min(r.pos for r in sub)
            s_end = max(r.endpos() for r in sub)
            s_span = max(s_end - s_start0, 0)
            c_start0, c_span = s_start0, s_span
            if ref_fetch is not None:
                # embedded reference: the slice's ref segment in-band
                EMB_CID = 99
                emb = ref_fetch(slice_ref, s_start0, s_end)
                data_blocks.append(write_block(
                    Block(0, CT_EXTERNAL, EMB_CID, bytes(emb)),
                    method_hint=block_method))
                content_ids.append(EMB_CID)
                emb_ref_id = EMB_CID

        shdr = bytearray()
        shdr += write_itf8(slice_ref)   # -2 = multi-ref slice
        shdr += write_itf8(s_start0 + 1 if slice_ref >= 0 else 0)
        shdr += write_itf8(s_span)
        shdr += write_itf8(len(sub))    # n_records
        shdr += write_ltf8(sub_counter)
        shdr += write_itf8(1 + len(data_blocks))  # core + externals
        shdr += write_itf8(len(content_ids))
        for cid in content_ids:
            shdr += write_itf8(cid)
        shdr += write_itf8(emb_ref_id)
        shdr += b"\x00" * 16           # md5
        slice_hdr_block = write_block(Block(0, CT_SLICE_HEADER, 0,
                                            bytes(shdr)))
        slice_bufs.append(slice_hdr_block + core_block
                          + b"".join(data_blocks))
        n_blocks_total += 2 + len(data_blocks)
        total_bases += n_bases
        sub_counter += len(sub)

    blocks = ch_block + b"".join(slice_bufs)
    landmarks = [len(ch_block)]
    for sb in slice_bufs[:-1]:
        landmarks.append(landmarks[-1] + len(sb))
    cont = _container_header(len(blocks), ref_id=slice_ref,
                             start=c_start0 + 1 if slice_ref >= 0 else 0,
                             span=c_span,
                             n_rec=len(chunk), counter=counter,
                             bases=total_bases, n_blocks=n_blocks_total,
                             landmarks=landmarks)
    return cont + blocks


def transcode_to_bam(cram_path: str, out_bam: str,
                     fasta_path: Optional[str] = None,
                     loci=None) -> int:
    """Decode a CRAM and write an equivalent BAM (used to feed the native
    columnar pipeline, which consumes BAM byte streams). With `loci`
    [(chrom, start, end)] and a valid .crai, only containers overlapping a
    locus are decoded/written — the CRAM analog of the BAM region fetch.
    Returns the number of records written."""
    from .bam_writer import encode_record, write_bam

    cr = CramReader(cram_path, fasta_path)
    source = cr.records()
    if loci is not None:
        offs = cr.containers_for_loci(loci)
        if offs is not None:
            source = cr.records_for_containers(offs)
    encoded = []
    for rec in source:
        tags = []
        for tag in (b"CB", b"UB"):
            v = rec.aux_string(tag)
            if v is not None:
                tags.append((tag, v))
        encoded.append(encode_record(
            qname=rec.qname, flag=rec.flag, tid=rec.tid, pos=rec.pos,
            mapq=rec.mapq, cigar=rec.cigar, seq=rec.seq_bytes(), tags=tags))
    write_bam(out_bam, list(zip(cr.ref_names, cr.ref_lens)), encoded,
              write_index=False)
    return len(encoded)
