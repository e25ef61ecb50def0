"""ctypes wrappers for libgenomio (csrc/genomio.cpp): parallel BAM decode
into columnar NumPy arrays (only the chunks of an indexed region plan, the
whole file, or an in-memory BAM stream), padded sequence gathers for the
scoring batches, and Matrix Market body formatting; and for libcramio
(native/cramio.cpp), which decodes a CRAM into such a stream.

One call decodes BGZF and all records into structure-of-arrays buffers
(positions, flags, decoded sequences, aligned-reference intervals, CB/UB
tag values) that the vectorized pipeline consumes. Its four loaders share
one set of passes: BGZF blocks listed serially and inflated in parallel,
records indexed by their sizes, then decoded in parallel. The whole-file
loader is the region loader over one chunk, from the first record to the
end of the file. The library is built from the checkout's source at first
use (ops/_build.py).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..ops._build import cramio_library, genomio_library

_lib: Optional[ctypes.CDLL] = None
_cram_lib: Optional[ctypes.CDLL] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)

# whole files of at least this many bytes decode through the bounded-memory
# loader: peak memory is the columns plus one segment, instead of the raw
# file, the inflated stream and the columns. Below it the monolithic loader
# is faster (the segment loader measured 5x slower on a 25 MB BAM).
STREAM_DECODE_BYTES = 256 * 1024 * 1024
# raw bytes per segment of that loader; 0 takes the library's 256 MiB, and
# the library raises anything below 1 MiB to 1 MiB
STREAM_SEGMENT_BYTES = 0


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(genomio_library())
        vp = ctypes.c_void_p
        lib.gio_bam_load.restype = vp
        lib.gio_bam_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.gio_bam_load_regions.restype = vp
        lib.gio_bam_load_regions.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, _I64P,
            ctypes.c_int64]
        lib.gio_bam_load_bytes.restype = vp
        lib.gio_bam_load_bytes.argtypes = [_U8P, ctypes.c_int64,
                                           ctypes.c_char_p, ctypes.c_int]
        lib.gio_bam_load_stream.restype = vp
        lib.gio_bam_load_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
        lib.gio_bam_free.argtypes = [vp]
        lib.gio_bam_error.restype = ctypes.c_char_p
        lib.gio_bam_error.argtypes = [vp]
        lib.gio_bam_n_records.restype = ctypes.c_int64
        lib.gio_bam_n_records.argtypes = [vp]
        lib.gio_bam_n_refs.restype = ctypes.c_int32
        lib.gio_bam_n_refs.argtypes = [vp]
        lib.gio_bam_ref_name.restype = ctypes.c_char_p
        lib.gio_bam_ref_name.argtypes = [vp, ctypes.c_int32]
        lib.gio_bam_ref_len.restype = ctypes.c_int32
        lib.gio_bam_ref_len.argtypes = [vp, ctypes.c_int32]
        for name in ("gio_bam_n_blocks", "gio_bam_blocks_thread_max"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [vp]
        ptr_specs = {
            "gio_bam_tid": ctypes.c_int32, "gio_bam_pos": ctypes.c_int32,
            "gio_bam_ref_end": ctypes.c_int32, "gio_bam_mapq": ctypes.c_uint8,
            "gio_bam_flag": ctypes.c_uint16, "gio_bam_seq_off": ctypes.c_int64,
            "gio_bam_seq_pool": ctypes.c_uint8, "gio_bam_itv_off": ctypes.c_int64,
            "gio_bam_itv_pool": ctypes.c_int32, "gio_bam_cb_off": ctypes.c_int64,
            "gio_bam_cb_pool": ctypes.c_uint8, "gio_bam_ub_off": ctypes.c_int64,
            "gio_bam_ub_pool": ctypes.c_uint8,
        }
        for name, ct in ptr_specs.items():
            getattr(lib, name).restype = ctypes.POINTER(ct)
            getattr(lib, name).argtypes = [vp]
        lib.gio_gather_padded.restype = None
        lib.gio_gather_padded.argtypes = [
            _U8P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int32, _U8P,
            ctypes.c_int]
        lib.gio_gather_padded_packed.restype = ctypes.c_int32
        lib.gio_gather_padded_packed.argtypes = [
            _U8P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int32, _U8P,
            _I32P, ctypes.c_int]
        lib.gio_gather_padded_packed2.restype = ctypes.c_int32
        lib.gio_gather_padded_packed2.argtypes = [
            _U8P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int32, _U8P,
            _I32P, ctypes.c_int]
        lib.gio_tag_lookup.restype = None
        lib.gio_tag_lookup.argtypes = [
            _U8P, _I64P, ctypes.c_int64, _U8P, _I64P, ctypes.c_int64,
            _I32P, ctypes.c_int32, _I32P, ctypes.c_int]
        lib.gio_tag_ids.restype = None
        lib.gio_tag_ids.argtypes = [_U8P, _I64P, ctypes.c_int64, _I64P,
                                    ctypes.c_int]
        lib.gio_mtx_format.restype = vp
        lib.gio_mtx_format.argtypes = [_I64P, _I64P, _F64P, ctypes.c_int64,
                                       ctypes.c_int]
        lib.gio_buf_data.restype = ctypes.c_void_p
        lib.gio_buf_data.argtypes = [vp]
        lib.gio_buf_len.restype = ctypes.c_int64
        lib.gio_buf_len.argtypes = [vp]
        lib.gio_buf_free.argtypes = [vp]
        _lib = lib
    return _lib


class CramDecodeError(RuntimeError):
    """libcramio's own report that it cannot decode a CRAM (a codec or
    feature it does not implement, or a malformed file)."""


def get_cram_lib() -> ctypes.CDLL:
    """libcramio, built at first use; a failed build raises."""
    global _cram_lib
    if _cram_lib is None:
        lib = ctypes.CDLL(cramio_library())
        vp = ctypes.c_void_p
        lib.cram_decode.restype = vp
        lib.cram_decode.argtypes = [ctypes.c_char_p, ctypes.c_char_p, _I64P,
                                    ctypes.c_int64, ctypes.c_int]
        lib.cram_bam_data.restype = _U8P
        lib.cram_bam_data.argtypes = [vp]
        lib.cram_bam_len.restype = ctypes.c_int64
        lib.cram_bam_len.argtypes = [vp]
        lib.cram_bam_error.restype = ctypes.c_char_p
        lib.cram_bam_error.argtypes = [vp]
        lib.cram_bam_free.argtypes = [vp]
        _cram_lib = lib
    return _cram_lib


def cram_decode_native(path: str, fasta_path: Optional[str],
                       offsets=None, n_threads: int = 0) -> np.ndarray:
    """Decode a CRAM into a raw (not BGZF) BAM byte stream, uint8 [n], with
    libcramio. offsets: container byte offsets to decode (the .crai plan;
    an empty list decodes none), or None for every container. Raises
    CramDecodeError with the library's message when it cannot decode the
    file."""
    lib = get_cram_lib()
    offp, noff = None, 0
    if offsets is not None:
        o = np.ascontiguousarray(offsets, dtype=np.int64)
        noff = len(o)
        if noff == 0:
            # an empty plan decodes nothing, unlike None (every container):
            # the pointer stays non-null so the library tells them apart
            o = np.zeros(1, dtype=np.int64)
        offp = o.ctypes.data_as(_I64P)
    h = lib.cram_decode(path.encode(), (fasta_path or "").encode(), offp,
                        ctypes.c_int64(noff), ctypes.c_int(_threads(n_threads)))
    try:
        err = lib.cram_bam_error(h)
        if err:
            raise CramDecodeError(f"native CRAM decode: {err.decode()}")
        n = int(lib.cram_bam_len(h))
        if n == 0:
            return np.zeros(0, np.uint8)
        # not ctypes.string_at, whose C int size cuts streams past 2 GB
        return np.ctypeslib.as_array(lib.cram_bam_data(h), shape=(n,)).copy()
    finally:
        lib.cram_bam_free(h)


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else (os.cpu_count() or 1)


def mtx_format_native(rows1: np.ndarray, cols1: np.ndarray,
                      vals: np.ndarray, n_threads: int = 0) -> bytes:
    """Format 'row col value' body lines (indices already 1-based), values
    printed like Rust's f64 Display (shortest round-trip, integral values
    bare, NaN as "NaN")."""
    lib = get_lib()
    r = np.ascontiguousarray(rows1, dtype=np.int64)
    c = np.ascontiguousarray(cols1, dtype=np.int64)
    v = np.ascontiguousarray(vals, dtype=np.float64)
    h = lib.gio_mtx_format(r.ctypes.data_as(_I64P), c.ctypes.data_as(_I64P),
                           v.ctypes.data_as(_F64P), ctypes.c_int64(len(r)),
                           ctypes.c_int(_threads(n_threads)))
    try:
        n = lib.gio_buf_len(h)
        return ctypes.string_at(lib.gio_buf_data(h), n) if n else b""
    finally:
        lib.gio_buf_free(h)


def gather_padded(seq_pool: np.ndarray, seq_off: np.ndarray,
                  read_ids: np.ndarray, lx: int,
                  n_threads: int = 0) -> np.ndarray:
    """Threaded [n, lx] uint8 padded gather from a flat pool (pad byte 0,
    rows truncated at lx)."""
    lib = get_lib()
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    out = np.empty((len(read_ids), lx), dtype=np.uint8)
    if len(read_ids) == 0:
        return out
    pool = np.ascontiguousarray(seq_pool, dtype=np.uint8)
    off = np.ascontiguousarray(seq_off, dtype=np.int64)
    lib.gio_gather_padded(
        pool.ctypes.data_as(_U8P), off.ctypes.data_as(_I64P),
        read_ids.ctypes.data_as(_I64P), ctypes.c_int64(len(read_ids)),
        ctypes.c_int32(lx), out.ctypes.data_as(_U8P),
        ctypes.c_int(_threads(n_threads)))
    return out


def gather_padded_packed(seq_pool: np.ndarray, seq_off: np.ndarray,
                         read_ids: np.ndarray, lx: int, n_threads: int = 0):
    """Threaded 4-bit packed gather: ([n, lx//2] uint8, two BAM nibble
    codes of `=ACMGRSVTWYHKDBN` per byte, high nibble first, [n] int32
    lengths), or None when lx is odd or any gathered byte lies outside
    those 16 symbols (the caller ships dense bytes)."""
    if lx % 2:
        return None
    lib = get_lib()
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    out = np.empty((len(read_ids), lx // 2), dtype=np.uint8)
    lens = np.empty(len(read_ids), dtype=np.int32)
    if len(read_ids) == 0:
        return out, lens
    pool = np.ascontiguousarray(seq_pool, dtype=np.uint8)
    off = np.ascontiguousarray(seq_off, dtype=np.int64)
    rc = lib.gio_gather_padded_packed(
        pool.ctypes.data_as(_U8P), off.ctypes.data_as(_I64P),
        read_ids.ctypes.data_as(_I64P), ctypes.c_int64(len(read_ids)),
        ctypes.c_int32(lx), out.ctypes.data_as(_U8P),
        lens.ctypes.data_as(_I32P), ctypes.c_int(_threads(n_threads)))
    if rc != 0:
        return None
    return out, lens


def gather_padded_packed2(seq_pool: np.ndarray, seq_off: np.ndarray,
                          read_ids: np.ndarray, lx: int,
                          n_threads: int = 0):
    """Threaded 2-bit packed gather: ([n, lx//4] uint8, four A/C/G/T codes
    per byte, low bits first, [n] int32 lengths), or None when lx % 4 != 0
    or any gathered byte is not A/C/G/T (the caller ships dense bytes)."""
    if lx % 4:
        return None
    lib = get_lib()
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int64)
    out = np.empty((len(read_ids), lx // 4), dtype=np.uint8)
    lens = np.empty(len(read_ids), dtype=np.int32)
    if len(read_ids) == 0:
        return out, lens
    pool = np.ascontiguousarray(seq_pool, dtype=np.uint8)
    off = np.ascontiguousarray(seq_off, dtype=np.int64)
    rc = lib.gio_gather_padded_packed2(
        pool.ctypes.data_as(_U8P), off.ctypes.data_as(_I64P),
        read_ids.ctypes.data_as(_I64P), ctypes.c_int64(len(read_ids)),
        ctypes.c_int32(lx), out.ctypes.data_as(_U8P),
        lens.ctypes.data_as(_I32P), ctypes.c_int(_threads(n_threads)))
    if rc != 0:
        return None
    return out, lens


class ColumnarBam:
    """Columnar view of a decoded BAM: the whole file, or (with `chunks`, an
    [n, 2] array of BAI/CSI virtual-offset ranges) only the records the
    indexed region plan touches, with memory bounded by the plan instead
    of the file size; or, with `bam_bytes` (a raw BAM stream, bytes or
    uint8 array: cram_decode_native's output), that stream, `path` then
    only naming the input in errors. `loader` names the decode taken:
    "bytes", "regions", "bounded" (the bounded-memory whole-file loader,
    from STREAM_DECODE_BYTES, which runs the same passes segment by
    segment) or "whole" (the region loader's passes over one chunk from the
    first record to the end of the file). Those two inflate the BGZF blocks
    of all their chunks across the threads: `blocks` is how many they
    inflated and `blocks_thread_max` the most any one thread inflated (both
    0 for the bounded and bytes loaders)."""

    def __init__(self, path: str, cb_tag: bytes = b"CB", n_threads: int = 0,
                 chunks=None, bam_bytes=None):
        lib = get_lib()
        self._lib = lib
        nt = _threads(n_threads)
        if bam_bytes is not None:
            arr = np.frombuffer(bam_bytes, dtype=np.uint8) if isinstance(
                bam_bytes, (bytes, bytearray)) else np.ascontiguousarray(
                    bam_bytes, dtype=np.uint8)
            self.loader = "bytes"
            self._h = lib.gio_bam_load_bytes(
                arr.ctypes.data_as(_U8P), ctypes.c_int64(len(arr)), cb_tag,
                nt)
        elif chunks is not None:
            c = np.ascontiguousarray(chunks, dtype=np.int64).reshape(-1, 2)
            self.loader = "regions"
            self._h = lib.gio_bam_load_regions(
                path.encode(), cb_tag, nt, c.ctypes.data_as(_I64P),
                ctypes.c_int64(len(c)))
        elif os.path.getsize(path) >= STREAM_DECODE_BYTES:
            self.loader = "bounded"
            self._h = lib.gio_bam_load_stream(
                path.encode(), cb_tag, nt,
                ctypes.c_int64(STREAM_SEGMENT_BYTES))
        else:
            self.loader = "whole"
            self._h = lib.gio_bam_load(path.encode(), cb_tag, nt)
        err = lib.gio_bam_error(self._h)
        if err:
            raise IOError(f"{path}: {err.decode()}")
        n = lib.gio_bam_n_records(self._h)
        self.n = int(n)
        n_refs = lib.gio_bam_n_refs(self._h)
        self.ref_names = [lib.gio_bam_ref_name(self._h, i).decode()
                          for i in range(n_refs)]
        self.ref_lens = [int(lib.gio_bam_ref_len(self._h, i))
                         for i in range(n_refs)]
        self.tid_by_name = {nm: i for i, nm in enumerate(self.ref_names)}
        self.blocks = int(lib.gio_bam_n_blocks(self._h))
        self.blocks_thread_max = int(lib.gio_bam_blocks_thread_max(self._h))

        def arr(name, count):
            if count == 0:
                # never dereference (possibly-NULL) empty buffers
                ct = getattr(lib, name).restype._type_
                return np.zeros(0, dtype=np.dtype(ct))
            return np.ctypeslib.as_array(getattr(lib, name)(self._h), (count,))

        self.tid = arr("gio_bam_tid", n)
        self.pos = arr("gio_bam_pos", n)
        self.ref_end = arr("gio_bam_ref_end", n)
        self.mapq = arr("gio_bam_mapq", n)
        self.flag = arr("gio_bam_flag", n)
        self.seq_off = arr("gio_bam_seq_off", n + 1)
        self.seq_pool = arr("gio_bam_seq_pool", int(self.seq_off[-1]) if n else 0)
        self.itv_off = arr("gio_bam_itv_off", n + 1)
        self.itv_pool = arr("gio_bam_itv_pool", int(self.itv_off[-1]) * 2 if n else 0)
        self.cb_off = arr("gio_bam_cb_off", n + 1)
        self.cb_pool = arr("gio_bam_cb_pool", int(self.cb_off[-1]) if n else 0)
        self.ub_off = arr("gio_bam_ub_off", n + 1)
        self.ub_pool = arr("gio_bam_ub_pool", int(self.ub_off[-1]) if n else 0)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gio_bam_free(self._h)
            self._h = None

    def cb_indices(self, barcodes: dict) -> np.ndarray:
        """Map each record's CB tag to a dense barcode index (-1 when the
        tag is absent, -2 when the barcode is not in the list)."""
        items = list(barcodes.items())
        keys = np.frombuffer(b"".join(k for k, _ in items), np.uint8)
        koff = np.zeros(len(items) + 1, np.int64)
        np.cumsum([len(k) for k, _ in items], out=koff[1:])
        kvals = np.fromiter((v for _, v in items), np.int32, count=len(items))
        out = np.empty(self.n, np.int32)
        self._lib.gio_tag_lookup(
            self.cb_pool.ctypes.data_as(_U8P), self.cb_off.ctypes.data_as(_I64P),
            ctypes.c_int64(self.n), keys.ctypes.data_as(_U8P),
            koff.ctypes.data_as(_I64P), ctypes.c_int64(len(items)),
            kvals.ctypes.data_as(_I32P), ctypes.c_int32(-2),
            out.ctypes.data_as(_I32P), ctypes.c_int(_threads(0)))
        return out

    def ub_ids(self) -> np.ndarray:
        """Map each record's UB tag to a per-file id (-1 = absent); equal
        tags share an id, which is all the UMI grouping needs."""
        out = np.empty(self.n, np.int64)
        self._lib.gio_tag_ids(
            self.ub_pool.ctypes.data_as(_U8P), self.ub_off.ctypes.data_as(_I64P),
            ctypes.c_int64(self.n), out.ctypes.data_as(_I64P),
            ctypes.c_int(_threads(0)))
        return out
