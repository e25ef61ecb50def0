"""Cell-barcode list loading.

Mirrors the reference semantics (reference src/main.rs:697-735):
plain or gzipped file, one barcode per line, duplicates removed keeping the
FIRST occurrence, dense indices assigned in first-seen order.
"""

from __future__ import annotations

import gzip
import logging
import sys
from typing import Dict

log = logging.getLogger("vartrix")


def open_with_gz(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def load_barcodes(path: str) -> Dict[bytes, int]:
    data = open_with_gz(path)
    bc_set: Dict[bytes, int] = {}
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        # a trailing newline does not produce an extra (empty) line,
        # matching Rust's BufRead::lines
        lines.pop()
    for raw in lines:
        # BufRead::lines strips a trailing \r after splitting on \n
        line = raw[:-1] if raw.endswith(b"\r") else raw
        if line not in bc_set:
            bc_set[line] = len(bc_set)
    if len(bc_set) == 0:
        log.error("Loaded 0 barcodes. Is your barcode file gzipped or empty?")
        sys.exit(1)
    log.info("Loaded %d barcodes", len(bc_set))
    return bc_set


def write_barcodes(out_file: str, cell_barcodes: Dict[bytes, int]) -> None:
    """Write barcodes ordered by their dense index (src/main.rs:1181-1195)."""
    ordered = sorted(cell_barcodes.items(), key=lambda kv: kv[1])
    with open(out_file, "wb") as f:
        for bc, _ in ordered:
            f.write(bc + b"\n")
