"""Row-sharded runs across processes or hosts, and the merge of their
partial matrices.

The distribution unit is a contiguous range of variant rows — the same
sharding the reference applies across rayon threads (reference
src/main.rs:250-254), lifted to processes. Because shards own disjoint
matrix rows, merging is a concatenation of sparse triplets: no reduction,
and the result is CSR-equal to a single-process run.

`python -m vartrix_tpu_torch --num-shards N --shard-index i ...` computes
rows [chunk*i, chunk*(i+1)) and writes a partial matrix: a valid Matrix
Market file with the full dimensions but only the shard's entries.
`python -m vartrix_tpu_torch.parallel.multihost OUT PART0 PART1 ...`
concatenates them. Touches no device.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

log = logging.getLogger("vartrix")


def shard_range(num_vars: int, num_shards: int, shard_index: int) -> Tuple[int, int]:
    """Contiguous row range for a shard, using the reference's chunking
    rule (chunk = max(num_vars // num_shards, 1))."""
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard index {shard_index} outside [0, {num_shards})")
    chunk = max(num_vars // num_shards, 1)
    lo = min(chunk * shard_index, num_vars)
    hi = num_vars if shard_index == num_shards - 1 else min(chunk * (shard_index + 1), num_vars)
    return lo, hi


def _mtx_header(path: str):
    """-> (rows, cols, nnz, body_offset) of a MatrixMarket file, reading
    only the header lines."""
    with open(path, "rb") as f:
        off = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            off += len(line)
            s = line.strip()
            if not s or s.startswith(b"%"):
                continue
            parts = s.split()
            return int(parts[0]), int(parts[1]), int(parts[2]), off


def merge_partials(out_path: str, partial_paths: List[str]) -> None:
    """Concatenate partial MatrixMarket files (full dims, disjoint rows)
    into one, streaming: partial bodies are already formatted triplet
    lines and triplet order is insignificant (comparisons are
    CSR-canonical, like the reference's tests), so the merge is a header
    rewrite plus raw body concatenation, O(total bytes) with O(chunk)
    memory. Validates consistent dimensions."""
    heads = [_mtx_header(p) for p in partial_paths]
    shape = heads[0][:2]
    for p, h in zip(partial_paths, heads):
        if h[:2] != shape:
            raise ValueError(f"{p}: shape {h[:2]} != {shape}")
    nnz = sum(h[2] for h in heads)
    with open(out_path, "wb") as out:
        out.write(b"%%MatrixMarket matrix coordinate real general\n")
        out.write(b"% written by sprs\n")
        out.write(f"{shape[0]} {shape[1]} {nnz}\n".encode())
        for p, h in zip(partial_paths, heads):
            with open(p, "rb") as f:
                f.seek(h[3])
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    out.write(chunk)
    log.info("Merged %d partial matrices (%d entries) into %s",
             len(partial_paths), nnz, out_path)


def merge_main(argv: Optional[List[str]] = None) -> None:
    """CLI: python -m vartrix_tpu_torch.parallel.multihost OUT PARTIAL
    [PARTIAL ...]"""
    import argparse

    p = argparse.ArgumentParser(
        prog="vartrix-merge",
        description="Merge partial matrices from sharded vartrix runs")
    p.add_argument("out", help="Merged output .mtx")
    p.add_argument("partials", nargs="+", help="Partial .mtx files")
    args = p.parse_args(argv)
    merge_partials(args.out, args.partials)


if __name__ == "__main__":
    merge_main()
