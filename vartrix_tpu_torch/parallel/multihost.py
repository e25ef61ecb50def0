"""Row-sharded runs across processes or hosts, and the merge of their
partial matrices.

The distribution unit is a contiguous range of variant rows — the same
sharding the reference applies across rayon threads (reference
src/main.rs:250-254), lifted to processes. Because shards own disjoint
matrix rows, merging is a concatenation of sparse triplets: no reduction,
and the result is CSR-equal to a single-process run.

Two modes:

  * Explicit shards, which need no fabric: `python -m vartrix_tpu_torch
    --num-shards N --shard-index i ...` computes rows [chunk*i,
    chunk*(i+1)) and writes a partial matrix, a valid Matrix Market file
    with the full dimensions but only the shard's entries; `python -m
    vartrix_tpu_torch.parallel.multihost OUT PART0 PART1 ...` concatenates
    them.
  * `--distributed ADDR:PORT,N,RANK` (or `auto`, torchrun's environment):
    the N processes join one torch.distributed group on the gloo backend,
    each computes the shard of its rank, and gather_triplets /
    gather_metrics bring the triplets and counters to rank 0, which alone
    writes the outputs. The collectives carry host arrays only; each rank
    scores on its own device.

Within a process, parallel/mesh.py and ops/sw_cuda.MeshSwBackend split each
row's reads over the local devices; the two compose.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from datetime import timedelta
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("vartrix")

# how long a collective waits for its peers before it raises: a lost
# process fails the run instead of hanging it. Ranks meet only to gather,
# so this also bounds how far one shard's scoring may trail another's.
DIST_TIMEOUT = timedelta(minutes=30)


def shard_range(num_vars: int, num_shards: int, shard_index: int) -> Tuple[int, int]:
    """Contiguous row range for a shard, using the reference's chunking
    rule (chunk = max(num_vars // num_shards, 1))."""
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard index {shard_index} outside [0, {num_shards})")
    chunk = max(num_vars // num_shards, 1)
    lo = min(chunk * shard_index, num_vars)
    hi = num_vars if shard_index == num_shards - 1 else min(chunk * (shard_index + 1), num_vars)
    return lo, hi


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Joins the torch.distributed group (gloo) at tcp://coordinator with
    num_processes members as process_id; with no arguments, from
    torchrun's environment (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). Returns (rank, world size)."""
    import torch.distributed as dist

    if coordinator is None:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=DIST_TIMEOUT)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=DIST_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


@contextmanager
def process_group(spec: Optional[str]):
    """(rank, world size) of the run for --distributed `spec`
    ("ADDR:PORT,N,RANK" or "auto"); (0, 1) without it. The group is
    destroyed when the block ends."""
    if spec is None:
        yield 0, 1
        return
    import torch.distributed as dist

    if spec == "auto":
        ids = init_distributed()
    else:
        addr, n, rank = spec.rsplit(",", 2)
        ids = init_distributed(addr, int(n), int(rank))
    try:
        yield ids
    finally:
        dist.destroy_process_group()


def gather_triplets(matrix, process_index: int, process_count: int,
                    root: int = 0):
    """Merges the processes' partial TriMats (disjoint rows) at `root`.

    The nnz counts are all-gathered as int64 first; then round p broadcasts
    process p's triplets in a buffer of exactly its nnz, so imbalanced
    shards cost only their own bytes. The payload is an int32 [4, n] block:
    row, col, and the f64 value bit-cast to two int32 words, exact for any
    value, NaN included. Only the root builds the merged matrix; the other
    processes return theirs untouched."""
    import torch
    import torch.distributed as dist

    from ..io.matrix_market import TriMat

    n_local = matrix.nnz()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count)]
    dist.all_gather(counts, torch.tensor([n_local], dtype=torch.int64))
    counts = [int(c) for c in counts]
    total = sum(counts)
    is_root = process_index == root
    if is_root:
        rows = np.empty(total, dtype=np.int64)
        cols = np.empty(total, dtype=np.int64)
        data = np.empty(total, dtype=np.float64)
    off = 0
    for p, n in enumerate(counts):
        if n == 0:
            continue
        buf = np.zeros((4, n), dtype=np.int32)
        if process_index == p:
            buf[0] = matrix.rows
            buf[1] = matrix.cols
            buf[2:] = np.ascontiguousarray(
                matrix.data, dtype=np.float64).view(np.int32).reshape(n, 2).T
        t = torch.from_numpy(buf)
        dist.broadcast(t, src=p)
        if is_root:
            rows[off : off + n] = buf[0]
            cols[off : off + n] = buf[1]
            data[off : off + n] = np.ascontiguousarray(
                buf[2:].T).view(np.float64)[:, 0]
        off += n
    if not is_root:
        return matrix
    merged = TriMat(matrix.shape)
    merged.add_triplets(rows, cols, data)
    return merged


def gather_metrics(metrics, process_count: int):
    """The Metrics counters summed over the processes (an all-gather of
    their int64 vectors)."""
    import torch
    import torch.distributed as dist

    from ..utils.metrics import Metrics

    own = metrics.as_dict()
    keys = sorted(own)
    vec = torch.tensor([own[k] for k in keys], dtype=torch.int64)
    parts = [torch.zeros_like(vec) for _ in range(process_count)]
    dist.all_gather(parts, vec)
    merged = Metrics()
    for k, v in zip(keys, torch.stack(parts).sum(dim=0).tolist()):
        setattr(merged, k, int(v))
    return merged


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
