"""Scoring and aggregation split over the local devices.

The counterpart of the JAX package's parallel/mesh.py. Alignment problems
(a read against its ref and alt haplotype) are split on the read axis into
contiguous shards, one per device; each device scores its shard (sw_pair's
int8 call codes on a card, the plain version on the CPU) and sums partial
(variant, cell) count blocks (core/device_agg.count_block); the blocks are
linear in reads, so their sum on the first device (the JAX package's psum)
is the single-device result, whatever the placement. The haplotype matrix
is copied to every device.

make_mesh resolves --mesh-devices to the device list that
ops/sw_cuda.MeshSwBackend scores over on the driver's path;
build_sharded_step, as in the JAX package, is on no driver path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import device_agg
from ..ops import sw_cuda


def make_mesh(n_devices: Optional[int] = None,
              device: str = "cuda") -> List[torch.device]:
    """The devices of an n_devices-wide mesh: the first min(n, count) of
    the local CUDA devices for n > 0, every one of them for n of None, 0 or
    -1. With device "cpu", n parts on the CPU (one for None, 0 or -1), so
    that the split and the sum can be run without a card."""
    n = n_devices if n_devices is not None and n_devices > 0 else None
    if device == "cpu":
        return [torch.device("cpu")] * (n or 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is available")
    return [torch.device("cuda", i) for i in range(min(n or count, count))]


def build_sharded_step(devices: List[torch.device], n_rows: int,
                       n_cells: int):
    """Returns step(x [B, lx] uint8 (pad 0), hap_mat [H, ly] uint8 (pad 1),
    idx_ref [B], idx_alt [B], rows [B], cells [B], valid [B] bool) ->
    (counts int64 [n_rows, n_cells, 4], n_reads int64 scalar), both on
    devices[0]: the reads split into contiguous shards, one per device,
    each shard's calls and count block made on its device, and the blocks
    and valid-read counts summed. Arguments are numpy arrays."""

    def step(x_u8, hap_mat, idx_ref, idx_alt, rows, cells, valid):
        B = x_u8.shape[0]
        counts = n_reads = None
        for dev, (a, b) in zip(devices,
                               sw_cuda.split_rows(B, len(devices))):
            with sw_cuda.device_context(dev):
                xt, ht, irt, iat = sw_cuda.from_numpy(
                    x_u8[a:b], hap_mat, idx_ref[a:b], idx_alt[a:b], dev)
                calls = sw_cuda.pair_calls(xt, ht, irt, iat)
                v = torch.from_numpy(np.asarray(valid[a:b], bool)).to(dev)
                block = device_agg.count_block(
                    calls, torch.from_numpy(np.asarray(rows[a:b])).to(dev),
                    torch.from_numpy(np.asarray(cells[a:b])).to(dev), v,
                    n_rows, n_cells)
                part = v.sum(dtype=torch.int64)
            if counts is None:
                counts, n_reads = block, part
            else:
                counts = counts + block.to(devices[0])
                n_reads = n_reads + part.to(devices[0])
        if counts is None:
            return (torch.zeros((n_rows, n_cells, 4), dtype=torch.int64,
                                device=devices[0]),
                    torch.zeros((), dtype=torch.int64, device=devices[0]))
        return counts, n_reads

    return step


def pad_to_multiple(arrs, multiple: int, pad_values):
    """Pads each array's leading dim to a common multiple of `multiple`
    with its pad value -> (padded arrays, original length)."""
    n = arrs[0].shape[0]
    target = ((n + multiple - 1) // multiple) * multiple if n else multiple
    out = []
    for a, pv in zip(arrs, pad_values):
        pad = target - a.shape[0]
        if pad:
            padding = np.full((pad,) + a.shape[1:], pv, dtype=a.dtype)
            a = np.concatenate([a, padding], axis=0)
        out.append(a)
    return out, n
