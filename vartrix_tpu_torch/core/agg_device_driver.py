"""The driver's aggregation on a device (--device-agg).

Takes the per-variant (cells, umis, codes) arrays of the native host path,
flattens them over the variants, and runs the calls, the scatter-add and
the UMI consensus on the device through core/device_agg.py. The host makes
only the dense integer group renumberings (np.unique) and takes the
counts back. The counterpart of the JAX package's core/agg_device_driver.py;
its output equals core/agg_numpy.aggregate_flat's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import device_agg
from .agg_numpy import _pack_shift, as_codes


def aggregate_on_device(
    cells_l: List[np.ndarray],
    umis_l: List[np.ndarray],
    scores_l: List[np.ndarray],
    use_umi: bool,
    device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (rows, cols, ref_count, alt_count, unk_count), int64, over every
    (variant, cell) group that saw at least one filter-surviving read,
    sorted by (row, col). scores_l entries are [n, 2] int32 scores or [n]
    int8 call codes (0-3); the sums run on `device`."""
    n_reads = sum(len(c) for c in cells_l)
    if n_reads == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    rows = np.concatenate([np.full(len(c), i, np.int64)
                           for i, c in enumerate(cells_l)])
    cells = np.concatenate(cells_l).astype(np.int64)
    calls = np.concatenate([as_codes(s) for s in scores_l])

    csh = _pack_shift(cells, rows, 24)
    cell_key = rows << csh | cells
    cg_uniq, cg = np.unique(cell_key, return_inverse=True)
    n_cg = len(cg_uniq)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    calls_d = dev(calls)
    cg_d = dev(cg)
    valid = torch.ones(n_reads, dtype=torch.bool, device=calls_d.device)
    counts4 = device_agg.grouped_counts(calls_d, cg_d, valid, n_cg)
    if use_umi:
        umis = np.concatenate(umis_l).astype(np.int64)
        # the key composes the dense cell-group index, so it fits int64
        # for any row count
        ush = _pack_shift(umis, np.array([n_cg - 1], np.int64), 30)
        ug_key = (cg.astype(np.int64) << ush) | umis
        ug_uniq, ug = np.unique(ug_key, return_inverse=True)
        counts3 = device_agg.umi_consensus_counts(
            calls_d, dev(ug), dev(ug_uniq >> ush), valid, len(ug_uniq), n_cg)
        counts = torch.cat([counts4[:, :1], counts3], dim=1).cpu().numpy()
    else:
        counts = counts4.cpu().numpy()
    # channel 0 (seen): a group exists once any read survived the filters,
    # even when every one of them was later dropped
    keep = counts[:, 0] > 0
    return ((cg_uniq >> csh)[keep], (cg_uniq & ((1 << csh) - 1))[keep],
            counts[keep, 1], counts[keep, 2], counts[keep, 3])
