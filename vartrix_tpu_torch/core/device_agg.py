"""Calls and (variant, cell) aggregation on a device: tensor versions of the
host logic in core/calls.py, the counterpart of the JAX package's
core/device_agg.py.

Given each read's (ref, alt) scores or call code with its (variant row,
cell) or dense group ids, the functions below form the call codes and sum
them into per-group counts with `index_add_` on the tensors' device.
Counts are linear in reads, so partial counts of different read shards
merge by addition (parallel/mesh.build_sharded_step). Every sum runs in
an int64 accumulator: integer sums are exact in any order, and no group
can overflow it.

UMI consensus runs on the device too (umi_consensus_counts): the calls of
each (variant, cell, umi) group are summed, called with the exact integer
test 4*count >= 3*total, and the per-UMI calls summed per (variant, cell)
group. The dense group ids are integer renumberings made on the host
(core/agg_device_driver.py).
"""

from __future__ import annotations

import torch

from ..constants import MIN_SCORE


def calls_from_scores(ref_scores: torch.Tensor,
                      alt_scores: torch.Tensor) -> torch.Tensor:
    """Each read's call (reference src/main.rs:1019-1030) as int32 codes:
    0 dropped (both scores below MIN_SCORE), 1 REF, 2 ALT, 3 UNKNOWN (a
    tie)."""
    dropped = (ref_scores < MIN_SCORE) & (alt_scores < MIN_SCORE)
    code = torch.where(ref_scores > alt_scores, 1,
                       torch.where(alt_scores > ref_scores, 2, 3))
    return torch.where(dropped, 0, code).to(torch.int32)


def _features(calls: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int64 [N, 4] (seen, ref, alt, unk) one-hots; 0 on invalid rows."""
    onehot = torch.nn.functional.one_hot(calls.long(), 4)
    onehot[:, 0] = 1  # seen: every filter-surviving read, dropped or not
    return onehot * valid.to(torch.int64)[:, None]


def _segment_sum(feats: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros((n,) + feats.shape[1:], dtype=torch.int64,
                      device=feats.device)
    return out.index_add_(0, seg.long(), feats)


def count_block(calls: torch.Tensor, rows: torch.Tensor, cells: torch.Tensor,
                valid: torch.Tensor, n_rows: int, n_cells: int
                ) -> torch.Tensor:
    """int64 [n_rows, n_cells, 4] (seen, ref, alt, unk) counts per (variant,
    cell) of codes 0-3 `calls` [N] at `rows`, `cells` [N], for the `valid`
    [N] reads (False: padding). Channel 0 counts every read that survived
    the filters, the MIN_SCORE-dropped ones too: it gives the reference's
    explicit zero entries in the coverage and alt_frac modes."""
    seg = rows.long() * n_cells + cells.long()
    flat = _segment_sum(_features(calls, valid), seg, n_rows * n_cells)
    return flat.reshape(n_rows, n_cells, 4)


def grouped_counts(calls: torch.Tensor, gid: torch.Tensor,
                   valid: torch.Tensor, n_groups: int) -> torch.Tensor:
    """int64 [n_groups, 4] (seen, ref, alt, unk) counts per dense (variant,
    cell) group id `gid` [N]: count_block's sparse form, for the path
    without UMIs."""
    return _segment_sum(_features(calls, valid), gid, n_groups)


def umi_consensus_counts(calls: torch.Tensor, umi_group: torch.Tensor,
                         cell_of_group: torch.Tensor, valid: torch.Tensor,
                         n_umi_groups: int, n_cell_groups: int
                         ) -> torch.Tensor:
    """UMI consensus (reference src/main.rs:1041-1088) -> int64
    [n_cell_groups, 3] (ref, alt, unk) counts.

    1. Sum the surviving calls per (variant, cell, umi) group (`umi_group`
       [N], dense ids);
    2. call each UMI group ALT, else REF, when that call's share of its
       reads (unknowns in the denominator) is at least 0.75, else UNKNOWN;
       a group with no surviving read makes no call;
    3. sum the UMI groups' calls per (variant, cell) group
       (`cell_of_group` [n_umi_groups])."""
    onehot = torch.nn.functional.one_hot(calls.long(), 4)[:, 1:]
    onehot = onehot * valid.to(torch.int64)[:, None]
    per_umi = _segment_sum(onehot, umi_group, n_umi_groups)
    ref, alt, unk = per_umi.unbind(1)
    tot = ref + alt + unk
    # frac >= 0.75 as exact integers: the reference's f64 fractions of
    # integer counts compare the same
    ucall = torch.where(4 * alt >= 3 * tot, 1,
                        torch.where(4 * ref >= 3 * tot, 0, 2))
    uonehot = torch.nn.functional.one_hot(ucall, 3)
    uonehot = uonehot * (tot > 0).to(torch.int64)[:, None]
    return _segment_sum(uonehot, cell_of_group, n_cell_groups)


def consensus_values(counts: torch.Tensor) -> torch.Tensor:
    """[..., 4] counts -> float32 consensus values (0: no entry): ref and
    alt 3, alt 2, ref 1 (reference src/main.rs:1111-1129)."""
    ref, alt = counts[..., 1], counts[..., 2]
    v = torch.where((ref > 0) & (alt > 0), 3,
                    torch.where(alt > 0, 2, torch.where(ref > 0, 1, 0)))
    return v.to(torch.float32)


def coverage_values(counts: torch.Tensor):
    """-> (alt counts, ref counts, has_entry), float32, float32, bool."""
    return (counts[..., 2].to(torch.float32),
            counts[..., 1].to(torch.float32), counts[..., 0] > 0)


def alt_frac_values(counts: torch.Tensor):
    """-> (alt / (ref + alt + unk) float32, NaN where every read was
    dropped (0/0, as the reference's f64); has_entry bool)."""
    ref, alt, unk = (counts[..., k].to(torch.float32) for k in (1, 2, 3))
    return alt / (ref + alt + unk), counts[..., 0] > 0
