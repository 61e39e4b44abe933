"""Least times of the port's kernels on an H100, counted from a run's own
inputs: the bytes each kernel's function must move, at the card's memory
rate, or its operations, at the card's rate for them. chip_smoke.py and
kernel_bench.py report them beside the times they measure."""

from __future__ import annotations

import torch

from .fill import walk_device as W
from .find import scan_device as S
from .ops import extmap as X

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SECTOR_BYTES = 32  # the least the card reads from device memory at a random address
# the bytes one K5 probe needs: two sectors of the cuckoo map, or one
# 128-byte bucket line
PROBE_BYTES = {"cuckoo": 2 * SECTOR_BYTES, "bucket": 128}
# int32 ALU operations outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K2's least int32 operations per DP cell, with scores shifted by 5 (i + j)
# so that up and left add nothing: the match compare, the diagonal's select
# and add, one three-way max (DPX), two tie compares, the match-count add
# and two selects
NW_OPS_PER_CELL = 9
# the count of the earlier records (diagonal kernel): the up and left adds,
# two two-way maxes and the loop bounds instead
NW_OPS_PER_CELL_12 = 12


def bytes_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def nw_bound_ms(cells: float, ops_per_cell: int = NW_OPS_PER_CELL) -> float:
    """K2's least time for `cells` DP cells, at `ops_per_cell` int32
    operations each."""
    return cells * ops_per_cell / INT32_OPS_PER_S * 1e3


def scan_probe_sectors(packed: torch.Tensor, badbits: torch.Tensor, qp: X.QMapP, k: int) -> int:
    """The random row sectors K1's function needs on one window (packed and
    badbits as scan_cls_qp takes them, qp from QMapP.to on their device):
    the first-choice row of each pair lookup, and the second-choice row of
    each lookup whose key is not in its first (in the second row, in the
    stash or absent)."""
    *_, keys = S.pair_keys(S.unpack_codes(packed, badbits), k)
    in_first, _, _ = X.qp_probe(qp, keys, 0)
    return keys.shape[0] + int((~in_first).sum())


def walk_bound_ms(n_app, status, lanes: int, steps: int, layout: str) -> float:
    """K5's least time for these walks: one probe per appended base, one
    for each walk's start node and one for each stop at a branching
    successor, each reading its sectors, plus the inputs and outputs."""
    probes = int(n_app.sum()) + int((n_app > 0).sum()) + int((status == W.STATUS_EVENT).sum())
    return bytes_ms(probes * PROBE_BYTES[layout] + lanes * (steps + 4 + 8 + 1 + 12))
