"""The reference k-mer count of a read set and the solid set it gives:
canonical k-mers of every read, their counts, the abundance threshold
inferred from the count histogram, and the graph's branching nodes.
Plain torch on the run's device (k <= 31, so every k-mer is a positive
int64)."""

from __future__ import annotations

import numpy as np
import torch

HISTOGRAM_MAX = 10000
MIN_AUTO_THRESHOLD = 3


def _canonical_rows(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mers of every position of every row of base codes."""
    p = reads.shape[1] - k + 1
    c = reads.long()
    fwd = torch.zeros(reads.shape[0], p, dtype=torch.int64, device=reads.device)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        x = c[:, i:i + p]
        fwd = (fwd << 2) | x
        rc = rc | ((x ^ 2) << (2 * i))
    return torch.minimum(fwd, rc).reshape(-1)


def count_reads(read_chunks, k: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(sorted canonical k-mers, their counts) over chunks of (mate 1,
    mate 2) code arrays."""
    if not 3 <= k <= 31:
        raise ValueError(f"the reference counts k-mers of 3 to 31 bases, not {k}")
    parts = []
    for r1, r2 in read_chunks:
        for r in (r1, r2):
            parts.append(_canonical_rows(torch.from_numpy(np.ascontiguousarray(r)).to(device), k))
    keys, counts = torch.unique(torch.cat(parts), sorted=True, return_counts=True)
    return keys.cpu().numpy().view(np.uint64), counts.cpu().numpy().astype(np.int64)


def auto_cutoff(histogram: np.ndarray, min_auto_threshold: int = MIN_AUTO_THRESHOLD) -> int:
    """The abundance threshold of "-abundance-min auto": a frozen copy of
    the program's valley finder (the end of the error slope of the
    smoothed histogram, the coverage peak beyond it, and the least raw
    count between them, floored at 3)."""
    h = np.asarray(histogram, dtype=np.float64)
    n = h.shape[0]
    if n < 4 or h[1:].sum() == 0:
        return min_auto_threshold
    s = np.zeros(n)
    for i in range(1, n):
        lo, hi = max(1, i - 2), min(n - 1, i + 2)
        s[i] = h[lo:hi + 1].mean()
    valley_start = None
    for i in range(2, n - 1):
        if s[i] < s[i + 1]:
            valley_start = i
            break
    if valley_start is None:
        return min_auto_threshold
    peak = valley_start + int(np.argmax(s[valley_start:]))
    if peak <= valley_start:
        return max(valley_start, min_auto_threshold)
    cutoff = valley_start + int(np.argmin(h[valley_start:peak + 1]))
    return max(cutoff, min_auto_threshold)


def histogram(counts: np.ndarray) -> np.ndarray:
    return np.bincount(np.minimum(counts, HISTOGRAM_MAX), minlength=HISTOGRAM_MAX + 1)


def _revcomp(x: torch.Tensor, k: int) -> torch.Tensor:
    rc = torch.zeros_like(x)
    for _ in range(k):
        rc = (rc << 2) | ((x & 3) ^ 2)
        x = x >> 2
    return rc


def nb_branching(keys: np.ndarray, k: int, device) -> int:
    """Solid nodes whose in-degree or out-degree is not 1, each node taken
    in the orientation of its canonical k-mer."""
    if keys.size == 0:
        return 0
    km = torch.from_numpy(keys.view(np.int64)).to(device)
    mask = (1 << (2 * k)) - 1

    def member(x):
        x = torch.minimum(x, _revcomp(x, k))
        idx = torch.searchsorted(km, x).clamp_(max=km.numel() - 1)
        return (km[idx] == x).int()

    ind = torch.zeros_like(km, dtype=torch.int32)
    outd = torch.zeros_like(ind)
    for x in range(4):
        outd += member(((km << 2) | x) & mask)
        ind += member((km >> 2) | (x << (2 * (k - 1))))
    return int(((ind != 1) | (outd != 1)).sum())
