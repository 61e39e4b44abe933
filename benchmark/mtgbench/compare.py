"""How far a job's output files are from the reference's: counts of the
lines, k-mers and values that differ (0 when they are equal)."""

from __future__ import annotations

import json
import os

import numpy as np


def lines_off(got: list[str] | None, want: list[str]) -> int:
    """Lines of `want` that `got` does not hold at the same place, plus
    the lines `got` has beyond `want`'s length; a missing file misses every
    line."""
    if got is None:
        return max(len(want), 1)
    n = max(len(got), len(want))
    return sum(1 for i in range(n) if i >= len(got) or i >= len(want) or got[i] != want[i])


def text_lines(text: str, skip_prefix: str | None = None) -> list[str]:
    return [line for line in text.splitlines() if not (skip_prefix and line.startswith(skip_prefix))]


def read_lines(path: str, skip_prefix: str | None = None) -> list[str] | None:
    """A file's lines (None when it is missing)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return text_lines(f.read(), skip_prefix)


def graph_off(path: str, keys: np.ndarray, counts: np.ndarray, info: dict) -> dict[str, int]:
    """The graph file a `find -in` job wrote against the reference's solid
    set: k-mers in one and not the other, shared k-mers whose counts differ,
    and info values that differ (solid k-mers, threshold, branching nodes).
    A missing or unreadable file misses everything."""
    try:
        with np.load(path, allow_pickle=False) as z:
            got_keys = np.asarray(z["kmers"]).view(np.uint64).reshape(-1)
            got_counts = np.asarray(z["counts"]).reshape(-1)
            got_info = json.loads(bytes(z["info"].tobytes()).decode())
    except (OSError, KeyError, ValueError):
        return {"kmers": max(int(keys.size), 1), "counts": max(int(keys.size), 1), "info": len(info)}
    both, gi, wi = np.intersect1d(got_keys, keys, assume_unique=True, return_indices=True)
    return {
        "kmers": int(got_keys.size + keys.size - 2 * both.size),
        "counts": int(np.count_nonzero(got_counts[gi] != counts[wi])),
        "info": sum(1 for name, value in info.items() if got_info.get(name) != value),
    }
