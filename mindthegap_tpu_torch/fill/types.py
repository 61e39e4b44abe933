"""Shared fill-module types (reference src/Utils.hpp:42-104)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.nw import nw_identity
from ..utils import dna


@dataclass
class FilledInsertion:
    """filled_insertion_t (src/Utils.hpp:46-104)."""

    seq: str
    nb_errors_in_anchor: int
    target_id: tuple  # (name, isRc) = bkpt_t
    avg_coverage: float = 0.0
    median_coverage: float = 0.0
    qual: int = 0
    solution_count: int = 0
    solution_rank: int = 0

    def reverse(self):
        self.seq = dna.revcomp(self.seq)

    def compute_qual(self, is_anchor_repeated: bool):
        quality = 50
        if is_anchor_repeated:
            quality = 25
        if self.solution_count > 1:
            quality = 15
        if self.nb_errors_in_anchor == 1:
            quality = 10
        if self.nb_errors_in_anchor == 2:
            quality = 5
        self.qual = quality


@dataclass(frozen=True)
class InfoNode:
    """info_node_t (src/Filler.hpp:44-72): a contig-graph node containing a
    target anchor."""

    node_id: int
    pos: int  # position of the beginning of the right anchor in the node
    nb_errors: int
    target_id: tuple  # (name, isRc)


def remove_almost_identical_solutions(consensuses: list[FilledInsertion], identity_threshold: int):
    """Greedy >=threshold%-identity dedup keeping the min-anchor-error
    representative (src/Utils.cpp:208-238). Mutates-and-returns the list."""
    final_set: list[FilledInsertion] = [consensuses[0]]
    for it_a in consensuses:
        found_similar = False
        for it_b in final_set:
            if it_a.seq == it_b.seq or nw_identity(it_a.seq, it_b.seq) * 100 >= identity_threshold:
                if it_a.nb_errors_in_anchor < it_b.nb_errors_in_anchor:
                    it_b.seq = it_a.seq
                    it_b.nb_errors_in_anchor = it_a.nb_errors_in_anchor
                found_similar = True
                break
        if not found_similar:
            final_set.append(it_a)
    return final_set


def median(values: list[int]) -> float:
    """nth_element median (src/Utils.cpp:241-254)."""
    v = sorted(values)
    n = len(v) // 2
    if len(v) % 2 == 1:
        return float(v[n])
    return 0.5 * (v[n] + v[n - 1])
