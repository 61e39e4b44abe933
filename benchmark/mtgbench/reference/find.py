"""The reference `find`: the repeat set, the planes and the automaton with
its observers, at the program's default flags (MindTheGap's documented
defaults: every variant kind but the backup breakpoints)."""

from __future__ import annotations

import io

import numpy as np

from . import observers as O
from . import words as W
from .automaton import ScanContext
from .kmers import canonical_int
from .planes import compute_planes


class RefGraph:
    """Point queries on a solid set (anything with `contains_int`)."""

    def __init__(self, solid, k: int):
        self.solid = solid
        self.k = k

    def contains_canon_int(self, canon: int) -> bool:
        return self.solid.contains_int(canon)

    def outdegree_int(self, fwd: int) -> int:
        k, mask = self.k, (1 << (2 * self.k)) - 1
        return sum(self.solid.contains_int(canonical_int(((fwd << 2) | x) & mask, k)) for x in range(4))

    def indegree_int(self, fwd: int) -> int:
        k = self.k
        return sum(self.solid.contains_int(canonical_int((fwd >> 2) | (x << (2 * (k - 1))), k))
                   for x in range(4))


def find(ref_codes: np.ndarray, chrom: str, seq: str, solid, k: int, cfg: dict, device="cpu"):
    """(the .breakpoints text, the VCF's record lines) of `find` over one
    reference sequence. `solid` answers `contains(hi, lo)` and
    `contains_int(canon)`; `cfg` holds the detection options."""
    min_occ = int(cfg["het_max_occ"]) + 1
    repeats = W.count_kmers_t(ref_codes, k - 1, min_occ, device) if k <= 31 else \
        W.count_kmers(ref_codes, k - 1, min_occ)
    planes = compute_planes(ref_codes, k, solid, repeats, device)
    bkpt, vcf = io.StringIO(), io.StringIO()
    ctx = ScanContext(RefGraph(solid, k), repeats, k, bkpt, vcf,
                      max_repeat=int(cfg["max_rep"]), snp_min_val=int(cfg["snp_min_val"]),
                      branching_threshold=int(cfg["branching_filter"]), homo_only=False)
    # registration order = priority, as the program's find registers them
    for obs in (O.FindSoloSNP, O.FindMultiSNP, O.FindMultiSNPrev, O.FindDeletion,
                O.FindSmallCleanInsertion, O.FindSmallFuzzyInsertion,
                O.FindCleanInsertion, O.FindFuzzyInsertion):
        ctx.add_gap_observer(obs(ctx))
    ctx.add_kmer_observer(O.FindHeteroInsertion(ctx))
    ctx.scan_sequence(chrom, seq, planes)
    return bkpt.getvalue(), vcf.getvalue()
