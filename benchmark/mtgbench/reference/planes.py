"""The per-position planes the reference automaton replays: for each
k-mer of the reference sequence, its membership in the solid set, the
in- and out-degree of its node, and whether its (k-1)-suffix and
(k-1)-prefix are repeated in the reference. Numpy, from the k-mer words
(words.py); torch on the run's device at k <= 62."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import words as W


@dataclass
class Planes:
    valid: list
    fwd: list
    contains: list
    nb_in: list
    nb_out: list
    suffix_rep: list
    prefix_rep: list

    def __len__(self):
        return len(self.valid)


def compute_planes(codes: np.ndarray, k: int, solid, repeats, device="cpu") -> Planes:
    """solid: KeySet of canonical k-mers (or anything that answers
    `contains(hi, lo)`); repeats: KeySet of canonical (k-1)-mers. `codes`
    holds no invalid base."""
    if k <= 31 and hasattr(solid, "contains_t"):
        return _planes_t(codes, k, solid, repeats, device)
    if 32 <= k <= 62 and hasattr(solid, "contains_pair_t"):
        return _planes_pair_t(codes, k, solid, repeats, device)
    hi, lo = W.forward(codes, k)
    member = solid.contains
    contains = member(*W.canonical(hi, lo, k))
    nb_out = np.zeros(lo.size, np.int32)
    nb_in = np.zeros(lo.size, np.int32)
    for x in range(4):
        nb_out += member(*W.canonical(*W.shift_out(hi, lo, k, x), k))
        nb_in += member(*W.canonical(*W.shift_in(hi, lo, k, x), k))
    nb_out = np.where(contains, nb_out, 0).astype(np.int32)
    nb_in = np.where(contains, nb_in, 0).astype(np.int32)
    km1 = k - 1
    suffix = W.low_bases(hi, lo, km1)
    prefix = W.low_bases(hi >> W.TWO, (lo >> W.TWO) | (hi << np.uint64(62)), km1)
    suffix_rep = repeats.contains(*W.canonical(*suffix, km1))
    prefix_rep = repeats.contains(*W.canonical(*prefix, km1))
    # python lists: the automaton reads them one position at a time
    return Planes(valid=[True] * lo.size, fwd=W.to_ints(hi, lo, k).tolist(),
                  contains=contains.tolist(), nb_in=nb_in.tolist(), nb_out=nb_out.tolist(),
                  suffix_rep=suffix_rep.tolist(), prefix_rep=prefix_rep.tolist())


def _planes_t(codes, k: int, solid, repeats, device) -> Planes:
    """The same planes in torch, for k <= 31."""
    fwd = W.forward_t(codes, k, device)
    member = solid.contains_t
    mask = (1 << (2 * k)) - 1
    contains = member(W.canonical_t(fwd, k))
    nb_out = torch.zeros_like(fwd, dtype=torch.int32)
    nb_in = torch.zeros_like(nb_out)
    for x in range(4):
        nb_out += member(W.canonical_t(((fwd << 2) | x) & mask, k))
        nb_in += member(W.canonical_t((fwd >> 2) | (x << (2 * (k - 1))), k))
    nb_out = torch.where(contains, nb_out, 0)
    nb_in = torch.where(contains, nb_in, 0)
    km1, mask1 = k - 1, (1 << (2 * (k - 1))) - 1
    suffix_rep = repeats.contains_t(W.canonical_t(fwd & mask1, km1))
    prefix_rep = repeats.contains_t(W.canonical_t((fwd >> 2) & mask1, km1))
    return Planes(valid=[True] * fwd.numel(), fwd=fwd.tolist(), contains=contains.tolist(),
                  nb_in=nb_in.tolist(), nb_out=nb_out.tolist(), suffix_rep=suffix_rep.tolist(),
                  prefix_rep=prefix_rep.tolist())


def _planes_pair_t(codes, k: int, solid, repeats, device) -> Planes:
    """The same planes in torch, for 32 <= k <= 62 (words.py's pairs). The
    reverse complement is taken once a position: a neighbour's, a
    (k-1)-mer's, follows from it by the mirrored shift."""
    a, b = W.forward_pair_t(codes, k, device)
    ra, rb = W.revcomp_pair_t(a, b, k)
    member = solid.contains_pair_t
    contains = member(*W.min_pair_t(a, b, ra, rb))
    nb_out = torch.zeros_like(a, dtype=torch.int32)
    nb_in = torch.zeros_like(nb_out)
    for x in range(4):
        nb_out += member(*W.min_pair_t(*W.shift_out_pair_t(a, b, k, x), *W.shift_in_pair_t(ra, rb, k, x ^ 2)))
        nb_in += member(*W.min_pair_t(*W.shift_in_pair_t(a, b, k, x), *W.shift_out_pair_t(ra, rb, k, x ^ 2)))
    nb_out = torch.where(contains, nb_out, 0)
    nb_in = torch.where(contains, nb_in, 0)
    km1 = k - 1
    suffix_rep = repeats.contains_pair_t(*W.min_pair_t(*W.low_bases_pair_t(a, b, km1), *W.shift_right_pair_t(ra, rb)))
    prefix_rep = repeats.contains_pair_t(*W.min_pair_t(*W.shift_right_pair_t(a, b), *W.low_bases_pair_t(ra, rb, km1)))
    fwd = [(x << 62) | y for x, y in zip(a.tolist(), b.tolist())]
    return Planes(valid=[True] * len(fwd), fwd=fwd, contains=contains.tolist(),
                  nb_in=nb_in.tolist(), nb_out=nb_out.tolist(), suffix_rep=suffix_rep.tolist(),
                  prefix_rep=prefix_rep.tolist())
