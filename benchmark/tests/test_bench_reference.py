"""The reference's planes in torch (k-mers as int64 pairs, 32 <= k <= 62)
equal its numpy planes, which compare words of any k <= 64: membership,
degrees and the repeat flags of every position."""

import numpy as np
import pytest
import torch

from tiny import cell  # first: it puts the benchmark on sys.path
from mtgbench import gen
from mtgbench.reference import planes as P
from mtgbench.reference import words as W


class NumpyOnly:
    """A solid set that answers only the numpy queries."""

    def __init__(self, keyset):
        self.contains = keyset.contains


@pytest.mark.parametrize("k", [32, 33, 45, 61, 62])
def test_pair_planes_equal_numpy_planes(k):
    cfg, _ = cell("ecoli_k45.find_graph", genome=6_000)
    ref, donor, _ins = gen.case_from_config(cfg, 2**31 + k)
    ref = np.concatenate([ref, ref[:300]])  # repeated (k-1)-mers
    # the donor's k-mers and the reference's but every seventh key:
    # branching nodes where they differ, absent k-mers among the rest
    hi, lo = (np.concatenate(w) for w in zip(W.canonical(*W.forward(donor, k), k),
                                             W.canonical(*W.forward(ref, k), k)))
    keys = np.unique(np.stack([hi, lo], axis=1), axis=0)
    keys = np.delete(keys, np.s_[::7], axis=0)
    solid = W.KeySet(keys[:, 0].copy(), keys[:, 1].copy(), k)
    repeats = W.count_kmers(ref, k - 1, 2)
    assert len(repeats) > 0
    got = P.compute_planes(ref, k, solid, repeats)
    want = P.compute_planes(ref, k, NumpyOnly(solid), repeats)
    assert got.fwd == want.fwd
    for name in ("contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep"):
        assert list(map(int, getattr(got, name))) == list(map(int, getattr(want, name))), name
    assert 0 < sum(got.contains) < len(got) and max(got.nb_out) > 1


def test_pair_membership_of_keys_that_share_a_word():
    ka = torch.tensor([0, 0, 0, 5, 5, 9])
    kb = torch.tensor([1, 4, 7, 0, 3, 2])
    qa = torch.tensor([0, 0, 0, 0, 5, 5, 5, 9, 9, 2, 10])
    qb = torch.tensor([0, 1, 4, 8, 0, 2, 3, 2, 3, 1, 0])
    want = [False, True, True, False, True, False, True, True, False, False, False]
    assert W.member_pair_t(ka, kb, qa, qb).tolist() == want
