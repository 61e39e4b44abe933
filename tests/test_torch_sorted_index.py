"""The bucket index of a sorted set (mindthegap_tpu_torch/ops/sorted_index.py,
through which K13's probe and K14 look keys up on the card) on the CPU: its
plain build and the plain bucketed lower bound equal torch.searchsorted +
clamp + equality and np.isin on every key set of K13's and K14's edge
cases (tests/torch_tables.py) and on skewed sets, at about 1, 2 and 4 keys
a bucket; the sector count of bounds.py on the lookups' own terms; and the
port's sorted-set plane pass equal to the JAX package's on a skewed set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.find import scan_device as JS
from mindthegap_tpu_torch import bounds as B
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.ops import kmers as PK
from mindthegap_tpu_torch.ops import sorted_index as SI
from mindthegap_tpu_torch.parallel import sharded_membership as PSM
from torch_tables import (INDEX_EDGE_NAMES, MEMBER_EDGE_NAMES, SORTED_EDGE_NAMES, index_edge_sets, member_edge_cases,
                          sorted_edge_windows)

CPU = torch.device("cpu")
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
HALVINGS = (0, 1, 2)  # the index's bucket count halved 0, 1, 2 times: about 1, 2 and 4 keys a bucket
PLANES = ("fwd", "valid", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep")


def _queries(keys: np.ndarray, extra: np.ndarray, seed: int) -> np.ndarray:
    """The set's keys and their neighbours, 0, SENTINEL and its neighbour,
    random words over the whole u64 range, and `extra`."""
    rng = np.random.default_rng(seed)
    one = np.uint64(1)
    return np.concatenate([keys, keys + one, keys - one, [np.uint64(0), SENT, SENT - one],
                           rng.integers(0, 1 << 64, 500, dtype=np.uint64), extra])


def _check_index(keys: np.ndarray, q: np.ndarray):
    """For each bucket count: the plain bucketed lower bound equals
    np.searchsorted, and its verdict equals torch.searchsorted + clamp +
    equality (K13's plain probe) and np.isin."""
    t, tq = torch.from_numpy(PK.as_i64(keys)), torch.from_numpy(PK.as_i64(q))
    isin = np.isin(q, keys)
    for halve in HALVINGS:
        log_b = max(1, SI.log_buckets(keys.size) - halve)
        index = SI.build(t) if halve == 0 else SI._build_plain(t, log_b)
        assert index.start.dtype == torch.int32 and index.start.shape[0] == (1 << log_b) + 1
        lb = SI._lower_bound_plain(t, index, tq)
        np.testing.assert_array_equal(lb.numpy(), np.searchsorted(keys, q))
        if keys.size:
            found = t[lb.clamp(max=keys.size - 1)] == tq
            np.testing.assert_array_equal(found.numpy(), PSM._probe_plain(tq, t).numpy() != 0)
            np.testing.assert_array_equal(found.numpy(), isin)


@pytest.mark.parametrize("name", MEMBER_EDGE_NAMES)
def test_index_on_member_edge_sets(name):
    """Every owner's shard of K13's edge cases, SENTINEL padding included,
    and the whole key set, queried with the case's own queries."""
    keys, q, n, cap_factor = member_edge_cases()[name]
    sm = PSM.ShardedMembership([CPU] * n, keys, cap_factor=cap_factor)
    for o, shard in enumerate(sm.shard_keys):
        _check_index(PK.as_u64(shard), _queries(PK.as_u64(shard), q, o))
    _check_index(keys, _queries(keys, q, n))


@pytest.mark.parametrize("k", [2, 3, 31, 32])
@pytest.mark.parametrize("name", SORTED_EDGE_NAMES)
def test_index_on_sorted_edge_sets(name, k):
    """K14's solid and repeat sets of each edge window, queried with the
    window's canonical k-mers and (k-1)-mers."""
    codes, solid, repeat = sorted_edge_windows(k)[name]
    fwd, _ = PK.kmers_from_codes(codes[: max(codes.size, k)], k)
    words = np.concatenate([PK.canonical_u64(fwd, k), PK.canonical_u64(fwd & PK.kmer_mask(k - 1), k - 1)])
    for keys in (solid, repeat):
        _check_index(keys, _queries(keys, words, k))


def _skewed_sets():
    rng = np.random.default_rng(12)
    one = np.uint64(1)
    cluster = np.arange(500, dtype=np.uint64) + np.uint64(77)
    uniform = np.unique(rng.integers(0, 1 << 62, 2000, dtype=np.uint64))
    return {
        "one-far-key": np.append(cluster, np.uint64((1 << 64) - 2)),
        "far-key-below": np.insert(cluster + np.uint64(1 << 62), 0, one),
        "range-below-buckets-k2": np.repeat(np.arange(16, dtype=np.uint64), 16),  # every 2-mer word, 256 keys
        "high-keys": np.unique(rng.integers(1 << 63, (1 << 64) - 1, 1500, dtype=np.uint64)),
        "both-halves": np.unique(np.concatenate([uniform[:700], rng.integers(1 << 63, 1 << 64, 700,
                                                                                  dtype=np.uint64)])),
        "sentinel-tail-1": np.append(uniform, [SENT]),
        "sentinel-tail-2": np.append(uniform, [SENT] * 2),
        "sentinel-tail-3": np.append(uniform, [SENT] * 3),
        "single-key": uniform[5:6],
        "single-key-and-tail": np.append(uniform[5:6], [SENT] * 2),
        "all-sentinel": np.array([SENT] * 3),
        "empty": np.zeros(0, np.uint64),
        "duplicates": np.sort(np.concatenate([uniform[::10], uniform[::10], uniform[::30]])),
        "adjacent-pairs": np.sort(np.concatenate([uniform, uniform + one])),
    }


SKEWED = tuple(_skewed_sets())


@pytest.mark.parametrize("name", SKEWED)
def test_index_on_skewed_sets(name):
    """Sets that skew the index: one far key above (or below) a cluster; a
    range smaller than the bucket count at k = 2; keys of 2^63 and above,
    alone and with low keys; SENTINEL tails of one to three keys, after a
    set, after a single key and alone; a single key; no key; duplicates;
    adjacent keys. Queries below lo and above hi and SENTINEL queries
    among them (_queries)."""
    keys = _skewed_sets()[name]
    assert np.all(keys[:-1] <= keys[1:])
    _check_index(keys, _queries(keys, np.zeros(0, np.uint64), 3))


def _numpy_index(keys: np.ndarray, log_b: int):
    """The index by numpy alone: n_real by np.searchsorted for SENTINEL, the
    bucket numbers in uint64, the starts by np.searchsorted of 0..B."""
    real = int(np.searchsorted(keys, SENT))
    if real == 0:
        return np.zeros((1 << log_b) + 1, np.int64), [-1, 0, 0, 0]
    lo, hi = keys[0], keys[real - 1]
    shift = max(0, int(hi - lo).bit_length() - log_b)
    buckets = (keys[:real] - lo) >> np.uint64(shift)
    start = np.searchsorted(buckets, np.arange((1 << log_b) + 1, dtype=np.uint64))
    return start, [int(PK.as_i64(np.array([lo]))[0]), int(PK.as_i64(np.array([hi]))[0]), shift, real]


@pytest.mark.parametrize("name", INDEX_EDGE_NAMES)
def test_build_plain_matches_numpy_on_index_edge_sets(name):
    """The plain build equals the index made by numpy alone (_numpy_index)
    on the build kernel's edge sets (tests/torch_tables.py
    index_edge_sets), at about 1 and 4 keys a bucket and at 2 buckets; the
    plain lookups hold on the smaller sets."""
    keys = index_edge_sets()[name]
    t = torch.from_numpy(PK.as_i64(keys))
    for log_b in (SI.log_buckets(keys.size), max(1, SI.log_buckets(keys.size) - 2), 1):
        got = SI._build_plain(t, log_b)
        start, head = _numpy_index(keys, log_b)
        np.testing.assert_array_equal(got.start.numpy(), start)
        assert got.head.tolist() == head
    if keys.size <= 200_000:
        _check_index(keys, _queries(keys[:2000], np.zeros(0, np.uint64), 5))


def test_index_header_and_starts():
    """The header holds lo, hi (the last key below SENTINEL), the shift and
    n_real; every bucket number is below B; a SENTINEL tail is outside the
    range and a set of SENTINEL alone has the empty range."""
    keys = np.array([10, 10, 11, 40, 1 << 40, SENT, SENT], np.uint64)
    index = SI.build(torch.from_numpy(PK.as_i64(keys)))
    lo, hi, shift, real = index.head.tolist()
    assert (lo, hi, real) == (10, 1 << 40, 5)
    log_b = SI.log_buckets(keys.size)
    assert ((1 << 40) - 10) >> shift < 1 << log_b <= ((1 << 40) - 10) >> max(shift - 1, 0)
    assert index.start[0] == 0 and index.start[-1] == real and bool((index.start.diff() >= 0).all())
    empty = SI.build(torch.from_numpy(PK.as_i64(np.array([SENT, SENT]))))
    assert empty.head.tolist() == [-1, 0, 0, 0] and not empty.start.any()
    assert [SI.log_buckets(n) for n in (0, 1, 4_668_000, 1 << 40)] == [1, 1, 22, 30]


def test_lookup_sectors_count_the_lookups_steps():
    """bounds.sorted_lookup_sectors: no sector outside [lo, hi]; one index
    sector and one key sector for a lookup in a short bucket; a bucket
    longer than the first loads adds a sector a bisection step."""
    keys = np.arange(0, 4096, 4, dtype=np.uint64)  # 1,024 keys, 4 apart: at 1 a bucket, buckets of one key
    t = torch.from_numpy(PK.as_i64(keys))
    index = SI._build_plain(t, 10)
    assert B.sorted_lookup_sectors(t, index, torch.tensor([-1, 5000], dtype=torch.int64)) == 0
    inside = torch.from_numpy(PK.as_i64(keys[:7]))  # buckets 0-6: one index sector each
    assert B.sorted_lookup_sectors(t, index, inside) == 2 * 7
    far = np.append(np.arange(100, dtype=np.uint64), np.uint64(1 << 50))  # 100 keys in bucket 0
    tf = torch.from_numpy(PK.as_i64(far))
    findex = SI._build_plain(tf, 2)
    assert B.sorted_lookup_sectors(tf, findex, torch.tensor([1], dtype=torch.int64)) == 2  # in the first 4 keys
    assert B.sorted_lookup_sectors(tf, findex, torch.tensor([99], dtype=torch.int64)) > 2 + 5  # bisection of 96


@pytest.mark.parametrize("name", ["one-far-key", "sentinel-tail"])
def test_scan_planes_sorted_matches_jax_on_skewed_sets(name):
    """The port's plane pass over sorted sets (K14's plain version on the
    CPU) equals the JAX package's scan_planes_device on a window over
    skewed sets (every k-mer but one in the first bucket; a SENTINEL tail)."""
    k = 31
    codes, solid, repeat = sorted_edge_windows(k)[name]
    want = JS.scan_planes_device(jnp.asarray(codes), jnp.asarray(solid), jnp.asarray(repeat), k)
    got = PS.scan_planes_sorted(torch.from_numpy(codes), *(torch.from_numpy(PK.as_i64(s)) for s in (solid, repeat)), k)
    for key in PLANES:
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if key == "fwd" else g, np.asarray(want[key]), err_msg=key)
    assert got["contains"].any()
