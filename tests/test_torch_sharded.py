"""Sharded membership (K12 and K13's plain versions) and sharded counting
(K11's) against the JAX package, exactly, on the CPU: the JAX side on the
8 virtual CPU devices of tests/conftest.py (or a mesh of as many devices
as the port's), the port on logical shards of the CPU; with an empty key
set and forced capacity overflows (the exact host routes). The JAX
ShardedStreamingCounter is held to the host StreamingCounter on the same
synthetic reads."""

import numpy as np
import pytest
import torch

from mindthegap_tpu.ops import counting as JC
from mindthegap_tpu.parallel import mesh as JM
from mindthegap_tpu.parallel import sharded_count as JSC
from mindthegap_tpu.parallel import sharded_membership as JSM
from mindthegap_tpu_torch.ops import bloom as PB
from mindthegap_tpu_torch.ops import counting as PC
from mindthegap_tpu_torch.ops import kmers as PK
from mindthegap_tpu_torch.parallel import sharded_count as PSC
from mindthegap_tpu_torch.parallel import sharded_membership as PSM
from torch_tables import (MEMBER_EDGE_NAMES, ROUTE_EDGE_NAMES, SWIZZLE_EDGE_NAMES, member_edge_cases, route_edge_cases,
                          swizzle_edge_chunks)

CPU = torch.device("cpu")
SHARDS = (1, 2, 8)
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _logical(n):
    return [CPU] * n


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("cap_factor", [1.25, 0.0], ids=["cap", "overflow"])
def test_sharded_membership_matches_jax(n, cap_factor):
    """Present and absent keys (Bloom false positives among them) on n
    shards; at cap_factor 0 every owner overflows its 64 slots and the batch
    takes the exact host route."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 61, size=1 << 13, dtype=np.uint64))
    q = np.concatenate([rng.choice(keys, 3000), rng.integers(0, 1 << 61, size=3000, dtype=np.uint64)])
    rng.shuffle(q)
    want = np.asarray(JSM.ShardedMembership(JM.make_mesh(n), keys, cap_factor=cap_factor).contains(q))
    got = PSM.ShardedMembership(_logical(n), keys, cap_factor=cap_factor).contains(q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.isin(q, keys))


@pytest.mark.parametrize("name", MEMBER_EDGE_NAMES)
def test_sharded_membership_edge_cases(name):
    """K12 and K13's edge cases (tests/torch_tables.py member_edge_cases)
    against np.isin and the JAX package on a mesh of as many devices; an
    empty key set answers absent everywhere, as test_device.py holds the
    JAX package."""
    keys, q, n, cap_factor = member_edge_cases()[name]
    got = PSM.ShardedMembership(_logical(n), keys, cap_factor=cap_factor).contains(q)
    np.testing.assert_array_equal(got, np.isin(q, keys))
    np.testing.assert_array_equal(got, np.asarray(JSM.ShardedMembership(JM.make_mesh(n), keys,
                                                                        cap_factor=cap_factor).contains(q)))
    if name == "empty-set":
        assert not got.any()


@pytest.mark.parametrize("name", MEMBER_EDGE_NAMES + ROUTE_EDGE_NAMES)
def test_route_plain_orders_lanes_by_owner(name):
    """K12's plain version against a numpy statement of the JAX routing:
    per owner, its Bloom-positive lanes in ascending order (JAX's argsort is
    stable) up to cap, padded with (SENTINEL, -1); the overflow flag; then
    K13's plain probe and scatter give np.isin on the routed lanes. On the
    edge cases of K12 and K13, and on K12's at 64 shards (route_edge_cases)."""
    keys, q, n, cap_factor = {**member_edge_cases(), **route_edge_cases()}[name]
    sm = PSM.ShardedMembership(_logical(n), keys, cap_factor=cap_factor)
    rows, cap = sm.batch(q)
    bf = PB.build(keys if keys.size else np.zeros(1, np.uint64))
    bounds = sm._bounds
    for j in range(n):
        send_q, send_lane, overflow = PSM._route_plain(*sm.route_args(j, rows, cap))
        send_q, send_lane = PK.as_u64(send_q).reshape(n, cap), send_lane.numpy().reshape(n, cap)
        owner = np.clip(np.searchsorted(bounds, rows[j], side="right") - 1, 0, n - 1)
        owner = np.where(PB.contains(bf, rows[j]), owner, n)
        for o in range(n):
            lanes = np.flatnonzero(owner == o)
            m = min(lanes.size, cap)
            np.testing.assert_array_equal(send_lane[o, :m], lanes[:m])
            np.testing.assert_array_equal(send_q[o, :m], rows[j][lanes[:m]])
            assert (send_lane[o, m:] == -1).all() and (send_q[o, m:] == SENT).all()
        assert int(overflow) == int(any((owner == o).sum() > cap for o in range(n)))
        shard = sm._host_keys  # every shard's keys, SENTINEL padding included
        verdicts = PSM._probe_plain(torch.from_numpy(PK.as_i64(send_q.reshape(-1))),
                                    torch.from_numpy(PK.as_i64(shard)))
        out = PSM._scatter_plain(verdicts, torch.from_numpy(send_lane.reshape(-1)), rows.shape[1]).numpy()
        routed = send_lane[send_lane >= 0]
        np.testing.assert_array_equal(out[routed], np.isin(rows[j][routed], shard))
        assert not np.delete(out, routed).any()


def _reads(seed: int, n_reads: int = 400):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 20_000, dtype=np.uint8)
    reads = [genome[s : s + 150].copy() for s in rng.integers(0, genome.size - 150, n_reads)]
    reads[3][10] = 255
    reads[7][:40] = 255
    return reads


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("k", [21, 31, 32])
def test_sharded_counter_matches_jax_and_host(n, k):
    """k-mers, counts, histogram and swizzle constant of the port's sharded
    counter equal the JAX sharded counter's on a mesh of as many devices,
    and both equal the host StreamingCounter's (8 KB flushes, so that reads
    split across flushes)."""
    reads = _reads(k)
    port = PSC.ShardedStreamingCounter(k, _logical(n), batch_bases=1 << 13)
    jax_c = JSC.ShardedStreamingCounter(k, mesh=JM.make_mesh(n), batch_bases=1 << 13)
    host = PC.StreamingCounter(k)
    for r in reads:
        port.add_codes(r)
        jax_c.add_codes(r)
        host.add_codes(r)
    assert port._swz_const == jax_c._swz_const == PSC.pick_swizzle_const(k)
    got, want, ref = port.result(), jax_c.result(), host.result()
    for a, b in ((got, want), (want, ref), (got, ref)):
        np.testing.assert_array_equal(a.kmers, b.kmers)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.histogram, b.histogram)
    assert got.kmers.size > 1000


@pytest.mark.parametrize("n", [1, 8])
def test_sharded_counter_overflow_takes_host_route(n):
    """At slack 0 each owner's 64 slots overflow on every flush: the exact
    host route gives the host counter's result, in both packages."""
    k = 31
    reads = _reads(5)
    port = PSC.ShardedStreamingCounter(k, _logical(n), batch_bases=1 << 13, slack=0.0)
    jax_c = JSC.ShardedStreamingCounter(k, mesh=JM.make_mesh(n), batch_bases=1 << 13, slack=0.0)
    host = JC.StreamingCounter(k)
    route = port._route
    overflows = []
    port._route = lambda: (lambda r: overflows.append(r[1]) or r)(route())
    for r in reads:
        port.add_codes(r)
        jax_c.add_codes(r)
        host.add_codes(r)
    got, want, ref = port.result(), jax_c.result(), host.result()
    assert overflows and all(overflows)
    for a in (got, want):
        np.testing.assert_array_equal(a.kmers, ref.kmers)
        np.testing.assert_array_equal(a.counts, ref.counts)
        np.testing.assert_array_equal(a.histogram, ref.histogram)


def test_swizzle_const_matches_jax():
    for k in range(1, 33):
        assert PSC.pick_swizzle_const(k) == JSC.pick_swizzle_const(k)


@pytest.mark.parametrize("k", [1, 2, 3, 31, 32])
@pytest.mark.parametrize("name", SWIZZLE_EDGE_NAMES)
def test_swizzle_keys_plain_matches_numpy(k, name):
    """K11's plain version against the numpy k-mers and mix of the JAX
    counter's host route, on its edge chunks (tests/torch_tables.py
    swizzle_edge_chunks)."""
    codes = swizzle_edge_chunks(k)[name]
    const = PSC.pick_swizzle_const(k)
    swz, canon = PSC.swizzle_keys(torch.from_numpy(codes), k, const)
    fwd, valid = PK.kmers_from_codes(codes, k)
    c = PK.canonical_u64(fwd, k)
    mix = (c ^ (c >> np.uint64(33))) * np.uint64(const)
    mix = mix ^ (mix >> np.uint64(29))
    np.testing.assert_array_equal(PK.as_u64(canon), np.where(valid, c, SENT))
    np.testing.assert_array_equal(PK.as_u64(swz ^ PK.SIGN_BIT), np.where(valid, mix, SENT))
    assert name != "reads-ns" or valid.sum() > 1000
