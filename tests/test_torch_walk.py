"""The port's device fill walker against the JAX package, exactly, on the
CPU: lookup_q and lookup_qb against the numpy forms (stash entries
included), the plain walk_batch against walk_batch_device for both layouts,
and BatchWalker / run_jobs_batched against the JAX walker and the host walk
engine, on random de Bruijn graphs with forks, merges and tips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.fill import walk_device as JW
from mindthegap_tpu.ops import extmap as JX
from mindthegap_tpu_torch.fill import walk_device as PW
from mindthegap_tpu_torch.fill.traversal import GraphView, host_walk
from mindthegap_tpu_torch.ops import extmap as PX
from mindthegap_tpu_torch.ops import kmers as PK
from torch_tables import edge_walk_case, move_to_stash_walk


class _Solid:
    def __init__(self, keys):
        self.keys = keys


class _Graph:
    def __init__(self, keys, k):
        self.k = k
        self.solid = _Solid(keys)


def _random_solid(seed: int, k: int) -> np.ndarray:
    """Solid k-mers of random sequences stitched from shared fragments, so
    that paths share interior sequence (forks and merges), plus a few lone
    sequences whose ends are tips."""
    rng = np.random.default_rng(seed)
    fragments = [rng.integers(0, 4, 300, dtype=np.uint8) for _ in range(6)]
    seqs = [rng.integers(0, 4, 150, dtype=np.uint8) for _ in range(6)]
    for _ in range(40):
        parts = []
        for _ in range(rng.integers(2, 5)):
            f = fragments[rng.integers(0, len(fragments))]
            s = rng.integers(0, 240)
            parts.append(f[s : s + rng.integers(40, 60)])
        seqs.append(np.concatenate(parts))
    kmers = []
    for seq in seqs:
        fwd, valid = PK.kmers_from_codes(seq, k)
        kmers.append(PK.canonical_u64(fwd[valid], k))
    return np.unique(np.concatenate(kmers))


def _table(layout: str, solid: np.ndarray, k: int):
    build = PX.build_fused_bucket if layout == "bucket" else PX.build_fused
    return build(solid, k, np.zeros(0, np.uint64))


def _jax_table(qm):
    cls = JX.QMapB if isinstance(qm, PX.QMapB) else JX.QMap
    return cls(qm.slots, qm.log_nb if cls is JX.QMapB else qm.log_size, qm.stash_keys, qm.stash_payload)


def _starts(rng, solid: np.ndarray, k: int, n: int):
    """As-read start nodes of the graph, both strands (at k = 32 about half
    have the top bit set)."""
    out = []
    for key in solid[rng.integers(0, solid.size, n)]:
        out.append(int(key) if rng.integers(0, 2) else int(PK.revcomp_u64(np.uint64(key), k)))
    return out


def _stashed(layout: str, k: int):
    solid = _random_solid(k, k)
    qm = _table(layout, solid, k)
    # (k-1)-mer keys in the table: canonical prefixes of solid k-mers
    pre = np.unique(PK.canonical_u64(solid >> np.uint64(2), k - 1))
    return solid, qm, move_to_stash_walk(qm, pre[::50][:30])


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
@pytest.mark.parametrize("k", [21, 31, 32])
def test_lookup(layout, k):
    solid, qm, moved = _stashed(layout, k)
    rng = np.random.default_rng(k)
    keys = np.concatenate([
        np.unique(PK.canonical_u64(solid >> np.uint64(2), k - 1)),
        PK.canonical_u64(rng.integers(0, 1 << (2 * (k - 1)), 500, dtype=np.uint64), k - 1),
    ])
    lookup, jlookup = (PX.lookup_qb, JX.lookup_qb) if layout == "bucket" else (PX.lookup_q, JX.lookup_q)
    tk = torch.from_numpy(PK.as_i64(keys))
    want = jlookup(_jax_table(qm), keys)
    for table in (qm, moved):
        got = lookup(table.to("cpu"), tk)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(jlookup(_jax_table(table), keys), want)
    assert moved.stash_keys.size >= 30 and (moved.slots != qm.slots).any()
    assert (want != 0).sum() > keys.size // 2 and (want == 0).sum() > 100


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
@pytest.mark.parametrize("k", [21, 31, 32])
def test_walk_batch(layout, k):
    solid, _qm, qm = _stashed(layout, k)
    rng = np.random.default_rng(100 + k)
    # a few lanes start at a dead end (the only place a walk stops as a tip:
    # elsewhere it stops one node before the end, as an event)
    view = GraphView(_Graph(solid, k))
    tips = [n for n in _starts(rng, solid, k, 3000) if not view.successors(n)][:4]
    nodes = np.array(_starts(rng, solid, k, 44) + tips, np.uint64)
    assert nodes.size == 48
    budgets = np.concatenate([np.zeros(8), rng.integers(1, 6, 16), np.full(24, 10_000)]).astype(np.int32)
    steps = 256
    log = qm.log_nb if layout == "bucket" else qm.log_size
    j = JW.walk_batch_device(jnp.asarray(nodes), jnp.asarray(budgets), jnp.asarray(qm.slots),
                             jnp.asarray(qm.stash_keys), jnp.asarray(qm.stash_payload), log, k, steps, layout)
    t = qm.to("cpu")
    p = PW.walk_batch(torch.from_numpy(PK.as_i64(nodes)), torch.from_numpy(budgets), t.slots,
                      t.stash_keys, t.stash_payload, log, k, steps, layout)
    for got, want in zip(p, j):
        got = got.numpy()
        np.testing.assert_array_equal(got.view(np.uint64) if got.dtype == np.int64 else got, np.asarray(want))
    n_app, status = np.asarray(j[1]), np.asarray(j[3])
    assert (n_app[:8] == 0).all() and n_app.max() > 5
    assert {0, 1, 2} <= set(status.tolist())  # budget, tip and event stops


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_walker_matches_jax_and_host(layout, seed):
    k = 15 + 16 * seed  # 15 and 31
    solid = _random_solid(seed, k)
    view = GraphView(_Graph(solid, k), layout=layout)
    rng = np.random.default_rng(seed + 100)
    starts = _starts(rng, solid, k, 37)
    budgets = [int(b) for b in rng.integers(0, 200, len(starts))]
    reqs = list(zip(starts, budgets))
    walker = PW.BatchWalker(view.qm, k, "cpu", steps=16, max_steps=64)
    calls = []
    call_device = walker._call_device

    def recording(nodes, lane_budgets, steps):
        calls.append(lane_budgets.numpy().copy())
        return call_device(nodes, lane_budgets, steps)

    walker._call_device = recording
    got = walker.walk_many(reqs)
    assert got == JW.BatchWalker(_jax_table(view.qm), k, steps=16, max_steps=64).walk_many(reqs)
    assert got == [tuple(host_walk(view, n, b)) for n, b in reqs]
    assert walker.n_device_calls == len(calls) > 1
    # each call takes only the live walks, first (at least 8 lanes)
    for lane_budgets in calls:
        live = int((lane_budgets > 0).sum())
        assert (lane_budgets[:live] > 0).all() and lane_budgets.size == max(8, live)
    assert (calls[0] > 0).sum() == sum(b > 0 for b in budgets) and calls[-1].size < calls[0].size


def test_run_jobs_batched_interleaves():
    k = 15
    solid = _random_solid(7, k)
    view = GraphView(_Graph(solid, k))
    walker = PW.BatchWalker(view.qm, k, "cpu", steps=8, max_steps=32)

    def job(start, budget):
        total = []
        node = start
        for _ in range(3):  # chained walks exercise resume-from-end-node
            bases, node, reason = yield ("walk", node, budget)
            total.append((list(bases), node, reason))
            if reason != "budget":
                break
        return total

    rng = np.random.default_rng(11)
    starts = [int(s) for s in solid[rng.integers(0, solid.size, 9)]]
    got = list(PW.run_jobs_batched([job(s, 13) for s in starts], walker))
    want = list(JW.run_jobs_batched([job(s, 13) for s in starts],
                                    JW.BatchWalker(_jax_table(view.qm), k, steps=8, max_steps=32)))
    assert got == want
    for s, g in zip(starts, got):
        node, expect = s, []
        for _ in range(3):
            bases, node, reason = host_walk(view, node, 13)
            expect.append((list(bases), node, reason))
            if reason != "budget":
                break
        assert g == expect


def test_span_and_mesh_walkers_raise():
    from mindthegap_tpu_torch import NotYetPorted

    solid = _random_solid(3, 15)
    qm = _table("cuckoo", solid, 15)
    with pytest.raises(NotYetPorted):
        PW.BatchWalker(qm, 15, "cpu", mesh=object())
    with pytest.raises(NotYetPorted):
        PW.BatchWalker(None, 45, "cpu")


def test_walk_kernel_wrapper_takes_cuda_tensors_only():
    solid = _random_solid(4, 21)
    t = _table("cuckoo", solid, 21).to("cpu")
    nodes = torch.from_numpy(PK.as_i64(solid[:8]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        PW.walk_batch_cuda(nodes, torch.zeros(8, dtype=torch.int32), t.slots, t.stash_keys,
                           t.stash_payload, 12, 21, 16, "cuckoo")
    assert PW.walk_batch_cuda.launches == 0


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
@pytest.mark.parametrize("k,lanes", [(9, 8), (31, 37), (32, 100)])
def test_walk_edge_cases(layout, k, lanes):
    """The look-ahead kernel's edge cases (8 lanes, lane counts off the
    warp size, budgets ending mid-round, stops at every depth, stash hits
    ahead, k = 32 top bits, small k) through the plain walk and the JAX
    walker."""
    qm, args = edge_walk_case(layout, k, lanes, "cpu")
    nodes = PK.as_u64(args[0])
    j = JW.walk_batch_device(jnp.asarray(nodes), jnp.asarray(args[1].numpy()), jnp.asarray(qm.slots),
                             jnp.asarray(qm.stash_keys), jnp.asarray(qm.stash_payload), *args[5:])
    p = PW.walk_batch(*args)
    for got, want in zip(p, j):
        got = got.numpy()
        np.testing.assert_array_equal(got.view(np.uint64) if got.dtype == np.int64 else got, np.asarray(want))
    n_app, status = np.asarray(j[1]), np.asarray(j[3])
    assert (status == PW.STATUS_EVENT).any() and (n_app[:8] > 0).any()
    if lanes >= 32:
        # event stops at every depth of a round of 2 and of 3 steps
        ev = n_app[status == PW.STATUS_EVENT]
        assert {0, 1} <= set((ev % 2).tolist()) and {0, 1, 2} <= set((ev % 3).tolist())
        # budgets that end inside a round of 3 steps
        lim = np.minimum(args[1].numpy(), 64)
        run = status == PW.STATUS_RUNNING
        assert (n_app[run] == lim[run]).all() and {1, 2} <= set((n_app[run] % 3).tolist())
    if k == 32:
        assert (nodes >> np.uint64(63)).any()


def test_lookahead_depth_rule():
    """K5's look-ahead depth from the live lane count (the fastest depths
    measured on the card): 3 at the fill's lane counts, 2 at 4,096 lanes,
    1 from 16,384 on, the cuckoo map turning shallower sooner than the
    bucket map; never deeper for more lanes, and always a depth the kernel
    is built for."""
    for layout in ("cuckoo", "bucket"):
        assert PW.lookahead_depth(1, layout) == PW.lookahead_depth(8, layout) == PW.lookahead_depth(1024, layout) == 3
        assert PW.lookahead_depth(2048, layout) == PW.lookahead_depth(6144, layout) == 2
        assert PW.lookahead_depth(16384, layout) == PW.lookahead_depth(1 << 16, layout) == 1
        depths = [PW.lookahead_depth(n, layout) for n in range(1, 1 << 15, 97)]
        assert depths == sorted(depths, reverse=True) and set(depths) == set(PW.DEPTHS)
    assert PW.lookahead_depth(1536, "cuckoo") == 2 and PW.lookahead_depth(1536, "bucket") == 3
    assert PW.lookahead_depth(8192, "cuckoo") == 1 and PW.lookahead_depth(8192, "bucket") == 2
