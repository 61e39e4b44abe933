"""The port's span layer (32 < k <= 256) against the JAX package, exactly,
on the CPU: the multi-word word arithmetic (ops/span_device.py), the span
map's tables (build_fused_span) and lookup (lookup_q_span), the plain
version of K6 (the span scan) against scan_pay_device_q_span, the plain
version of K7 (the span walker) against walk_batch_device_span, the span
mode of BatchWalker against the JAX BatchWalker and the host walk, and the
span feed's windows through the native automaton against the JAX host
scan; and K7's look-ahead round schedule, emulated word for word, against
the plain span walker. Inputs are seeded numpy; words include ones with the
top bit set."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.fill import walk_device as JW
from mindthegap_tpu.find import scan_device as JS
from mindthegap_tpu.ops import extmap as JX
from mindthegap_tpu.ops import span_device as JSD
from mindthegap_tpu_torch.fill import walk_device as PW
from mindthegap_tpu_torch.fill.traversal import GraphView, host_walk
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.ops import extmap as PX
from mindthegap_tpu_torch.ops import kmers as PK
from mindthegap_tpu_torch.ops import span_device as PSD
from mindthegap_tpu_torch.ops.span import Span
from torch_tables import (SPAN_EDGE_NAMES, edge_walk_span_case, move_to_stash_span, span_edge_windows,
                          walk_span_edge_inputs)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(PK.as_i64(a))


def _u(t: torch.Tensor) -> np.ndarray:
    return PK.as_u64(t)


def _random_words(rng, k: int, n: int) -> np.ndarray:
    """(W, n) u64 words of random k-mers: every word's top bit is random
    (set in about half), word 0 masked to its bases."""
    w = rng.integers(0, 1 << 64, (PSD.span_width(k), n), dtype=np.uint64, endpoint=False)
    w[0] &= JSD.top_mask(k)
    return w


def _jax_map(qms: PX.QMapSpan) -> JX.QMapSpan:
    return JX.QMapSpan(qms.slots, qms.sat, qms.log_size, qms.salt, qms.stash_key64, qms.stash_sat,
                       qms.stash_payload)


def _genome_map(k: int, seed: int, repeat: bool):
    """Host span map (port build) of a 20 kb genome's k-mers, with a repeat
    set of every 25th (k-1)-mer when `repeat`; returns (map, genome, the
    solid rows, the repeat rows)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 20_000, dtype=np.uint8)
    sp, spm1 = Span(k), Span(k - 1)
    fwd, _ = sp.from_codes(genome[:15_000])
    solid = sp.from_keys(np.unique(sp.keys(sp.canonical(fwd))))
    if repeat:
        q, _ = spm1.from_codes(genome)
        rep = spm1.from_keys(np.unique(spm1.keys(spm1.canonical(q[::25]))))
    else:
        rep = np.zeros((0, spm1.W), np.uint64)
    return PX.build_fused_span(solid, k, rep), genome, solid, rep


@pytest.mark.parametrize("k", [33, 45, 64, 65, 96])
def test_span_words_match_jax(k):
    """span_width, top_mask, rolling_span (codes with N runs),
    revcomp_span, canonical_span and digest64 (tensor and numpy) equal the
    JAX functions; the words include palindromes (canonical ties)."""
    rng = np.random.default_rng(k)
    assert PSD.span_width(k) == JSD.span_width(k)
    assert PK.as_u64(np.array([PSD.top_mask(k)]))[0] == JSD.top_mask(k)
    codes = rng.integers(0, 4, 700, dtype=np.uint8)
    codes[100:110] = 255
    codes[rng.integers(0, codes.size, 8)] = 255
    jw, jv = JSD.rolling_span_device(jnp.asarray(codes), k)
    pw, pv = PSD.rolling_span(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(_u(pw), np.asarray(jw))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert not pv.all() and pv.any()

    words = _random_words(rng, k, 400)
    assert (words[-1] >> np.uint64(63)).any()
    if k % 2 == 0:  # a reverse-complement palindrome (fwd == rc: a canonical tie)
        half = rng.integers(0, 4, k // 2, dtype=np.uint8)
        words[:, :1] = Span(k).from_codes(np.concatenate([half, half[::-1] ^ 2]))[0].T
    jwords = jnp.asarray(words)
    t = _t(words)
    np.testing.assert_array_equal(_u(PSD.revcomp_span(t, k)), np.asarray(JSD.revcomp_span_device(jwords, k)))
    canon, is_c = PSD.canonical_span(t, k)
    jcanon, jis_c = JSD.canonical_span_device(jwords, k)
    np.testing.assert_array_equal(_u(canon), np.asarray(jcanon))
    np.testing.assert_array_equal(is_c.numpy(), np.asarray(jis_c))
    assert is_c.any() and not is_c.all()
    want = np.asarray(JSD.digest64(jwords))
    np.testing.assert_array_equal(_u(PSD.digest64(t)), want)
    np.testing.assert_array_equal(PSD.digest64(words), want)


@pytest.mark.parametrize("repeat", [False, True], ids=["solid", "solid+repeat"])
@pytest.mark.parametrize("k", [33, 45, 64])
def test_span_tables_match_jax(k, repeat):
    """build_fused_span gives the JAX package's tables slot for slot."""
    got, _g, solid, rep = _genome_map(k, k, repeat)
    want = JX.build_fused_span(solid, k, rep)
    assert got.log_size == want.log_size and got.salt == want.salt
    for name in ("slots", "sat", "stash_key64", "stash_sat", "stash_payload"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.sat.shape[0] == Span(k - 1).W - 1
    if repeat:
        assert ((got.slots >> np.uint64(8)) & np.uint64(1)).any()  # repeat bits in the table


@pytest.mark.parametrize("k", [33, 45, 64])
def test_lookup_q_span_matches_jax(k):
    """lookup_q_span equals the JAX lookup on present keys, absent keys
    (random words, and at k = 33 a key whose salted digest is EMPTY) and
    keys moved to the stash."""
    qms, genome, _solid, _rep = _genome_map(k, 100 + k, repeat=True)
    spm1 = Span(k - 1)
    q, _ = spm1.from_codes(genome)
    present = spm1.from_keys(np.unique(spm1.keys(spm1.canonical(q[:14_000]))))
    rng = np.random.default_rng(k)
    absent = _random_words(rng, k - 1, 300).T
    keys = np.concatenate([present, absent])
    if k == 33:  # Wq = 1: the digest is word 0
        keys = np.concatenate([keys, np.array([[0xFFFFFFFFFFFFFFFF ^ qms.salt]], np.uint64)])
    moved = move_to_stash_span(qms, present[::400][:30])
    assert moved.stash_key64.size >= 30 and (moved.slots != qms.slots).any()
    want = JX.lookup_q_span(_jax_map(qms), keys.T)
    assert (want != 0).sum() >= present.shape[0] and (want[present.shape[0]:] == 0).all()
    for table in (qms, moved):
        got = PX.lookup_q_span(table.to("cpu"), _t(keys.T.copy()))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(JX.lookup_q_span(_jax_map(table), keys.T), want)


@pytest.mark.parametrize("k", [33, 45, 64, 96])
@pytest.mark.parametrize("name", SPAN_EDGE_NAMES)
def test_span_scan_matches_jax(k, name):
    """The plain version of K6 equals scan_pay_device_q_span on K6's edge
    windows: pay8, rep8 and str8."""
    qms, cases = span_edge_windows(k)
    codes = cases[name]
    packed, bad = PS.pack_codes_host(codes)
    t = qms.to("cpu")
    got = PS.scan_pay_q_span(torch.from_numpy(packed), torch.from_numpy(bad), t.slots, t.sat, t.stash_key64,
                             t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k)
    want = JS.scan_pay_device_q_span(jnp.asarray(codes), jnp.asarray(qms.slots), jnp.asarray(qms.sat),
                                     jnp.asarray(qms.stash_key64), jnp.asarray(qms.stash_sat),
                                     jnp.asarray(qms.stash_payload), qms.salt, qms.log_size, k)
    n_pay = codes.size - k + 2
    for key in ("pay8", "rep8", "str8"):
        assert got[key].dtype == torch.uint8
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["pay8"].shape[0] == n_pay and got["rep8"].shape[0] == -(-n_pay // 8)
    assert n_pay % 8  # a partial last byte
    if name == "genome-ns-stash":
        pay = got["pay8"].numpy()
        assert (pay != 0).mean() > 0.8 and np.unpackbits(got["rep8"].numpy()).any()


def test_span_scan_hits_the_stash():
    """The edge window's (k-1)-mers that were moved to the stash are found
    there: with the stash emptied, their payloads drop to 0."""
    k = 45
    qms, cases = span_edge_windows(k)
    packed, bad = (torch.from_numpy(a) for a in PS.pack_codes_host(cases["genome-ns-stash"]))
    assert qms.stash_key64.size >= 30
    t = qms.to("cpu")
    got = PS.scan_pay_q_span(packed, bad, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload,
                             qms.salt, qms.log_size, k)
    empty = PX.QMapSpan(qms.slots, qms.sat, qms.log_size, qms.salt, np.array([PX.EMPTY], np.uint64),
                        np.zeros((1, 1), np.uint64), np.zeros(1, np.uint16)).to("cpu")
    dropped = PS.scan_pay_q_span(packed, bad, empty.slots, empty.sat, empty.stash_key64, empty.stash_sat,
                                 empty.stash_payload, qms.salt, qms.log_size, k)
    assert (got["pay8"] != dropped["pay8"]).sum() >= 15


@pytest.mark.parametrize("k,lanes", [(33, 48), (45, 37), (65, 100)])
def test_span_walk_matches_jax(k, lanes):
    """The plain version of K7 equals walk_batch_device_span on K7's edge
    walks: budgets of 0, tips, forks and merges, budget and step stops,
    stash hits."""
    qms, args = edge_walk_span_case(k, lanes, "cpu")
    nodes = _u(args[0])
    j = JW.walk_batch_device_span(jnp.asarray(nodes), jnp.asarray(args[1].numpy()), jnp.asarray(qms.slots),
                                  jnp.asarray(qms.sat), jnp.asarray(qms.stash_key64), jnp.asarray(qms.stash_sat),
                                  jnp.asarray(qms.stash_payload), qms.salt, qms.log_size, k, 64)
    p = PW.walk_batch_span(*args)
    for got, want in zip(p, j):
        got = got.numpy()
        np.testing.assert_array_equal(got.view(np.uint64) if got.dtype == np.int64 else got, np.asarray(want))
    n_app, status = np.asarray(j[1]), np.asarray(j[3])
    budgets = args[1].numpy()
    assert (n_app[budgets == 0] == 0).all() and (budgets == 0).any()
    assert {PW.STATUS_RUNNING, PW.STATUS_TIP, PW.STATUS_EVENT} <= set(status.tolist())
    assert status[0] == status[1] == PW.STATUS_TIP  # the genome's two dead ends
    assert (n_app == 64).any() and ((status == PW.STATUS_RUNNING) & (n_app < 64) & (n_app > 0)).any()
    assert (_u(args[0]) >> np.uint64(63)).any() or k == 33


# ---------------------------------------------------------------------------
# K7's round schedule, emulated in numpy word for word as csrc/walk_span.cu
# computes it: a team probes every node the next D steps can reach (the
# successor n1, its 4 children, their 16 grandchildren), each candidate's
# (k-1)-suffix from the node's words shifted by its L + 1 bases, canonical,
# digested and probed eagerly (both slots with their satellite words, the
# second hit over the first, the stash ORed in), its payload oriented; the
# team then resolves the round step by step under the stop rules.

_U = np.uint64
_H1, _H2, _H3 = _U(0x9E3779B97F4A7C15), _U(0xC2B2AE3D27D4EB4F), _U(0xD6E8FEB86659FD93)


def _mix(x, c):
    h = (x ^ (x >> _U(33))) * c
    return h ^ (h >> _U(29))


def _revcomp_word(x):
    x = x ^ _U(0xAAAAAAAAAAAAAAAA)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                  (16, 0x0000FFFF0000FFFF)):
        x = ((x >> _U(sh)) & _U(m)) | ((x & _U(m)) << _U(sh))
    return (x >> _U(32)) | (x << _U(32))


def _top_mask(nb: int, w: int):
    bits = 2 * nb - 64 * (w - 1)
    return _U(0xFFFFFFFFFFFFFFFF) if bits >= 64 else _U((1 << bits) - 1)


def _canonical_words(q: list, nb: int):
    """span_map.cuh canonical: (the canonical words, whether q itself was)."""
    wq = len(q)
    rc = [_revcomp_word(q[wq - 1 - i]) for i in range(wq)]
    s = 64 * wq - 2 * nb
    if s:
        for i in range(wq - 1, 0, -1):
            rc[i] = (rc[i] >> _U(s)) | (rc[i - 1] << _U(64 - s))
        rc[0] = rc[0] >> _U(s)
    take_f = np.ones(q[0].shape, bool)
    decided = np.zeros(q[0].shape, bool)
    for i in range(wq):
        d = ~decided & (q[i] != rc[i])
        take_f = np.where(d, q[i] < rc[i], take_f)
        decided |= d
    return [np.where(take_f, q[i], rc[i]) for i in range(wq)], take_f


def _eager_payload(qms: PX.QMapSpan, w: list):
    """span_map.cuh issue_eager + resolve_eager of canonical words w."""
    g = np.zeros(w[0].shape, np.uint64)
    for i in range(1, len(w)):
        g = _mix(w[1] if i == 1 else g ^ w[i], _H3)
    dig = w[0] ^ g ^ _U(qms.salt)
    shift = 64 - qms.log_size
    tbl = np.zeros(dig.shape, np.uint64)
    for i, c in enumerate((_H1, _H2)):
        h = _mix(dig, c)
        slot = (h >> _U(shift)).astype(np.int64)
        v = qms.slots[slot]
        hit = ((v >> _U(11)) == (h & _U((1 << shift) - 1))) & ((v >> _U(10)) & _U(1) == 1) & ((v >> _U(9)) & _U(1) == i)
        for j in range(1, len(w)):
            hit &= qms.sat[j - 1, slot] == w[j]
        tbl = np.where(hit, v & _U(0x1FF), tbl)
    stash = np.zeros(dig.shape, np.uint64)
    for s in range(qms.stash_key64.size):
        eq = dig == qms.stash_key64[s]
        for j in range(1, len(w)):
            eq &= qms.stash_sat[s, j - 1] == w[j]
        stash |= np.where(eq, _U(int(qms.stash_payload[s])), _U(0))
    return ((stash | tbl) & _U(0xFF)).astype(np.int64)


def _probe_ep(qms, node: np.ndarray, s: np.ndarray, low: np.ndarray, k: int, wq: int):
    """walk_span.cu probe_ep for rows of node words [n, Wk], each shifted
    left by s bits (0..6) with `low` shifted in: (ext | pre << 4) of the
    (k-1)-suffix, oriented as read."""
    wk = node.shape[1]
    q = []
    for i in range(wq):
        w = wk - wq + i
        inbits = (node[:, w + 1] >> _U(1)) >> (_U(63) - s) if w + 1 < wk else low
        q.append((node[:, w] << s) | inbits)
    q[0] = q[0] & _top_mask(k - 1, wq)
    cq, is_canon = _canonical_words(q, k - 1)
    pay = _eager_payload(qms, cq)
    ext_c, pre_c = pay & 0xF, pay >> 4
    return np.where(is_canon, ext_c | pre_c << 4, PX._shuffle02(pre_c) | PX._shuffle02(ext_c) << 4)


def _emulate_span_walk(qms, nodes: np.ndarray, budgets: np.ndarray, k: int, steps: int, depth: int):
    """K7's outputs as its teams compute them at look-ahead `depth`."""
    wq, wk = PSD.span_width(k - 1), nodes.shape[1]
    n_cand = (4 ** depth - 1) // 3
    level = np.array([lv for lv in range(depth) for _ in range(4 ** lv)])
    offset = np.array([o for lv in range(depth) for o in range(4 ** lv)], np.uint64)
    top_k = _top_mask(k, wk)
    node = nodes.copy()
    lanes = node.shape[0]
    lim = np.minimum(budgets, steps)
    n_app = np.zeros(lanes, np.int32)
    status = np.zeros(lanes, np.uint8)
    bases = np.full((lanes, steps), PW.NO_BASE, np.uint8)
    ep = np.zeros(lanes, np.int64)
    go = lim > 0
    zero = np.zeros(int(go.sum()), np.uint64)
    ep[go] = _probe_ep(qms, node[go], zero, zero, k, wq)  # the start node
    popc = [bin(b).count("1") for b in range(16)]
    while True:
        for j in np.nonzero(go)[0]:  # the top of a round: tip, fork, merge
            ext, pre = ep[j] & 0xF, ep[j] >> 4
            if n_app[j] >= lim[j]:
                go[j] = False
            elif popc[ext] == 0 or popc[ext] > 1 or popc[pre] != 1:
                status[j] = PW.STATUS_TIP if popc[ext] == 0 else PW.STATUS_EVENT
                go[j] = False
        live = np.nonzero(go)[0]
        if live.size == 0:
            break
        x1 = np.array([int(ep[j] & 0xF).bit_length() - 1 for j in live], np.uint64)
        # every candidate of every live lane: n1 shifted by its level's bases
        rows = np.repeat(node[live], n_cand, axis=0)
        s = np.tile(2 * (level + 1), live.size).astype(np.uint64)
        low = (np.repeat(x1, n_cand) << np.tile(2 * level, live.size).astype(np.uint64)) | np.tile(offset, live.size)
        mine = _probe_ep(qms, rows, s, low, k, wq).reshape(live.size, n_cand)
        for r, j in enumerate(live):
            off, base, width = 0, 0, 1
            for lv in range(depth):
                ext = ep[j] & 0xF
                if lv > 0:
                    if n_app[j] >= lim[j]:
                        go[j] = False
                        break
                    if popc[ep[j] >> 4] != 1:
                        status[j], go[j] = PW.STATUS_EVENT, False
                        break
                    base, width = base + width, width * 4
                    off = off * 4 + int(ext).bit_length() - 1
                e2 = mine[r, base + off]
                if popc[e2 & 0xF] != 1:
                    status[j], go[j] = PW.STATUS_EVENT, False
                    break
                x = int(ext).bit_length() - 1
                bases[j, n_app[j]] = x
                n_app[j] += 1
                node[j, :-1] = (node[j, :-1] << _U(2)) | (node[j, 1:] >> _U(62))
                node[j, -1] = (node[j, -1] << _U(2)) | _U(x)
                node[j, 0] &= top_k
                ep[j] = e2
    return bases, n_app, node, status


_SCHEDULE_LANES = {33: 48, 45: 37, 65: 100, 128: 40, 256: 33}


@functools.lru_cache(maxsize=None)
def _plain_span_walk(k: int):
    qms, args = edge_walk_span_case(k, _SCHEDULE_LANES[k], "cpu")
    return qms, args, PW._walk_batch_span_plain(*args)


@pytest.mark.parametrize("k", sorted(_SCHEDULE_LANES))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_span_lookahead_schedule_matches_plain(depth, k):
    """K7's team round schedule at look-ahead D (candidate indexing, each
    candidate's words, canonical form, eager probe, payload orientation and
    the step-by-step stops), emulated in numpy, equals the plain span
    walker on K7's edge walks: budgets of 0, tips, forks and merges, budget
    and step stops, stash hits."""
    qms, args, want = _plain_span_walk(k)
    nodes, budgets, steps = _u(args[0]), args[1].numpy(), args[-1]
    got = _emulate_span_walk(qms, nodes, budgets, k, steps, depth)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], _u(want[2]))
    np.testing.assert_array_equal(got[3], want[3].numpy())
    n_app, status = got[1], got[3]
    assert {PW.STATUS_RUNNING, PW.STATUS_TIP, PW.STATUS_EVENT} <= set(status.tolist())
    assert (n_app[budgets == 0] == 0).all() and (n_app == steps).any()
    if depth > 1:  # stops inside a round, not only at its first step
        ev = n_app[status == PW.STATUS_EVENT]
        assert len(set((ev % depth).tolist())) > 1


@pytest.mark.parametrize("k", [45, 65])
def test_span_walk_one_lane(k):
    """One lane (a (Wk, 1) node column, whose strides are not the usual
    ones) walks as the JAX walker does, and as in a batch of lanes."""
    qms, args = edge_walk_span_case(k, 40, "cpu")
    budgets = np.full(40, 300, np.int32)
    batch = PW.walk_batch_span(args[0], torch.from_numpy(budgets), *args[2:])
    j = JW.walk_batch_device_span(jnp.asarray(_u(args[0][-1:])), jnp.asarray(budgets[-1:]), jnp.asarray(qms.slots),
                                  jnp.asarray(qms.sat), jnp.asarray(qms.stash_key64), jnp.asarray(qms.stash_sat),
                                  jnp.asarray(qms.stash_payload), qms.salt, qms.log_size, k, 64)
    one = PW.walk_batch_span(args[0][-1:].clone(), torch.from_numpy(budgets[-1:]), *args[2:])
    for got, row, want in zip(one, batch, j):
        g = got.numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if g.dtype == np.int64 else g, np.asarray(want))
        assert torch.equal(got, row[-1:])
    assert int(one[1][0]) == 64


@pytest.mark.parametrize("k", [45, 65])
def test_span_batch_walker_matches_jax_and_host(k):
    """BatchWalker in span mode (python-int nodes to rows and back, only
    the live walks sent) equals the JAX BatchWalker and the host walk."""
    solid, nodes, _budgets, _stash = walk_span_edge_inputs(k, 40, seed=k)
    sp = Span(k)
    from mindthegap_tpu_torch.graph import dbg as PD

    view = GraphView(PD.Graph(PD.SolidSet(sp.keys(solid), k)))
    qms = view.ensure_span_map()
    assert view.ensure_span_map() is qms
    rng = np.random.default_rng(k)
    starts = [int(x) for x in sp.to_ints(nodes)]
    budgets = [int(b) for b in rng.integers(0, 150, len(starts))]
    reqs = list(zip(starts, budgets))
    walker = PW.BatchWalker(qms, k, "cpu", steps=16, max_steps=64)
    assert walker.layout == "span" and walker.wk == sp.W
    calls = []
    call_device = walker._call_device

    def recording(lane_nodes, lane_budgets, steps):
        calls.append(lane_budgets.numpy().copy())
        return call_device(lane_nodes, lane_budgets, steps)

    walker._call_device = recording
    got = walker.walk_many(reqs)
    assert got == JW.BatchWalker(_jax_map(qms), k, steps=16, max_steps=64).walk_many(reqs)
    assert got == [tuple(host_walk(view, n, b)) for n, b in reqs]
    assert {r for _b, _n, r in got} == {"tip", "event", "budget"}
    for lane_budgets in calls:
        live = int((lane_budgets > 0).sum())
        assert (lane_budgets[:live] > 0).all() and lane_budgets.size == max(8, live)


_FLAGS = dict(max_repeat=5, snp_min_val=5, branching_threshold=15, homo_only=False, snp=True,
              deletion=True, small_homo=True, homo_insert=True, backup=False, hete_insert=True)


@pytest.mark.parametrize("k", [33, 45])
def test_span_feed_matches_jax_host_scan(k):
    """The port's span feed over 2^13-base windows (the halo seams of
    several windows, an N run across one) into the native automaton writes
    what the JAX package's host plane scan writes."""
    from mindthegap_tpu.find import native_scan as JN
    from mindthegap_tpu.find import scan as JSCAN
    from mindthegap_tpu.graph import dbg as JD
    from mindthegap_tpu_torch.find import native_scan as PN
    from mindthegap_tpu_torch.find import runner as PR
    from mindthegap_tpu_torch.graph import dbg as PD

    rng = np.random.default_rng(k)
    ref = rng.integers(0, 4, 40_000, dtype=np.uint8)
    ins = rng.integers(0, 4, 120, dtype=np.uint8)
    donor = np.concatenate([ref[:20_000], ins, ref[20_000:]])
    sp, spm1 = Span(k), Span(k - 1)
    fwd, _ = sp.from_codes(donor)
    solid = np.unique(sp.keys(sp.canonical(fwd)))
    q, _ = spm1.from_codes(ref)
    rep_rows = spm1.canonical(q[::97])
    repeat = np.unique(rep_rows[:, 0]) if k == 33 else np.unique(spm1.keys(rep_rows))
    genome = ref.copy()
    genome[8170:8200] = 255  # an N run across the first window's end
    seq = "".join("ACTGN"[min(c, 4)] for c in genome)

    jsc = JN.NativeScanner(JD.Graph(JD.SolidSet(solid, k)), JD.SolidSet(repeat, k - 1), k, **_FLAGS)
    jsc.scan_sequence("chr", seq, JSCAN.compute_planes_span(genome, k, solid, repeat))
    want = jsc.results()
    jsc.close()

    graph = PD.Graph(PD.SolidSet(solid, k))
    rep = PD.SolidSet(repeat, k - 1)
    feed = PR._make_span_feed_fn(graph, rep, k, torch.device("cpu"), window=1 << 13)
    chunks = list(feed(genome))
    assert len(chunks) == 5 and {c[0] for c in chunks} == {"pay"}
    assert sum(c[4] for c in chunks) == genome.size - k + 2
    sc = PN.NativeScanner(graph, rep, k, **_FLAGS)
    sc.scan_sequence_pay("chr", seq, iter(chunks))
    got = sc.results()
    sc.close()
    assert got == want
    assert "_pos_2000" in got[0]  # the planted insertion is reported


def test_span_kernel_wrappers_take_cuda_tensors_only():
    """K6's and K7's wrappers refuse CPU tensors and count no launch."""
    k = 45
    qms, cases = span_edge_windows(k)
    t = qms.to("cpu")
    packed, bad = (torch.from_numpy(a) for a in PS.pack_codes_host(cases["shortest"]))
    tables = (t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PS.scan_pay_q_span_cuda(packed, bad, *tables)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PW.walk_batch_span_cuda(torch.zeros((8, 2), dtype=torch.int64), torch.zeros(8, dtype=torch.int32),
                                *tables, 16)
    assert PS.scan_pay_q_span_cuda.launches == 0 and PW.walk_batch_span_cuda.launches == 0


def test_span_probe_slots_and_sectors():
    """span_probe (shared by lookup_q_span and the K6 bound): a present key
    sits in exactly one of its two slots, an absent key in none; and
    bounds.span_scan_sectors counts, per (k-1)-mer, its first slot, the
    satellite word where that slot holds the digest, and the second slot
    (and its satellite) after a miss."""
    from mindthegap_tpu_torch.bounds import span_scan_sectors

    k = 45
    qms, cases = span_edge_windows(k)
    t = qms.to("cpu")
    codes = cases["genome-ns-stash"]
    qwords, _ = PSD.rolling_span(torch.from_numpy(codes), k - 1)
    canon, _ = PSD.canonical_span(qwords, k - 1)
    _dig, _v, here, hit = PX.span_probe(t, canon)
    assert not (hit[0] & hit[1]).any() and (here >= hit).all()
    found = hit.any(0)
    assert 0.8 < found.float().mean() < 1.0  # Ns and stash keys miss both slots
    want = int(canon.shape[1] + here[0].sum() + (~hit[0]).sum() + (~hit[0] & here[1]).sum())
    packed, bad = (torch.from_numpy(a) for a in PS.pack_codes_host(codes))
    assert span_scan_sectors(packed, bad, t, k) == want
    assert canon.shape[1] < want < 3 * canon.shape[1]
