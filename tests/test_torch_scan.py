"""The port's scan slice against the JAX package, exactly: the pair map
build, lookup_qp, scan_cls_qp, scan_pay_qp and the payload oracle on
identical padded windows, plus the feed's dense re-dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.find import scan_device as JS
from mindthegap_tpu.ops import extmap as JX
from mindthegap_tpu.ops import kmers as JK
from mindthegap_tpu_torch.find import native_scan as PN
from mindthegap_tpu_torch.find import runner as PR
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.graph import dbg as PD
from mindthegap_tpu_torch.ops import extmap as PX
from mindthegap_tpu_torch.ops import kmers as PK
from torch_tables import SCAN_EDGE_NAMES, move_to_stash, scan_edge_windows

WINDOW = 8192


@pytest.fixture(scope="module", params=[21, 31], ids=["k21", "k31"])
def case(request):
    """A seeded genome; the solid set comes from a donor with a 50 bp
    insertion (a breakpoint the scan must flag) and the repeat set is a
    sample of reference (k-1)-mers."""
    k = request.param
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 40000, dtype=np.uint8)
    donor = np.concatenate([genome[:20000], rng.integers(0, 4, 50, dtype=np.uint8), genome[20000:]])
    fwd, _ = JK.kmers_from_codes(donor, k)
    solid = np.unique(JK.canonical_u64(fwd, k))
    rfwd, _ = JK.kmers_from_codes(genome, k - 1)
    repeat = np.unique(JK.canonical_u64(rfwd[::40], k - 1))
    window = genome[15000:15000 + WINDOW].copy()
    window[300:340] = 255  # an N run
    window[5000] = 255
    jq = JX.build_fused_pair(solid, k, repeat)
    pq = PX.build_fused_pair(solid, k, repeat)
    return k, genome, solid, repeat, window, jq, pq


def _jtables(q):
    return (jnp.asarray(q.slots), jnp.asarray(q.stash_keys), jnp.asarray(q.stash_l), jnp.asarray(q.stash_r))


def _ptables(q):
    t = q.to("cpu")
    return (t.slots, t.stash_keys, t.stash_l, t.stash_r)


def test_build_fused_pair_equal(case):
    _k, _g, _s, _r, _w, jq, pq = case
    assert pq.log_size == jq.log_size and pq.k == jq.k
    np.testing.assert_array_equal(pq.slots, jq.slots)
    for name in ("stash_keys", "stash_l", "stash_r"):
        np.testing.assert_array_equal(getattr(pq, name), getattr(jq, name))


def test_lookup_qp(case):
    k, genome, _s, _r, _w, jq, pq = case
    fwd, _ = JK.kmers_from_codes(genome, k - 2)
    keys = JK.canonical_u64(fwd[::3], k - 2)
    keys = np.concatenate([keys, np.arange(200, dtype=np.uint64)])  # absent buckets too
    jl, jr = JX.lookup_qp(jq, keys)
    pl, pr = PX.lookup_qp(pq.to("cpu"), torch.from_numpy(PK.as_i64(keys)))
    np.testing.assert_array_equal(PK.as_u64(pl), jl)
    np.testing.assert_array_equal(PK.as_u64(pr), jr)
    assert (jl != 0).sum() > keys.size // 2


def test_qp_probe_rows_and_sectors(case):
    """A key sits in at most one of its two rows (mix is a bijection), so K1
    may skip the second probe after a first-row hit; the two probes give
    lookup_qp's rows. bounds.scan_probe_sectors counts one row per pair
    lookup of a window, at the keys the JAX package's k-mers give, and a
    second for each key not in its first row."""
    from mindthegap_tpu_torch.bounds import scan_probe_sectors

    k, genome, _s, _r, window, jq, pq = case
    t = pq.to("cpu")
    fwd, _ = JK.kmers_from_codes(genome, k - 2)
    keys = np.concatenate([JK.canonical_u64(fwd[::3], k - 2), np.arange(200, dtype=np.uint64)])
    tk = torch.from_numpy(PK.as_i64(keys))
    (h0, l0, r0), (h1, l1, r1) = PX.qp_probe(t, tk, 0), PX.qp_probe(t, tk, 1)
    assert not (h0 & h1).any() and h0.sum() > h1.sum() > 0
    in_stash = (tk[:, None] == t.stash_keys).any(1)
    jl, jr = JX.lookup_qp(jq, keys)
    rows_l = torch.where(h0, l0, torch.where(h1, l1, 0))
    rows_r = torch.where(h0, r0, torch.where(h1, r1, 0))
    np.testing.assert_array_equal(PK.as_u64(rows_l[~in_stash]), jl[~in_stash.numpy()])
    np.testing.assert_array_equal(PK.as_u64(rows_r[~in_stash]), jr[~in_stash.numpy()])

    n_pairs = (WINDOW - k + 3) // 2
    clean = np.zeros(2 * n_pairs + k, np.uint8)
    clean[:WINDOW] = np.where(window == 255, 0, window)
    wfwd, _ = JK.kmers_from_codes(clean, k - 2)
    pair_keys = JK.canonical_u64(wfwd[1 : 2 * n_pairs : 2], k - 2)
    np.testing.assert_array_equal(PK.as_u64(PS.pair_keys(torch.from_numpy(window), k)[3]), pair_keys)
    in_first = PX.qp_probe(t, torch.from_numpy(PK.as_i64(pair_keys)), 0)[0]
    packed, bad = PS.pack_codes_host(window)
    sectors = scan_probe_sectors(torch.from_numpy(packed), torch.from_numpy(bad), t, k)
    assert sectors == n_pairs + int((~in_first).sum()) < 2 * n_pairs


def test_pair_payload_stream(case):
    k, _g, _s, _r, window, jq, pq = case
    n_pay = WINDOW - k + 2
    np.testing.assert_array_equal(PX.pair_payload_stream(pq, window, n_pay),
                                  JX.pair_payload_stream(jq, window, n_pay))


@pytest.mark.parametrize("exc_cap", [None, 8], ids=["cap", "tiny-cap"])
def test_scan_cls_qp(case, exc_cap):
    k, _g, _s, _r, window, jq, pq = case
    cap = exc_cap or (WINDOW - k + 2 + 3) // 4 * 4 // 8
    packed, bad = PS.pack_codes_host(window)
    j = JS.scan_cls_device_qp(jnp.asarray(packed), jnp.asarray(bad), *_jtables(jq), jq.log_size, k, cap)
    p = PS.scan_cls_qp(torch.from_numpy(packed), torch.from_numpy(bad), *_ptables(pq), pq.log_size, k, cap)
    np.testing.assert_array_equal(p["cls2"].numpy(), np.asarray(j["cls2"]))
    assert int(p["n_exc"]) == int(j["n_exc"])
    np.testing.assert_array_equal(p["exc16"].numpy().view(np.uint16), np.asarray(j["exc16"]))
    classes = np.stack([(np.asarray(j["cls2"]) >> (2 * i)) & 3 for i in range(4)], 1).ravel()
    assert set(np.unique(classes)) == {0, 1, 2, 3}  # every class is exercised


def test_scan_pay_qp(case):
    k, _g, _s, _r, window, jq, pq = case
    j = JS.scan_pay_device_qp(jnp.asarray(window), *_jtables(jq), jq.log_size, k)
    packed, bad = PS.pack_codes_host(window)
    p = PS.scan_pay_qp(torch.from_numpy(packed), torch.from_numpy(bad), *_ptables(pq), pq.log_size, k)
    np.testing.assert_array_equal(p["pay8"].numpy(), np.asarray(j["pay8"]))
    np.testing.assert_array_equal(p["rep8"].numpy(), np.asarray(j["rep8"]))


@pytest.fixture(scope="module")
def scan_edges():
    return scan_edge_windows(31)


@pytest.mark.parametrize("name", SCAN_EDGE_NAMES)
def test_scan_cls_qp_edge_cases(scan_edges, name):
    """K1's compaction edges (tests/torch_tables.py scan_edge_windows)
    through the plain scan and the JAX program: n_exc 0, at the cap, one
    over it, a cap of 0, N runs across tile boundaries, the shortest
    window the feed sends."""
    qp, cases = scan_edges
    k = qp.k
    codes, cap = cases[name]
    packed, bad = PS.pack_codes_host(codes)
    jm = JX.QMapP(qp.slots, qp.log_size, k, qp.stash_keys, qp.stash_l, qp.stash_r)
    j = JS.scan_cls_device_qp(jnp.asarray(packed), jnp.asarray(bad), *_jtables(jm), jm.log_size, k, cap)
    p = PS.scan_cls_qp(torch.from_numpy(packed), torch.from_numpy(bad), *_ptables(qp), qp.log_size, k, cap)
    np.testing.assert_array_equal(p["cls2"].numpy(), np.asarray(j["cls2"]))
    assert int(p["n_exc"]) == int(j["n_exc"])
    np.testing.assert_array_equal(p["exc16"].numpy().view(np.uint16), np.asarray(j["exc16"]))
    n_exc = int(j["n_exc"])
    want = {"n-exc-0": n_exc == 0, "n-exc-at-cap": n_exc == cap > 0, "n-exc-over-cap": n_exc == cap + 1,
            "cap-0": cap == 0 < n_exc, "shortest": codes.size == -(-(k + 8) // 8) * 8,
            "shortest-cap-over-n4": p["exc16"].shape[0] < cap}
    assert want[name]


_FLAGS = dict(max_repeat=5, snp_min_val=5, branching_threshold=15, homo_only=False, snp=True,
              deletion=True, small_homo=True, homo_insert=True, backup=False, hete_insert=True)


@pytest.mark.parametrize("exc_cap", [None, 0], ids=["cls", "dense"])
def test_feed_matches_jax_host_scan(case, exc_cap):
    """The port's feed over 2^13-base windows (the halo seams of five
    windows) into the native automaton writes what the JAX package's host
    plane scan writes; exc_cap 0 sends every window through the dense
    re-dispatch instead of the class stream."""
    from mindthegap_tpu.find import native_scan as JN
    from mindthegap_tpu.find import scan as JSCAN
    from mindthegap_tpu.graph import dbg as JD

    k, genome, solid, repeat, _w, _jq, _pq = case
    seq = "".join("ACTG"[c] for c in genome)
    jsc = JN.NativeScanner(JD.Graph(JD.SolidSet(solid, k)), JD.SolidSet(repeat, k - 1), k, **_FLAGS)
    jsc.scan_sequence("chr", seq, JSCAN.compute_planes(genome, k, solid, repeat))
    want = jsc.results()
    jsc.close()

    graph = PD.Graph(PD.SolidSet(solid, k))
    rep = PD.SolidSet(repeat, k - 1)
    feed = PR._make_pay_feed_fn(graph, rep, k, torch.device("cpu"), window=WINDOW, exc_cap=exc_cap)
    chunks = list(feed(genome))
    assert len(chunks) == 5
    assert {c[0] for c in chunks} == ({"pay"} if exc_cap == 0 else {"cls"})
    sc = PN.NativeScanner(graph, rep, k, **_FLAGS)
    sc.scan_sequence_pay("chr", seq, iter(chunks))
    got = sc.results()
    sc.close()
    assert got == want
    assert "pos_20000" in got[0]  # the planted insertion is reported


def test_stash_entries_are_found(case):
    """Entries moved from their rows into the stash give the same scan (and
    the same as the JAX package's lookup over the moved tables)."""
    k, _g, _s, _r, window, jq, pq = case
    fwd, _ = JK.kmers_from_codes(window[1000:1200], k - 2)
    moved = move_to_stash(pq, np.unique(JK.canonical_u64(fwd, k - 2))[:20])
    assert moved.stash_keys.size == 20 and (moved.slots != pq.slots).any()
    packed, bad = PS.pack_codes_host(window)
    cap = (WINDOW - k + 2 + 3) // 4 * 4 // 8
    want = PS.scan_cls_qp(torch.from_numpy(packed), torch.from_numpy(bad), *_ptables(pq), pq.log_size, k, cap)
    got = PS.scan_cls_qp(torch.from_numpy(packed), torch.from_numpy(bad), *_ptables(moved), pq.log_size, k, cap)
    for key in ("cls2", "exc16", "n_exc"):
        assert torch.equal(got[key], want[key])
    jm = JX.QMapP(moved.slots, moved.log_size, k, moved.stash_keys, moved.stash_l, moved.stash_r)
    j = JS.scan_cls_device_qp(jnp.asarray(packed), jnp.asarray(bad), *_jtables(jm), jm.log_size, k, cap)
    np.testing.assert_array_equal(got["cls2"].numpy(), np.asarray(j["cls2"]))
