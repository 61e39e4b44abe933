"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. Marked `cuda`: they skip without a CUDA device; on a GPU
machine run `python -m pytest tests/test_torch_cuda.py -m cuda`.
(chip_smoke.py runs the same comparisons at the main path's shapes.)"""

import io

import numpy as np
import pytest
import torch

from mindthegap_tpu_torch.find import scan_device as S
from mindthegap_tpu_torch.ops import extmap as X
from mindthegap_tpu_torch.ops import kmers as K
from mindthegap_tpu_torch.ops import nw_device as ND
from mindthegap_tpu_torch.ops import sorted_index as SI
from mindthegap_tpu_torch.parallel import sharded_count as PSC
from mindthegap_tpu_torch.parallel import sharded_membership as PSM
from torch_tables import (HALO_STATES, INDEX_EDGE_NAMES, MEMBER_EDGE_NAMES, PAIR_PIPELINE_NAMES, PAIR_TILE_KS,
                          PLANE_EDGE_NAMES, PLANE_PIPELINE_NAMES, ROUTE_EDGE_NAMES, SCAN_EDGE_NAMES, SCATTER_EDGE_NAMES,
                          SORTED_EDGE_NAMES, SPAN_EDGE_NAMES, SPAN_TILE_CASES, SWIZZLE_EDGE_NAMES, edge_walk_case,
                          edge_walk_span_case, index_edge_sets, key_edge_batches, member_edge_cases, merge_edge_cases,
                          move_to_stash, pair_pipeline_case, pair_tile_case, plane_edge_windows, plane_pipeline_case,
                          route_edge_cases, scan_edge_windows, scatter_edge_cases, sorted_edge_windows,
                          span_edge_windows, span_tile_case, swizzle_edge_chunks)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _equal_scans(got, want):
    for key in ("cls2", "exc16", "n_exc"):
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("k", [21, 31, 32])
def test_scan_kernel_matches_plain(cuda, k):
    """K1, the whole scan_cls_qp (classes and exception compaction),
    against its plain version."""
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome, k)
    solid = np.unique(K.canonical_u64(fwd[: 150_000], k))
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    host = X.build_fused_pair(solid, k, np.unique(K.canonical_u64(rfwd[::30], k - 1)))
    # a stash of 40 entries exercises the kernel's shared-memory stash search
    r, _ = K.kmers_from_codes(genome[50_100:50_140 + k], k - 2)
    qp = move_to_stash(host, np.unique(K.canonical_u64(r, k - 2))[:40]).to(cuda)
    codes = genome[50_000:50_000 + 65_536].copy()
    codes[rng.integers(0, codes.size, 40)] = 255
    packed, bad = S.pack_codes_host(codes)
    args = (torch.from_numpy(packed).to(cuda), torch.from_numpy(bad).to(cuda),
            qp.slots, qp.stash_keys, qp.stash_l, qp.stash_r, qp.log_size, k, (65_536 - k + 2 + 3) // 4 * 4 // 8)
    want = S._scan_cls_qp_plain(*args)
    before = S.scan_cls_qp_cuda.launches
    got = S.scan_cls_qp_cuda(*args)
    torch.cuda.synchronize()
    assert S.scan_cls_qp_cuda.launches == before + 1
    _equal_scans(got, want)
    assert int(want["n_exc"]) > 0
    # a stash out of key order takes the kernel's full scan, not its binary search
    unsorted = args[:3] + tuple(t.flip(0) for t in args[3:6]) + args[6:]
    _equal_scans(S.scan_cls_qp_cuda(*unsorted), S._scan_cls_qp_plain(*unsorted))
    assert torch.equal(S._scan_cls_qp_plain(*unsorted)["exc16"], want["exc16"])


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("name", SCAN_EDGE_NAMES)
def test_scan_kernel_edge_cases(cuda, name, k):
    """K1 against its plain version on its compaction edges
    (tests/torch_tables.py scan_edge_windows)."""
    qp, cases = scan_edge_windows(k)
    codes, cap = cases[name]
    t = qp.to(cuda)
    packed, bad = (torch.from_numpy(a).to(cuda) for a in S.pack_codes_host(codes))
    args = (packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, t.log_size, k, cap)
    want = S._scan_cls_qp_plain(*args)
    _equal_scans(S.scan_cls_qp_cuda(*args), want)


@pytest.mark.parametrize("name", list(key_edge_batches()))
def test_key_kernel_edge_cases(cuda, name):
    """K3 against its plain version on its edges (tests/torch_tables.py
    key_edge_batches)."""
    from mindthegap_tpu_torch.ops import counting_device as C

    codes, k = key_edge_batches()[name]
    packed, bad = (torch.from_numpy(a).to(cuda) for a in S.pack_codes_host(codes))
    want = C._kmer_keys_plain(packed, bad, k)
    got = C.kmer_keys_cuda(packed, bad, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [15, 31, 32])
def test_count_kernels_match_plain(cuda, k):
    """K3 (extract + canonicalize) and K4 (merge + fold, a truncated out_cap
    included) against their plain versions."""
    from mindthegap_tpu_torch.ops import counting_device as C

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 1 << 16, dtype=np.uint8)
    codes[rng.integers(0, codes.size, 300)] = 255
    packed, bad = (torch.from_numpy(a).to(cuda) for a in S.pack_codes_host(codes))
    before = C.kmer_keys_cuda.launches
    got = C.kmer_keys_cuda(packed, bad, k)
    assert C.kmer_keys_cuda.launches == before + 1
    assert torch.equal(got, C._kmer_keys_plain(packed, bad, k))
    batch = torch.sort(got).values
    # an accumulator from half of the batch's distinct keys, with counts
    acc_k, acc_c, nd = C._merge_sorted_plain(batch[:0], batch[:0].clone(), batch[::2].contiguous(), 1 << 16)
    acc_c = acc_c * 7
    for out_cap in (1 << 16, int(nd) // 3):
        want = C._merge_sorted_plain(acc_k, acc_c, batch, out_cap)
        got = C.merge_sorted_cuda(acc_k, acc_c, batch, out_cap)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
@pytest.mark.parametrize("k", [21, 31, 32])
def test_walk_kernel_matches_plain(cuda, layout, k):
    """K5 against its plain version on a random genome's graph with stash
    entries, budgets of 0, small and large."""
    from mindthegap_tpu_torch.fill import walk_device as W
    from torch_tables import move_to_stash_walk

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 100_000, dtype=np.uint8)
    genome[50_000:50_200] = genome[20_000:20_200]  # a repeat: forks and merges
    fwd, _ = K.kmers_from_codes(genome, k)
    solid = np.unique(K.canonical_u64(fwd, k))
    build = X.build_fused_bucket if layout == "bucket" else X.build_fused
    host = build(solid, k, np.zeros(0, np.uint64))
    pre = np.unique(K.canonical_u64(solid >> np.uint64(2), k - 1))
    qm = move_to_stash_walk(host, pre[::997][:40])
    t = qm.to(cuda)
    log = qm.log_nb if layout == "bucket" else qm.log_size
    nodes = fwd[rng.integers(0, fwd.size, 512)]
    budgets = np.concatenate([np.zeros(64), rng.integers(1, 50, 192), np.full(256, 10_000)]).astype(np.int32)
    args = (torch.from_numpy(K.as_i64(nodes)).to(cuda), torch.from_numpy(budgets).to(cuda),
            t.slots, t.stash_keys, t.stash_payload, log, k, 512, layout)
    before = W.walk_batch_cuda.launches
    got = W.walk_batch_cuda(*args)
    want = W._walk_batch_plain(*args)
    torch.cuda.synchronize()
    assert W.walk_batch_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) == 512  # some lanes walk every step


@pytest.mark.parametrize("name", list(merge_edge_cases()))
def test_merge_kernel_edge_cases(cuda, name):
    """K4 against its plain version on its tile edges: a run over more than
    3 tiles, out_cap inside it and at a tile boundary, sentinel inputs."""
    from mindthegap_tpu_torch.ops import counting_device as C

    acc_k, acc_c, batch, out_cap = merge_edge_cases()[name]
    args = [torch.from_numpy(K.as_i64(acc_k) ^ K.SIGN_BIT).to(cuda), torch.from_numpy(acc_c).to(cuda),
            torch.from_numpy(K.as_i64(batch) ^ K.SIGN_BIT).to(cuda)]
    got = C.merge_sorted_cuda(*args, out_cap)
    want = C._merge_sorted_plain(*args, out_cap)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
@pytest.mark.parametrize("k,lanes", [(9, 8), (31, 37), (32, 100)])
def test_walk_kernel_edge_cases(cuda, k, lanes, layout):
    """K5 against its plain version on the look-ahead's edges
    (tests/torch_tables.py walk_edge_inputs), at every depth and probe
    the kernel takes."""
    from mindthegap_tpu_torch.fill import walk_device as W

    _qm, args = edge_walk_case(layout, k, lanes, cuda)
    want = W._walk_batch_plain(*args)
    for depth in W.DEPTHS:
        got = W.walk_batch_cuda(*args, depth=depth)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), depth


def test_nw_kernel_matches_plain(cuda):
    """K2 against its plain version, in one launch, on random pairs and on
    the seams of its stripes (h = 32 R rows a warp, W warps a pair): n =
    h - 1, h, h + 1, W h +- 1 and 3 W h, each against a mutated copy and a
    two-letter pair (up and left tie often); a single row and a single
    column; one 10,000 x 10,000 pair."""
    rng = np.random.default_rng(0)

    def rand(n, letters="ACGT"):
        return "".join(rng.choice(list(letters), n))

    pairs = [(rand(int(rng.integers(1, 400))), rand(int(rng.integers(1, 400)))) for _ in range(32)]
    h, w = ND.nw_geometry()
    for n in (h - 1, h, h + 1, w * h - 1, w * h + 1, 3 * w * h):
        a = np.array(list(rand(n)))
        b = a.copy()
        b[rng.integers(0, n, n // 20)] = "T"
        pairs += [("".join(a), "".join(np.delete(b, rng.integers(0, n, n // 100 + 1)))),
                  (rand(n, "AC"), rand(n + 7, "AC"))]
    pairs += [("G", rand(5000)), (rand(5000), "G"), (rand(10_000), rand(10_000))]
    seq, off = ND.pack_pairs(pairs)
    before = ND.nw_matches_cuda.launches
    got = ND.nw_matches_cuda(seq.to(cuda), off.to(cuda))
    torch.cuda.synchronize()
    assert ND.nw_matches_cuda.launches == before + 1
    want = ND._nw_matches_plain(seq.to(cuda), off.to(cuda))
    assert torch.equal(got.cpu(), want.cpu())


def _span_args(qms, t, codes, device):
    packed, bad = (torch.from_numpy(a).to(device) for a in S.pack_codes_host(codes))
    return (packed, bad, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size)


@pytest.mark.parametrize("k", [33, 45, 64, 65, 96, 128, 256])
@pytest.mark.parametrize("name", SPAN_EDGE_NAMES)
def test_span_scan_kernel_edge_cases(cuda, name, k):
    """K6 against its plain version on its edges (tests/torch_tables.py
    span_edge_windows): Ns across tiles, stash hits, an unrelated window,
    invalid bases only, the shortest window; PER 4 (k <= 129) and 2 (past
    it) spread a byte of rep8 and str8 over 2 and 4 threads; one launch a
    call."""
    qms, cases = span_edge_windows(k)
    t = qms.to(cuda)
    args = _span_args(qms, t, cases[name], cuda) + (k,)
    want = S._scan_pay_q_span_plain(*args)
    before = S.scan_pay_q_span_cuda.launches
    got = S.scan_pay_q_span_cuda(*args)
    torch.cuda.synchronize()
    assert S.scan_pay_q_span_cuda.launches == before + 1
    for key in ("pay8", "rep8", "str8"):
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("k", [33, 45, 65, 96, 128, 256])
def test_span_scan_kernel_matches_plain(cuda, k):
    """K6 against its plain version on a 2^16-base window of a genome whose
    k-mers fill the map (with a repeat set), with isolated Ns."""
    from mindthegap_tpu_torch.ops.span import Span

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 100_000, dtype=np.uint8)
    sp, spm1 = Span(k), Span(k - 1)
    fwd, _ = sp.from_codes(genome[:80_000])
    solid = sp.from_keys(np.unique(sp.keys(sp.canonical(fwd))))
    q, _ = spm1.from_codes(genome)
    rep = spm1.from_keys(np.unique(spm1.keys(spm1.canonical(q[::30]))))
    qms = X.build_fused_span(solid, k, rep)
    codes = genome[10_000:10_000 + 65_536].copy()
    codes[rng.integers(0, codes.size, 40)] = 255
    args = _span_args(qms, qms.to(cuda), codes, cuda) + (k,)
    got = S.scan_pay_q_span_cuda(*args)
    want = S._scan_pay_q_span_plain(*args)
    torch.cuda.synchronize()
    for key in ("pay8", "rep8", "str8"):
        assert torch.equal(got[key], want[key]), key
    assert (want["pay8"] != 0).float().mean() > 0.8


@pytest.mark.parametrize("k,lanes", [(33, 48), (45, 37), (45, 1), (64, 8), (65, 100), (96, 64), (128, 40), (256, 33)])
def test_span_walk_kernel_edge_cases(cuda, k, lanes):
    """K7 against its plain version on its edges (tests/torch_tables.py
    edge_walk_span_case): budgets of 0, tips, forks and merges, budget and
    step stops, stash hits; at the rule's look-ahead depth and at every
    depth the kernel is built for; one launch a call."""
    from mindthegap_tpu_torch.fill import walk_device as W

    _qms, args = edge_walk_span_case(k, lanes, cuda)
    want = W._walk_batch_span_plain(*args)
    for depth in (None, *W.DEPTHS):
        before = W.walk_batch_span_cuda.launches
        got = W.walk_batch_span_cuda(*args, depth=depth)
        torch.cuda.synchronize()
        assert W.walk_batch_span_cuda.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), depth
    assert int(want[1].max()) == 64 or lanes <= 8  # some lanes walk every step


# the plane path (k <= 32): K8 (cuckoo map), K9 (bucket map), K10 (pair
# map, the payload stream) and K15 (pair map, the planes)
_PLANE_KERNELS = {"cuckoo": ("scan_planes_q_cuda", "_scan_planes_q_plain"),
                  "bucket": ("scan_planes_qb_cuda", "_scan_planes_qb_plain"),
                  "pair": ("scan_pay_qp_cuda", "_scan_pay_qp_plain"),
                  "pair-planes": ("scan_planes_qp_cuda", "_scan_planes_qp_plain")}


def _map_layout(layout: str) -> str:
    return "pair" if layout.startswith("pair") else layout


def _plane_args(qm, layout: str, codes, device):
    t = qm.to(device)
    packed, bad = (torch.from_numpy(a).to(device) for a in S.pack_codes_host(codes))
    if _map_layout(layout) == "pair":
        return (packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, qm.log_size)
    return (packed, bad, t.slots, t.stash_keys, t.stash_payload, qm.log_nb if layout == "bucket" else qm.log_size)


def _check_plane_kernel(layout: str, args):
    kernel, plain = (getattr(S, name) for name in _PLANE_KERNELS[layout])
    want = plain(*args)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    return want


@pytest.mark.parametrize("layout,k", [(layout, k) for layout in _PLANE_KERNELS for k in (2, 3, 21, 31, 32)
                                      if not (_map_layout(layout) == "pair" and k == 2)  # the pair map needs k >= 3
                                      and (k != 21 or layout == "pair-planes")])
@pytest.mark.parametrize("name", PLANE_EDGE_NAMES)
def test_plane_kernel_edge_cases(cuda, name, layout, k):
    """K8, K9, K10 and K15 against their plain versions on their edges
    (tests/torch_tables.py plane_edge_windows): N runs across the blocks,
    stash hits, the window's first and last positions, a window shorter
    than 2k, both parities of P; one launch a call."""
    qm, cases = plane_edge_windows(k, _map_layout(layout))
    _check_plane_kernel(layout, _plane_args(qm, layout, cases[name], cuda) + (k,))


@pytest.mark.parametrize("layout", list(_PLANE_KERNELS))
@pytest.mark.parametrize("k", [21, 31, 32])
def test_plane_kernel_matches_plain(cuda, layout, k):
    """K8, K9, K10 and K15 against their plain versions on a 2^16-base
    window of a genome whose k-mers fill the map (a repeat set too), with
    isolated Ns and an unaligned length."""
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome[:150_000], k)
    solid = np.unique(K.canonical_u64(fwd, k))
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::30], k - 1))
    build = {"cuckoo": X.build_fused, "bucket": X.build_fused_bucket, "pair": X.build_fused_pair}[_map_layout(layout)]
    codes = genome[50_000:50_000 + 65_536 - 24].copy()
    codes[rng.integers(0, codes.size, 40)] = 255
    want = _check_plane_kernel(layout, _plane_args(build(solid, k, repeat), layout, codes, cuda) + (k,))
    if layout != "pair":
        assert want["contains"].float().mean() > 0.9 and want["suffix_rep"].any()


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("name", PLANE_PIPELINE_NAMES)
def test_plane_kernel_pipeline_cases(cuda, name, k):
    """K8 against its plain version on its pipeline's cases
    (tests/torch_tables.py plane_pipeline_case): persistent blocks taking
    several tiles, a ragged last tile, a queue of second-slot keys, a queue
    of every key of a tile, a full unsorted stash; one launch a call."""
    qm, codes = plane_pipeline_case(k, name)
    _check_plane_kernel("cuckoo", _plane_args(qm, "cuckoo", codes, cuda) + (k,))


@pytest.mark.parametrize("k", [3, 21, 31, 32])
@pytest.mark.parametrize("name", PAIR_PIPELINE_NAMES)
def test_pay_kernel_pipeline_cases(cuda, name, k):
    """K10 against its plain version on its pipeline cases
    (tests/torch_tables.py pair_pipeline_case): over 1,024 tiles with a
    ragged last one and both parities of the last pair, a map near its
    highest load factor, every pair missing its first row, a full stash in
    descending order; one launch a call."""
    qp, codes = pair_pipeline_case(k, name)
    _check_plane_kernel("pair", _plane_args(qp, "pair", codes, cuda) + (k,))


@pytest.mark.parametrize("k", [3, 21, 31, 32])
@pytest.mark.parametrize("name", PAIR_PIPELINE_NAMES)
def test_qp_plane_kernel_pipeline_cases(cuda, name, k):
    """K15 against its plain version on K10's pipeline cases
    (tests/torch_tables.py pair_pipeline_case): over 1,024 tiles (more
    than the card holds blocks at once, so each block takes several), with
    a ragged last tile and both parities of the last pair; a map near its
    highest load factor, every pair missing its first row, a full stash in
    descending order; one launch a call."""
    qp, codes = pair_pipeline_case(k, name)
    _check_plane_kernel("pair-planes", _plane_args(qp, "pair", codes, cuda) + (k,))


@pytest.mark.parametrize("k", [3, 21, 31, 32])
@pytest.mark.parametrize("name", PLANE_EDGE_NAMES)
def test_qp_plane_kernel_empty_repeat_set(cuda, name, k):
    """K15 against its plain version over a pair map built with no repeat
    set (context_genome_wg's): no repeat plane is set."""
    qp, cases = plane_edge_windows(k, "pair", repeats=False)
    want = _check_plane_kernel("pair-planes", _plane_args(qp, "pair", cases[name], cuda) + (k,))
    assert not (want["suffix_rep"].any() or want["prefix_rep"].any())


@pytest.mark.parametrize("state", HALO_STATES)
@pytest.mark.parametrize("k", PAIR_TILE_KS)
def test_qp_plane_kernel_tile_edges(cuda, k, state):
    """K15 against its plain version on its tile edges
    (tests/torch_tables.py pair_tile_case): positions and pairs ending at,
    one before and one after a tile's end, each tile's halo pair in its
    second row, in the stash or absent; one launch a call."""
    qp, codes = pair_tile_case(k, state)
    _check_plane_kernel("pair-planes", _plane_args(qp, "pair", codes, cuda) + (k,))


def _check_span_plane_kernel(args):
    want = S._scan_planes_q_span_plain(*args)
    before = S.scan_planes_q_span_cuda.launches
    got = S.scan_planes_q_span_cuda(*args)
    torch.cuda.synchronize()
    assert S.scan_planes_q_span_cuda.launches == before + 1
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    return want


@pytest.mark.parametrize("k", [33, 45, 64, 65, 96, 128, 129, 256])
@pytest.mark.parametrize("name", SPAN_EDGE_NAMES)
@pytest.mark.parametrize("repeats", [True, False])
def test_span_plane_kernel_edge_cases(cuda, name, k, repeats):
    """K16 against its plain version on K6's edge windows
    (tests/torch_tables.py span_edge_windows), over the span map with and
    without a repeat set: Ns across tiles, stash hits, an unrelated window,
    invalid bases only, the shortest window; every (Wq, Wk) pair of words
    from 1 and 2 to 8 and 8, at both parities of P (the rows of fwd_words
    16-byte aligned or not) and both of the kernel's keys a thread (4 to k
    = 129, then 2); one launch a call."""
    qms, cases = span_edge_windows(k, repeats=repeats)
    _check_span_plane_kernel(_span_args(qms, qms.to(cuda), cases[name], cuda) + (k,))


@pytest.mark.parametrize("k", [33, 45, 65, 128, 256])
def test_span_plane_kernel_matches_plain(cuda, k):
    """K16 against its plain version on a 2^16-base window (many tiles,
    each tile's last position written by the next) of a genome whose
    k-mers fill the map, with a repeat set and isolated Ns."""
    from mindthegap_tpu_torch.ops.span import Span

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 100_000, dtype=np.uint8)
    sp, spm1 = Span(k), Span(k - 1)
    fwd, _ = sp.from_codes(genome[:80_000])
    solid = sp.from_keys(np.unique(sp.keys(sp.canonical(fwd))))
    q, _ = spm1.from_codes(genome)
    rep = spm1.from_keys(np.unique(spm1.keys(spm1.canonical(q[::30]))))
    qms = X.build_fused_span(solid, k, rep)
    codes = genome[10_000:10_000 + 65_536].copy()
    codes[rng.integers(0, codes.size, 40)] = 255
    want = _check_span_plane_kernel(_span_args(qms, qms.to(cuda), codes, cuda) + (k,))
    assert want["contains"].float().mean() > 0.8 and want["suffix_rep"].any()


@pytest.mark.parametrize("state", HALO_STATES)
@pytest.mark.parametrize("k,side", SPAN_TILE_CASES)
def test_span_plane_kernel_tile_edges(cuda, k, side, state):
    """K16 against its plain version on its tile edges
    (tests/torch_tables.py span_tile_case): windows ending at, just below
    and just above a tile's end at k = 45, 128, 129 and 130 (4 keys a
    thread, then 2), each tile's halo key in its second slot, in the stash
    or absent; one launch a call."""
    qms, codes = span_tile_case(k, side, state)
    _check_span_plane_kernel(_span_args(qms, qms.to(cuda), codes, cuda) + (k,))


@pytest.mark.parametrize("k", [45, 130])
def test_span_plane_kernel_many_tiles(cuda, k):
    """K16 against its plain version on a window of 2^20 + 296 bases, over
    1,000 tiles: more than the card holds blocks at once, so each block
    takes several, the last one ragged; N runs across tiles."""
    from mindthegap_tpu_torch.ops.span import Span

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, (1 << 20) + 4096, dtype=np.uint8)
    sp = Span(k)
    fwd, _ = sp.from_codes(genome[: 200_000])
    qms = X.build_fused_span(sp.from_keys(np.unique(sp.keys(sp.canonical(fwd)))), k,
                             np.zeros((0, Span(k - 1).W), np.uint64))
    codes = genome[1000 : 1000 + (1 << 20) + 296].copy()
    for lo in range(1000, codes.size, 100_003):
        codes[lo : lo + 40] = 255
    _check_span_plane_kernel(_span_args(qms, qms.to(cuda), codes, cuda) + (k,))


@pytest.mark.parametrize("k", [31, 45])
def test_context_genome_wg_on_the_card(cuda, tmp_path, k, capsys):
    """context_genome_wg on the card (K15 at k = 31, K16 at k = 45, one
    launch a window) writes the bytes of its `-device cpu` run, also over
    windows far smaller than the default."""
    from mindthegap_tpu_torch.graph.dbg import Graph
    from mindthegap_tpu_torch.scripts import context_genome_wg as C
    from torch_tables import script_case

    case = script_case(str(tmp_path), k)
    paths = case["paths"]
    args = ["-g", paths["graph.h5"], "-p", paths["ref.fa"], "-b", paths["t.breakpoints"]]
    kernel = S.scan_planes_qp_cuda if k <= 32 else S.scan_planes_q_span_cuda
    before = kernel.launches
    assert C.main(args + ["-o", str(tmp_path / "gpu.bkpt")]) == 0
    assert kernel.launches == before + 2  # one window a sequence
    assert C.main(args + ["-o", str(tmp_path / "cpu.bkpt"), "-device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] and lines[0].startswith("kept ")
    assert (tmp_path / "gpu.bkpt").read_bytes() == (tmp_path / "cpu.bkpt").read_bytes()
    graph = Graph.load(paths["graph.h5"])
    small = C.device_degree_fn(graph, cuda, window=1024)
    host = C.device_degree_fn(graph, torch.device("cpu"), window=1024)
    for codes in case["seqs"].values():
        assert np.array_equal(small(codes), host(codes))


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
def test_plane_kernel_unaligned_planes(cuda, layout):
    """K8 and K9 write planes that are views at unaligned offsets (through
    _scan_planes_into: the wrappers allocate their planes aligned) element
    by element, equal to the plain version; K8 on its long window too."""
    qm, cases = plane_edge_windows(31, layout)
    windows = [(qm, codes) for codes in cases.values()]
    if layout == "cuckoo":
        windows.append(plane_pipeline_case(31, "long-ragged"))
    for qm, codes in windows:
        args = _plane_args(qm, layout, codes, cuda) + (31,)
        want = getattr(S, _PLANE_KERNELS[layout][1])(*args)
        views = {key: torch.zeros(v.numel() + 1, dtype=v.dtype, device=cuda)[1:] for key, v in want.items()}
        S._scan_planes_into(*args, layout == "bucket", views)
        torch.cuda.synchronize()
        for key in S.PLANE_KEYS:
            assert torch.equal(views[key], want[key]), key


@pytest.mark.parametrize("k", [21, 31])
def test_dense_redispatch_runs_k10(cuda, k):
    """K1's feed at exc_cap 0 sends every window dense through K10 (one
    launch a window) and yields the chunks of its CPU run."""
    from mindthegap_tpu_torch.find import runner as R
    from mindthegap_tpu_torch.graph import dbg as D

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
    genome[7000:7040] = 255
    fwd, _ = K.kmers_from_codes(genome[:30_000], k)
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    graph = D.Graph(D.SolidSet(np.unique(K.canonical_u64(fwd, k)), k))
    rep = D.SolidSet(np.unique(K.canonical_u64(rfwd[::40], k - 1)), k - 1)
    want = list(R._make_pay_feed_fn(graph, rep, k, torch.device("cpu"), window=8192, exc_cap=0)(genome))
    before = S.scan_pay_qp_cuda.launches
    got = list(R._make_pay_feed_fn(graph, rep, k, cuda, window=8192, exc_cap=0)(genome))
    assert S.scan_pay_qp_cuda.launches == before + len(want) == before + 5
    assert [c[0] for c in got] == ["pay"] * 5
    for g, w in zip(got, want):
        assert g[4] == w[4]
        for a, b in zip(g[1:3], w[1:3]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the device mesh: K11 (sharded_count.cu), K12 and K13 (sharded_member.cu),
# K14 (scan_sorted.cu), the bucket index of K13 and K14 (sorted_index.cu);
# the mesh's paths on logical shards of the card

@pytest.mark.parametrize("k", [1, 2, 3, 31, 32])
@pytest.mark.parametrize("name", SWIZZLE_EDGE_NAMES)
def test_swizzle_kernel_edge_cases(cuda, name, k):
    """K11 against its plain version on its edge chunks
    (tests/torch_tables.py swizzle_edge_chunks), aligned and as a view at
    an odd byte offset (every unit staged byte by byte)."""
    codes = torch.from_numpy(swizzle_edge_chunks(k)[name]).to(cuda)
    shifted = torch.empty(codes.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted[1:] = codes
    const = PSC.pick_swizzle_const(k)
    want = PSC._swizzle_keys_plain(codes, k, const)
    for view in (codes, shifted[1:]):
        before = PSC.swizzle_keys_cuda.launches
        got = PSC.swizzle_keys_cuda(view, k, const)
        torch.cuda.synchronize()
        assert PSC.swizzle_keys_cuda.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_swizzle_kernel_matches_plain(cuda):
    """K11 on a 2^20-base chunk of read codes joined by invalid bases."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (1 << 20) + 30, dtype=np.uint8)
    codes[150::151] = 255
    t = torch.from_numpy(codes).to(cuda)
    const = PSC.pick_swizzle_const(31)
    for g, w in zip(PSC.swizzle_keys_cuda(t, 31, const), PSC._swizzle_keys_plain(t, 31, const)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", MEMBER_EDGE_NAMES + ROUTE_EDGE_NAMES)
def test_member_kernels_edge_cases(cuda, name):
    """K12 (the route), then K13 (the probe on each owner, through the
    owner's bucket index and through one built in the wrapper, the scatter
    on each source) against their plain versions, stage by stage, on n
    logical shards of the card (tests/torch_tables.py member_edge_cases, and
    K12's 64 shards in route_edge_cases); then the whole contains against
    np.isin."""
    from mindthegap_tpu_torch.parallel import mesh as M

    keys, q, n, cap_factor = {**member_edge_cases(), **route_edge_cases()}[name]
    mesh = [cuda] * n
    sm = PSM.ShardedMembership(mesh, keys, cap_factor=cap_factor)
    rows, cap = sm.batch(q)
    routed = []
    for j in range(n):
        args = sm.route_args(j, rows, cap)
        got, want = PSM.member_route_cuda(*args), PSM._route_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        routed.append(got)
    found = []
    for o, recv in enumerate(M.exchange([r[0].reshape(n, cap) for r in routed], mesh)):
        got = PSM.member_probe_cuda(recv, sm.shard_keys[o], sm.shard_index[o])
        assert torch.equal(got, PSM._probe_plain(recv, sm.shard_keys[o]))
        assert torch.equal(PSM.member_probe_cuda(recv, sm.shard_keys[o]), got)  # the index built in the wrapper
        found.append(got.reshape(n, cap))
    for d, back in enumerate(M.exchange(found, mesh)):
        got = PSM.member_scatter_cuda(back, routed[d][1], rows.shape[1])
        assert torch.equal(got, PSM._scatter_plain(back, routed[d][1], rows.shape[1]))
    np.testing.assert_array_equal(sm.contains(q), np.isin(q, keys))


@pytest.mark.parametrize("name", SCATTER_EDGE_NAMES)
def test_scatter_kernel_edge_cases(cuda, name):
    """K13's scatter against its plain version on its edge cases
    (tests/torch_tables.py scatter_edge_cases); one launch a call. Views
    at unaligned offsets (lanes 4 bytes, verdicts 1 byte in) are refused
    with no launch."""
    back, send_lane, lanes = scatter_edge_cases()[name]
    b, l = torch.from_numpy(back).to(cuda), torch.from_numpy(send_lane).to(cuda)
    bo = torch.empty(b.numel() + 1, dtype=torch.uint8, device=cuda)
    lo = torch.empty(l.numel() + 1, dtype=torch.int32, device=cuda)
    bo[1:], lo[1:] = b, l
    want = PSM._scatter_plain(b, l, lanes)
    before = PSM.member_scatter_cuda.launches
    got = PSM.member_scatter_cuda(b, l, lanes)
    torch.cuda.synchronize()
    assert PSM.member_scatter_cuda.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)
    for vb, vl in ((bo[1:], l), (b, lo[1:])):
        with pytest.raises(ValueError, match="aligned"):
            PSM.member_scatter_cuda(vb, vl, lanes)
    assert PSM.member_scatter_cuda.launches == before + 1


@pytest.mark.parametrize("k", [2, 3, 21, 31, 32])
@pytest.mark.parametrize("name", SORTED_EDGE_NAMES)
def test_scan_sorted_kernel_edge_cases(cuda, name, k):
    """K14 against its plain version on its edge windows
    (tests/torch_tables.py sorted_edge_windows)."""
    codes, solid, repeat = sorted_edge_windows(k)[name]
    args = (torch.from_numpy(codes).to(cuda), *(torch.from_numpy(K.as_i64(s)).to(cuda) for s in (solid, repeat)), k)
    before = S.scan_planes_sorted_cuda.launches
    got, want = S.scan_planes_sorted_cuda(*args), S._scan_planes_sorted_plain(*args)
    torch.cuda.synchronize()
    assert S.scan_planes_sorted_cuda.launches == before + 1
    for key in S.PLANE_KEYS:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def _check_index_kernel(keys: torch.Tensor):
    top = SI.log_buckets(keys.shape[0])
    for log_b in sorted({top, max(1, top - 1), max(1, top - 2), 1}):  # about 1, 2 and 4 keys a bucket, 2 buckets
        before = SI.build_cuda.launches
        got, want = SI.build_cuda(keys, log_b), SI._build_plain(keys, log_b)
        assert SI.build_cuda.launches == before + 1
        assert torch.equal(got.start, want.start) and torch.equal(got.head, want.head)
        # every start written: the launcher into outputs filled with -7 (the wrapper's may hold an earlier build)
        start, head = torch.full_like(want.start, -7), torch.full_like(want.head, -7)
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        assert SI._lib().sorted_index_launch(keys.data_ptr() or start.data_ptr(), keys.shape[0], log_b,
                                             start.data_ptr(), head.data_ptr(), stream) == 0
        assert torch.equal(start, want.start) and torch.equal(head, want.head)


@pytest.mark.parametrize("name", MEMBER_EDGE_NAMES)
def test_sorted_index_kernel_on_member_shards(cuda, name):
    """The bucket index's build kernel against its plain version on every
    owner's shard of K13's edge cases (SENTINEL padding included)."""
    keys, _q, n, cap_factor = member_edge_cases()[name]
    for shard in PSM.ShardedMembership([cuda] * n, keys, cap_factor=cap_factor).shard_keys:
        _check_index_kernel(shard)


@pytest.mark.parametrize("k", [2, 3, 31, 32])
@pytest.mark.parametrize("name", SORTED_EDGE_NAMES)
def test_sorted_index_kernel_on_sorted_sets(cuda, name, k):
    """The build kernel against its plain version on K14's solid and repeat
    sets of each edge window."""
    _codes, solid, repeat = sorted_edge_windows(k)[name]
    for keys in (solid, repeat):
        _check_index_kernel(torch.from_numpy(K.as_i64(keys)).to(cuda))


@pytest.mark.parametrize("name", INDEX_EDGE_NAMES)
def test_sorted_index_kernel_on_index_edge_sets(cuda, name):
    """The build kernel against its plain version on its own edge sets
    (tests/torch_tables.py index_edge_sets): SENTINEL tails of one key to
    most of the set, hi - lo just above a power of two, 2^20 keys and one
    either side, no key, keys across 2^63."""
    _check_index_kernel(torch.from_numpy(K.as_i64(index_edge_sets()[name])).to(cuda))


def test_entry_runs_k14(cuda):
    """entry() on the card: it builds each set's bucket index once (the
    build kernel), its function is K14 alone on those sets, equal to the
    plain pass, and builds the indexes of any other sets in the call."""
    from mindthegap_tpu_torch import graft_entry as G

    before = SI.build_cuda.launches
    fn, args = G.entry()
    assert all(a.is_cuda for a in args) and SI.build_cuda.launches == before + 2
    want = S._scan_planes_sorted_plain(*args, 31)
    other = (args[0], args[1].clone(), args[2])
    for sets, builds in ((args, 0), (args, 0), (other, 2)):
        before = S.scan_planes_sorted_cuda.launches, SI.build_cuda.launches
        got = fn(*sets)
        assert (S.scan_planes_sorted_cuda.launches, SI.build_cuda.launches) == (before[0] + 1, before[1] + builds)
        for key in S.PLANE_KEYS:
            assert torch.equal(got[key], want[key]), key
    args[2][0] = args[2][1]  # in place: the repeat set's index no longer holds
    before = SI.build_cuda.launches
    got = fn(*args)
    assert SI.build_cuda.launches == before + 2
    for key in S.PLANE_KEYS:
        assert torch.equal(got[key], S._scan_planes_sorted_plain(*args, 31)[key]), key


def _check_mesh_paths(mesh):
    """On `mesh`: the sharded counter (K11) equals the host counter, also
    when its capacity overflows; sharded membership (K12, K13) equals
    np.isin, each owner's bucket index on the owner's card; the dryrun's
    value checks pass."""
    from mindthegap_tpu_torch import graft_entry as G
    from mindthegap_tpu_torch.ops import counting as C
    from mindthegap_tpu_torch.parallel import mesh as M

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 50_000, dtype=np.uint8)
    reads = [genome[s : s + 150] for s in rng.integers(0, genome.size - 150, 2000)]
    host = C.StreamingCounter(31)
    for r in reads:
        host.add_codes(r)
    want = host.result()
    for slack in (1.10, 0.0):
        before = PSC.swizzle_keys_cuda.launches
        sc = PSC.ShardedStreamingCounter(31, mesh, batch_bases=1 << 16, slack=slack)
        for r in reads:
            sc.add_codes(r)
        got = sc.result()
        assert PSC.swizzle_keys_cuda.launches > before
        np.testing.assert_array_equal(got.kmers, want.kmers)
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.histogram, want.histogram)
    before = (PSM.member_route_cuda.launches, PSM.member_probe_cuda.launches, PSM.member_scatter_cuda.launches)
    q = np.concatenate([want.kmers[::5], want.kmers[::7] ^ np.uint64(1)])
    sm = PSM.ShardedMembership(mesh, want.kmers)
    for dev, index in zip(mesh, sm.shard_index):  # each owner's bucket index on the owner's card
        assert index.start.device == index.head.device == torch.empty(0, device=dev).device
    np.testing.assert_array_equal(sm.contains(q), np.isin(q, want.kmers))
    after = (PSM.member_route_cuda.launches, PSM.member_probe_cuda.launches, PSM.member_scatter_cuda.launches)
    assert all(a == b + len(mesh) for a, b in zip(after, before))
    with M.logical_devices(mesh):
        G.dryrun_multichip(len(mesh))


def test_mesh_paths_on_logical_shards(cuda):
    """The mesh paths on 4 logical shards of the card."""
    _check_mesh_paths([cuda] * 4)


def test_mesh_paths_across_cards(cuda, tmp_path, monkeypatch):
    """The mesh paths with shard j on cuda:j (every launch on its shard's
    card), the sorted-set scan (K14) over the cards equal to its plain
    pass, and `fill -fill-engine device`, whose walker takes the mesh of
    every card by itself, writing the native fill's artifacts."""
    from mindthegap_tpu_torch.fill.runner import run_fill
    from mindthegap_tpu_torch.find.runner import run_find
    from mindthegap_tpu_torch.parallel import mesh as M

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more (shard 1 on cuda:1)")
    mesh = M.pow2_mesh(M.make_mesh("cuda"))
    assert mesh[1] == torch.device("cuda", 1)
    _check_mesh_paths(mesh)

    rng = np.random.default_rng(5)
    windows = rng.integers(0, 4, (2 * len(mesh), 4096), dtype=np.uint8)
    windows[1, 100:140] = 255
    solid = np.unique(rng.integers(0, 1 << 62, 1 << 14, dtype=np.uint64))
    repeat = np.unique(rng.integers(0, 1 << 60, 1 << 8, dtype=np.uint64))
    got = M.sharded_scan(mesh, windows, solid, repeat, 31)
    for j, w in enumerate(windows):
        sets = (torch.from_numpy(K.as_i64(a)) for a in (solid, repeat))
        want = S._scan_planes_sorted_plain(torch.from_numpy(w), *sets, 31)
        for key in S.PLANE_KEYS:
            np.testing.assert_array_equal(got[key][j].view(np.int64) if key == "fwd" else got[key][j],
                                          want[key].numpy(), err_msg=f"{key} of window {j}")

    import chip_smoke as CS

    ref, donor, _ = CS.make_case(40_000, n_ins=3, n_snp=1, n_del=1, seed=21)
    monkeypatch.chdir(tmp_path)
    CS.write_fasta("ref.fa", CS.CHROM, ref)
    reads = CS.write_reads(str(tmp_path / "reads"), donor, 30.0, seed=22)
    run_find({"in": reads, "ref": "ref.fa", "out": "t", "verbose": "0"}, out=io.StringIO())
    walked = []
    walk_shards = M.walk_shards
    monkeypatch.setattr(M, "walk_shards", lambda mesh_, *a, **kw: walked.append(mesh_) or walk_shards(mesh_, *a, **kw))
    for out, extra in (("tn", {}), ("td", {"fill-engine": "device"})):
        run_fill(dict({"graph": "t.h5", "bkpt": "t.breakpoints", "out": out, "verbose": "0"}, **extra),
                 out=io.StringIO())
    assert walked and all(m == mesh for m in walked)
    for ext in ("insertions.fasta", "insertions.vcf", "info.txt"):
        drop = ("##filedate", "##REF")
        tn, td = ([line for line in open(f"{p}.{ext}") if not line.startswith(drop)] for p in ("tn", "td"))
        assert tn and tn == td, ext
