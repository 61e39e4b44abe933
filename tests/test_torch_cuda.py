"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. Marked `cuda`: they skip without a CUDA device; on a GPU
machine run `python -m pytest tests/test_torch_cuda.py -m cuda`.
(chip_smoke.py runs the same comparisons at the main path's shapes.)"""

import numpy as np
import pytest
import torch

from mindthegap_tpu_torch.find import scan_device as S
from mindthegap_tpu_torch.ops import extmap as X
from mindthegap_tpu_torch.ops import kmers as K
from mindthegap_tpu_torch.ops import nw_device as ND
from torch_tables import edge_walk_case, merge_edge_cases, move_to_stash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [21, 31, 32])
def test_scan_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 200_000, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome, k)
    solid = np.unique(K.canonical_u64(fwd[: 150_000], k))
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    host = X.build_fused_pair(solid, k, np.unique(K.canonical_u64(rfwd[::30], k - 1)))
    # a stash of 40 entries exercises the kernel's shared-memory stash pass
    r, _ = K.kmers_from_codes(genome[50_100:50_140 + k], k - 2)
    qp = move_to_stash(host, np.unique(K.canonical_u64(r, k - 2))[:40]).to(cuda)
    codes = genome[50_000:50_000 + 65_536].copy()
    codes[rng.integers(0, codes.size, 40)] = 255
    packed, bad = S.pack_codes_host(codes)
    args = (torch.from_numpy(packed).to(cuda), torch.from_numpy(bad).to(cuda),
            qp.slots, qp.stash_keys, qp.stash_l, qp.stash_r, qp.log_size, k)
    before = S.cls_core_cuda.launches
    got = S.cls_core_cuda(*args)
    want = S._cls_core_plain(*args)
    torch.cuda.synchronize()
    assert S.cls_core_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    rng = np.random.default_rng(0)
    pairs = [("".join(rng.choice(list("ACGT"), int(rng.integers(1, 400)))),
              "".join(rng.choice(list("ACGT"), int(rng.integers(1, 400))))) for _ in range(32)]
    pairs += [("ACGT" * 2500, "ACGA" * 2400)]  # past the shared-memory limit: the global-scratch launch
    seq, off = ND.pack_pairs(pairs)
    got = ND.nw_matches_cuda(seq.to(cuda), off.to(cuda))
    want = ND._nw_matches_plain(seq, off)
    assert torch.equal(got.cpu(), want)
