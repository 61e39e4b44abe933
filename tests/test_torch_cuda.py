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
from torch_tables import move_to_stash

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


def test_nw_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    pairs = [("".join(rng.choice(list("ACGT"), int(rng.integers(1, 400)))),
              "".join(rng.choice(list("ACGT"), int(rng.integers(1, 400))))) for _ in range(32)]
    pairs += [("ACGT" * 2500, "ACGA" * 2400)]  # past the shared-memory limit: the global-scratch launch
    seq, off = ND.pack_pairs(pairs)
    got = ND.nw_matches_cuda(seq.to(cuda), off.to(cuda))
    want = ND._nw_matches_plain(seq, off)
    assert torch.equal(got.cpu(), want)
