"""The port's device counting against the JAX package, exactly, on the CPU:
sort_batch, merge_sorted (truncated case included), pack_counts and
count_batch against their JAX programs, and DeviceStreamingCounter against
the JAX counter and the host StreamingCounter (keys, counts, histogram).
Keys cross between the two as u64 words: the port's device keys are
biased (u64 XOR 2^63 in int64), so the tests remove the bias."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.ops import counting_device as JC
from mindthegap_tpu.ops.counting import StreamingCounter
from mindthegap_tpu_torch.find.scan_device import pack_codes_host
from mindthegap_tpu_torch.ops import counting_device as PC
from mindthegap_tpu_torch.ops import kmers as PK
from torch_tables import key_edge_batches, merge_edge_cases


def _biased(u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(PK.as_i64(u64) ^ PK.SIGN_BIT)


def _unbiased(t: torch.Tensor) -> np.ndarray:
    return PK.as_u64(t ^ PK.SIGN_BIT)


def _codes(seed: int, n: int) -> np.ndarray:
    """Random codes with read separators and N runs (255)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.integers(0, n, n // 150)] = 255
    codes[1000:1012] = 255
    return codes


@pytest.mark.parametrize("k", [15, 31, 32])
def test_sort_batch(k):
    packed, bad = pack_codes_host(_codes(k, 8192))
    want = np.asarray(JC.sort_batch_device(jnp.asarray(packed), jnp.asarray(bad), k))
    got = PC.sort_batch(torch.from_numpy(packed), torch.from_numpy(bad), k)
    np.testing.assert_array_equal(_unbiased(got), want)
    assert (want == JC.SENTINEL).sum() > 100  # separators and Ns give sentinels
    if k == 32:
        assert (want[want != JC.SENTINEL] >> np.uint64(63)).any()  # unsigned order is exercised


_KEY_EDGES = key_edge_batches()


@pytest.mark.parametrize("name", list(_KEY_EDGES))
def test_sort_batch_edge_cases(name):
    """K3's edges (tests/torch_tables.py key_edge_batches): the plain keys
    against the numpy k-mer oracle window by window, and sort_batch against
    the JAX program."""
    codes, k = _KEY_EDGES[name]
    packed, bad = pack_codes_host(codes)
    fwd, valid = PK.kmers_from_codes(codes, k)
    oracle = np.where(valid, PK.canonical_u64(fwd, k), JC.SENTINEL)
    keys = PC._kmer_keys_plain(torch.from_numpy(packed), torch.from_numpy(bad), k)
    np.testing.assert_array_equal(_unbiased(keys), oracle)
    want = np.asarray(JC.sort_batch_device(jnp.asarray(packed), jnp.asarray(bad), k))
    got = PC.sort_batch(torch.from_numpy(packed), torch.from_numpy(bad), k)
    np.testing.assert_array_equal(_unbiased(got), want)
    assert valid.any()


def _acc(rng, n_keys: int, length: int, pool: np.ndarray):
    keys = np.unique(rng.choice(pool, n_keys))
    k = np.full(length, JC.SENTINEL, np.uint64)
    c = np.zeros(length, np.int64)
    k[: keys.size] = keys
    c[: keys.size] = rng.integers(1, 1000, keys.size)
    return k, c


@pytest.mark.parametrize("case", ["empty-acc", "normal", "truncated"])
def test_merge_sorted(case):
    rng = np.random.default_rng(3)
    # a small pool of full-width u64 keys, so that runs repeat and both
    # halves of the unsigned range appear
    pool = rng.integers(0, np.iinfo(np.uint64).max, 3000, dtype=np.uint64, endpoint=False)
    batch = np.sort(np.concatenate([rng.choice(pool, 4000), np.full(300, JC.SENTINEL, np.uint64)]))
    if case == "empty-acc":
        acc_k, acc_c = np.full(512, JC.SENTINEL, np.uint64), np.zeros(512, np.int64)
    else:
        acc_k, acc_c = _acc(rng, 2000, 2048, pool)
    out_cap = 1000 if case == "truncated" else 4096
    jk, jc, jn = JC.merge_sorted_device(jnp.asarray(acc_k), jnp.asarray(acc_c), jnp.asarray(batch), out_cap)
    pk, pc, pn = PC.merge_sorted(_biased(acc_k), torch.from_numpy(acc_c), _biased(batch), out_cap)
    assert pn.dtype == torch.int32 and pn.dim() == 0
    assert int(pn) == int(jn)
    if case == "truncated":
        assert int(jn) > out_cap
    np.testing.assert_array_equal(_unbiased(pk), np.asarray(jk))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


_MERGE_EDGES = merge_edge_cases()


@pytest.mark.parametrize("name", list(_MERGE_EDGES))
def test_merge_sorted_edge_cases(name):
    """K4's tile edges (tests/torch_tables.py merge_edge_cases) through the
    plain merge and the JAX program."""
    acc_k, acc_c, batch, out_cap = _MERGE_EDGES[name]
    jk, jc, jn = JC.merge_sorted_device(jnp.asarray(acc_k), jnp.asarray(acc_c), jnp.asarray(batch), out_cap)
    pk, pc, pn = PC.merge_sorted(_biased(acc_k), torch.from_numpy(acc_c), _biased(batch), out_cap)
    assert int(pn) == int(jn)
    np.testing.assert_array_equal(_unbiased(pk), np.asarray(jk))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    if name.startswith("cap-"):
        assert int(jn) > out_cap  # truncated
    if name == "repeat-over-3-tiles":
        assert int(np.asarray(jc).max()) > 3 * 2048


@pytest.mark.parametrize("exc_cap", [64, 4], ids=["fits", "over-cap"])
def test_pack_counts(exc_cap):
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 200, 5000).astype(np.int64)
    counts[rng.integers(0, 5000, 20)] = rng.integers(256, 100_000, 20)
    j = JC.pack_counts_device(jnp.asarray(counts), exc_cap)
    p = PC.pack_counts(torch.from_numpy(counts), exc_cap)
    assert int(p[3]) == int(j[3]) and (int(j[3]) > exc_cap) == (exc_cap == 4)
    for got, want in zip(p[:3], j[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_count_batch():
    codes = _codes(5, 50_000)
    jk, jc, jn = JC.count_batch_device(jnp.asarray(codes), 21)
    pk, pc, pn = PC.count_batch(torch.from_numpy(codes), 21)
    assert int(pn) == int(jn)
    np.testing.assert_array_equal(PK.as_u64(pk), np.asarray(jk))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def _reads(seed: int, n_reads: int, lo: int, hi: int):
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n_reads):
        r = rng.integers(0, 4, int(rng.integers(lo, hi)), dtype=np.uint8)
        if rng.random() < 0.1:
            r[rng.integers(0, r.size)] = 255  # an N
        reads.append(r)
    return reads


def _hot_reads(seed: int):
    """One read repeated 300 times: its k-mers count above 255."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 4, 60, dtype=np.uint8)
    return [hot] * 300 + _reads(seed + 1, 50, 100, 140)


# (batch_bases, init_cap, reads)
_COUNTER_CASES = {
    "mid-read-splits": (1 << 12, 1 << 20, lambda: _reads(21, 300, 40, 300)),
    "short-final-flush": (1 << 18, 1 << 20, lambda: _reads(22, 1700, 150, 200)),
    "overflow-redo": (1 << 12, 64, lambda: _reads(23, 200, 100, 140)),
    "count-exceptions": (1 << 12, 1 << 20, lambda: _hot_reads(24)),
}


@pytest.mark.parametrize("name", list(_COUNTER_CASES))
def test_device_streaming_counter(name):
    batch, init_cap, make = _COUNTER_CASES[name]
    reads = make()
    k = 21
    host = StreamingCounter(k)
    jdev = JC.DeviceStreamingCounter(k, batch_bases=batch, init_cap=init_cap)
    pdev = PC.DeviceStreamingCounter(k, "cpu", batch_bases=batch, init_cap=init_cap)
    for r in reads:
        host.add_codes(r)
        jdev.add_codes(r)
        pdev.add_codes(r)
    if name == "short-final-flush":
        # one full flush, then a final fill far below the 2^17 floor: the
        # final flush runs at 2^17 bases, not the full batch
        assert 0 < pdev._fill < 1 << 16
    hr, jr, pr = host.result(), jdev.result(), pdev.result()
    for want in (hr, jr):
        np.testing.assert_array_equal(pr.kmers, want.kmers)
        np.testing.assert_array_equal(pr.counts, want.counts)
        np.testing.assert_array_equal(pr.histogram, want.histogram)
    assert pr.kmers.dtype == np.uint64 and pr.kmers.size > 1000
    if name == "overflow-redo":
        assert pdev._cap == jdev._cap > 64
    if name == "count-exceptions":
        assert int(pr.counts.max()) > 255


def test_counter_exception_list_overflow(monkeypatch):
    """More counts above 255 than the exception list holds: result() reads
    the counts back at full width."""
    reads = _hot_reads(25)
    monkeypatch.setattr(PC, "_EXC_CAP", 1)
    host = StreamingCounter(15)
    pdev = PC.DeviceStreamingCounter(15, "cpu", batch_bases=1 << 12)
    for r in reads:
        host.add_codes(r)
        pdev.add_codes(r)
    hr, pr = host.result(), pdev.result()
    assert int((hr.counts > 255).sum()) > 1
    np.testing.assert_array_equal(pr.kmers, hr.kmers)
    np.testing.assert_array_equal(pr.counts, hr.counts)


def test_kernel_wrappers_take_cuda_tensors_only():
    """sort_batch and merge_sorted take the plain versions for CPU tensors;
    the kernel wrappers themselves refuse them (no silent host fallback)."""
    packed, bad = (torch.from_numpy(a) for a in pack_codes_host(_codes(6, 1024)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        PC.kmer_keys_cuda(packed, bad, 21)
    keys = PC.sort_batch(packed, bad, 21)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PC.merge_sorted_cuda(keys[:0], keys[:0], keys, 64)
    assert PC.kmer_keys_cuda.launches == 0 and PC.merge_sorted_cuda.launches == 0
