"""The port's 64-bit word layer (u64 bit patterns in int64 tensors) against
the JAX package's numpy and jnp versions, exactly, on random codes with Ns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.find import scan_device as JS
from mindthegap_tpu.ops import kmers as JK
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.ops import kmers as PK

KS = (5, 15, 31, 32)


def _words(seed, n=4096):
    """Random u64 words covering the high bit."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, n, dtype=np.uint64)


def _codes_with_ns(seed, n=5000):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.integers(0, n, 25)] = 255
    codes[1000:1040] = 255
    return codes


def test_views_are_zero_copy_and_round_trip():
    x = _words(1)
    v = PK.as_i64(x)
    assert np.shares_memory(v, x)
    np.testing.assert_array_equal(PK.as_u64(torch.from_numpy(v)), x)
    assert PK.i64(0xFFFFFFFFFFFFFFFF) == -1 and PK.i64(0x7FFFFFFFFFFFFFFF) == (1 << 63) - 1


@pytest.mark.parametrize("s", [1, 2, 29, 33, 63])
def test_logical_shift(s):
    x = _words(2)
    got = PK.shr(torch.from_numpy(PK.as_i64(x)), s)
    np.testing.assert_array_equal(PK.as_u64(got), x >> np.uint64(s))


def test_unsigned_compare_and_min():
    a, b = _words(3), _words(4)
    a[:10] = b[:10]
    ta, tb = torch.from_numpy(PK.as_i64(a)), torch.from_numpy(PK.as_i64(b))
    np.testing.assert_array_equal(PK.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(PK.as_u64(PK.umin(ta, tb)), np.minimum(a, b))


def test_hash_multiply_wraps_like_u64():
    x = _words(5)
    const = np.uint64(0xC2B2AE3D27D4EB4F)
    want = (x ^ (x >> np.uint64(33))) * const
    want = want ^ (want >> np.uint64(29))
    t = torch.from_numpy(PK.as_i64(x))
    got = (t ^ PK.shr(t, 33)) * PK.i64(const)
    got = got ^ PK.shr(got, 29)
    np.testing.assert_array_equal(PK.as_u64(got), want)


@pytest.mark.parametrize("k", KS)
def test_revcomp_and_canonical(k):
    fwd, _ = JK.kmers_from_codes(_codes_with_ns(k), k)
    t = torch.from_numpy(PK.as_i64(fwd))
    np.testing.assert_array_equal(PK.as_u64(PK.revcomp_u64(t, k)), JK.revcomp_u64(fwd, k))
    np.testing.assert_array_equal(PK.as_u64(PK.canonical_u64(t, k)), JK.canonical_u64(fwd, k))
    # the numpy flavour of the port stays the JAX package's host oracle
    np.testing.assert_array_equal(PK.canonical_u64(fwd, k), JK.canonical_u64(fwd, k))


@pytest.mark.parametrize("k", KS)
def test_rolling_kmers(k):
    codes = _codes_with_ns(100 + k)
    jf, jv = JS.rolling_kmers_device(jnp.asarray(codes), k)
    pf, pv = PS.rolling_kmers(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(PK.as_u64(pf), np.asarray(jf))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    hf, hv = JK.kmers_from_codes(codes, k)
    np.testing.assert_array_equal(pv.numpy(), hv)
    np.testing.assert_array_equal(PK.as_u64(pf)[hv], hf[hv])


def test_pack_unpack_round_trip():
    codes = _codes_with_ns(7, n=4096)
    packed, bad = PS.pack_codes_host(codes)
    jp, jb = JS.pack_codes_host(codes)
    np.testing.assert_array_equal(packed, jp)
    np.testing.assert_array_equal(bad, jb)
    got = PS.unpack_codes(torch.from_numpy(packed), torch.from_numpy(bad))
    np.testing.assert_array_equal(got.numpy(), codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JS.unpack_codes_device(jnp.asarray(jp), jnp.asarray(jb))))
