"""Bloom filter over a packed uint32 bitset: the replicated prefilter of
sharded membership (parallel/sharded_membership.py); a copy of
mindthegap_tpu/ops/bloom.py with its own copy of the hash constants.

build and contains work on numpy (host); contains_tensor is the
same probe on int64 tensors of u64 keys (the plain version of the Bloom
half of kernel K12, csrc/sharded_member.cu).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kmers as K

_CONSTS = tuple(
    np.uint64(c)
    for c in (
        0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0xD6E8FEB86659FD93,
        0xA0761D6478BD642F, 0xE7037ED1A0B428DB, 0x8EBC6AF09C88C6E3,
        0x589965CC75374CC3, 0x1D8E4E27C47D124F,
    )
)


@dataclass
class BloomFilter:
    bits: np.ndarray  # uint32 [W]
    log_bits: int
    n_hash: int


def _positions(keys, log_bits: int, n_hash: int):
    out = []
    for c in _CONSTS[:n_hash]:
        h = (keys ^ (keys >> np.uint64(33))) * c
        h = h ^ (h >> np.uint64(29))
        out.append(h >> np.uint64(64 - log_bits))
    return out


def build(keys: np.ndarray, bits_per_key: int = 12, n_hash: int | None = None) -> BloomFilter:
    keys = np.asarray(keys, dtype=np.uint64)
    n = max(int(keys.size), 1)
    log_bits = max(6, int(np.ceil(np.log2(n * bits_per_key))))
    if n_hash is None:
        n_hash = max(1, int(0.7 * bits_per_key))
    n_hash = min(n_hash, len(_CONSTS))
    words = np.zeros(1 << (log_bits - 5), dtype=np.uint32)
    for pos in _positions(keys, log_bits, n_hash):
        w = (pos >> np.uint64(5)).astype(np.int64)
        b = (pos & np.uint64(31)).astype(np.uint32)
        np.bitwise_or.at(words, w, np.left_shift(np.uint32(1), b))
    return BloomFilter(words, log_bits, n_hash)


def contains(bf: BloomFilter, keys) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.uint64)
    res = np.ones(keys.shape, dtype=bool)
    for pos in _positions(keys, bf.log_bits, bf.n_hash):
        w = (pos >> np.uint64(5)).astype(np.int64)
        b = (pos & np.uint64(31)).astype(np.uint32)
        res &= ((bf.bits[w] >> b) & np.uint32(1)).astype(bool)
    return res


def contains_tensor(bits: torch.Tensor, log_bits: int, n_hash: int, keys: torch.Tensor) -> torch.Tensor:
    """contains on int64 tensors: `bits` is the bitset's uint32 words as
    int32, `keys` u64 bit patterns as int64. The mix multiplies mod 2^64
    (int64 wraps bit for bit) and shifts logically (kmers.shr)."""
    res = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for c in _CONSTS[:n_hash]:
        h = (keys ^ K.shr(keys, 33)) * K.i64(c)
        h = h ^ K.shr(h, 29)
        pos = K.shr(h, 64 - log_bits)
        res &= ((bits[K.shr(pos, 5)] >> (pos & 31).to(torch.int32)) & 1) != 0
    return res
