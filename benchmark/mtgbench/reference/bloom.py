"""The control's solid set: a Bloom filter over the reference's canonical
k-mers, in place of the exact set. It answers "present" for every k-mer of
the set and for a share of the others (its false positives): it breaks the
guarantee the configuration states, and it is a tempting way to save the
scan map's memory and bytes. The benchmark's own runs never use it.

The hashes are 64-bit words, wrapping: numpy uint64 (k-mers as (hi, lo)
words), torch int64 (k <= 31, the same bits) and python ints give the same
positions."""

from __future__ import annotations

import numpy as np
import torch

M64 = (1 << 64) - 1
_MULT = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _i64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _shr_t(x, s: int):
    """Logical right shift of 64-bit words held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix_t(x):
    """splitmix64's finaliser on int64 tensors."""
    x = x ^ _shr_t(x, 30)
    x = x * _i64(_MIX1)
    x = x ^ _shr_t(x, 27)
    x = x * _i64(_MIX2)
    return x ^ _shr_t(x, 31)


def _mix(x):
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(_MIX1)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(_MIX2)
    return x ^ (x >> np.uint64(31))


def _mix_int(x: int) -> int:
    x ^= x >> 30
    x = (x * _MIX1) & M64
    x ^= x >> 27
    x = (x * _MIX2) & M64
    return x ^ (x >> 31)


class BloomSet:
    """A Bloom filter of `bits_per_key` bits a k-mer and `n_hash` hashes
    over the k-mers of a KeySet; answers `contains(hi, lo)`,
    `contains_t(x)` (k <= 31) and `contains_int(canon)` as the KeySet
    does."""

    def __init__(self, keyset, bits_per_key: int = 12, n_hash: int = 8, device="cpu"):
        n = max(len(keyset), 1)
        self.log_bits = max(6, int(np.ceil(np.log2(n * bits_per_key))))
        self.n_hash = n_hash
        if keyset.k <= 31:
            bits = torch.zeros(1 << self.log_bits, dtype=torch.bool, device=device)
            for pos in self._positions_t(torch.as_tensor(keyset.lo.view(np.int64), device=device)):
                bits[pos] = True
            self.bits_t = bits
            self.bits = bits.cpu().numpy()
        else:
            self.bits = np.zeros(1 << self.log_bits, bool)
            for pos in self._positions(keyset.hi, keyset.lo):
                self.bits[pos] = True

    def _positions(self, hi, lo):
        with np.errstate(over="ignore"):
            base = _mix(lo ^ (hi * np.uint64(_MULT)))
            step = _mix(base + np.uint64(_MULT)) | np.uint64(1)
            shift = np.uint64(64 - self.log_bits)
            for i in range(self.n_hash):
                yield ((base + np.uint64(i) * step) >> shift).astype(np.int64)

    def _positions_t(self, x):
        base = _mix_t(x)  # hi = 0
        step = _mix_t(base + _i64(_MULT)) | 1
        for i in range(self.n_hash):
            yield _shr_t(base + i * step, 64 - self.log_bits)

    def contains(self, hi, lo) -> np.ndarray:
        out = np.ones(lo.shape, bool)
        for pos in self._positions(hi, lo):
            out &= self.bits[pos]
        return out

    def contains_t(self, x):
        out = torch.ones_like(x, dtype=torch.bool)
        bits = self.bits_t.to(x.device)
        for pos in self._positions_t(x):
            out &= bits[pos]
        return out

    def contains_int(self, canon: int) -> bool:
        hi, lo = canon >> 64, canon & M64
        base = _mix_int(lo ^ ((hi * _MULT) & M64))
        step = _mix_int((base + _MULT) & M64) | 1
        shift = 64 - self.log_bits
        return all(self.bits[((base + i * step) & M64) >> shift] for i in range(self.n_hash))
