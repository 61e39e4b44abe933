"""Multi-word k-mer arithmetic for k > 32 (spans up to k = 256).

The reference supports KSIZE_LIST = 32/64/96/128 via compile-time template
spans (reference README.md:172-180, src/IGraphOutput.cpp:184-187). Here a
k-mer with k > 32 is a row of W = ceil(k/32) uint64 words, word 0 most
significant, the value right-aligned (value = sum words[i] << 64*(W-1-i)).

Sortable keys: big-endian byte views (numpy void dtype) compare by memcmp,
which equals numeric order — so sort/unique/searchsorted work unchanged on
multi-word keys. The host automaton and fill traversal already operate on
arbitrary-precision python ints; this module supplies the vectorized array
side (rolling extraction, revcomp, canonical, neighbor shifts) plus
int<->row conversions.
"""

from __future__ import annotations

import numpy as np

from ..utils import dna
from . import kmers as K1

_COMP = np.uint64(0xAAAAAAAAAAAAAAAA)


def _revcomp_word_full(x):
    """Reverse+complement all 32 bases of full uint64 words."""
    x = x ^ _COMP
    x = ((x >> np.uint64(2)) & K1._M1) | ((x & K1._M1) << np.uint64(2))
    x = ((x >> np.uint64(4)) & K1._M2) | ((x & K1._M2) << np.uint64(4))
    x = ((x >> np.uint64(8)) & K1._M3) | ((x & K1._M3) << np.uint64(8))
    x = ((x >> np.uint64(16)) & K1._M4) | ((x & K1._M4) << np.uint64(16))
    x = ((x >> np.uint64(32)) & K1._M5) | ((x & K1._M5) << np.uint64(32))
    return x


def revcomp_int(kmer: int, k: int) -> int:
    """Reverse complement of a python-int k-mer, any k (16-bit table steps)."""
    out = 0
    n_chunks = (k + 7) // 8
    x = kmer
    for _ in range(n_chunks):
        out = (out << 16) | int(_RC16[x & 0xFFFF])
        x >>= 16
    # out now has n_chunks*8 bases; drop the padding bases (they were A=0 ->
    # complement T at the low end of out)
    extra = n_chunks * 8 - k
    return out >> (2 * extra)


_RC16 = np.zeros(1 << 16, dtype=np.uint32)
_tmp = np.arange(1 << 16, dtype=np.uint64)
_r = _tmp ^ np.uint64(0xAAAA)
_r = ((_r >> np.uint64(2)) & np.uint64(0x3333)) | ((_r & np.uint64(0x3333)) << np.uint64(2))
_r = ((_r >> np.uint64(4)) & np.uint64(0x0F0F)) | ((_r & np.uint64(0x0F0F)) << np.uint64(4))
_r = ((_r >> np.uint64(8)) & np.uint64(0x00FF)) | ((_r & np.uint64(0x00FF)) << np.uint64(8))
_RC16 = _r.astype(np.uint32)
del _tmp, _r


def canonical_int(kmer: int, k: int) -> int:
    return min(kmer, revcomp_int(kmer, k))


class Span:
    """Vectorized multi-word k-mer arrays: shape (N, W) uint64."""

    def __init__(self, k: int):
        self.k = k
        self.W = max(1, -(-k // 32))
        top_bits = 2 * k - 64 * (self.W - 1)
        self.top_mask = np.uint64((1 << top_bits) - 1) if top_bits < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
        self.rshift = 64 * self.W - 2 * k  # left-over bits after word-reversal

    # -- construction -------------------------------------------------------
    def from_codes(self, codes: np.ndarray):
        """Rolling forward k-mers: returns (arr (P,W) u64, valid (P,) bool)."""
        k, W = self.k, self.W
        n = codes.shape[0]
        if n < k:
            return np.zeros((0, W), np.uint64), np.zeros(0, bool)
        bad = codes == dna.INVALID
        c = np.where(bad, 0, codes).astype(np.uint64)
        p = n - k + 1
        arr = np.zeros((p, W), np.uint64)
        for j in range(k):
            self._shl2_inplace(arr)
            arr[:, W - 1] |= c[j : j + p]
        arr[:, 0] &= self.top_mask
        badc = np.concatenate([[0], np.cumsum(bad.astype(np.int64))])
        valid = (badc[k:] - badc[:-k]) == 0
        return arr, valid

    def _shl2_inplace(self, arr):
        W = self.W
        for i in range(W - 1):
            arr[:, i] = (arr[:, i] << np.uint64(2)) | (arr[:, i + 1] >> np.uint64(62))
        arr[:, W - 1] = arr[:, W - 1] << np.uint64(2)

    # -- bit ops ------------------------------------------------------------
    def revcomp(self, arr):
        rev = _revcomp_word_full(arr[:, ::-1])
        # kmer now occupies the TOP 2k bits; shift right by rshift
        s = self.rshift
        if s:
            out = np.empty_like(rev)
            su, cu = np.uint64(s), np.uint64(64 - s)
            out[:, 0] = rev[:, 0] >> su
            for i in range(1, self.W):
                out[:, i] = (rev[:, i] >> su) | (rev[:, i - 1] << cu)
            rev = out
        return rev

    def canonical(self, arr):
        rc = self.revcomp(arr)
        # lexicographic word-wise compare (void dtype has no ordering ufuncs)
        take_f = np.ones(arr.shape[0], bool)
        decided = np.zeros(arr.shape[0], bool)
        for i in range(self.W):
            lt = arr[:, i] < rc[:, i]
            gt = arr[:, i] > rc[:, i]
            take_f = np.where(~decided & gt, False, take_f)
            decided |= lt | gt
        return np.where(take_f[:, None], arr, rc)

    def shift_left_insert(self, arr, code: int):
        """Append base on the right (out-neighbor), drop the leftmost base."""
        out = arr.copy()
        self._shl2_inplace(out)
        out[:, self.W - 1] |= np.uint64(code)
        out[:, 0] &= self.top_mask
        return out

    def shift_right_insert(self, arr, code: int):
        """Prepend base on the left (in-neighbor), drop the rightmost base."""
        W = self.W
        out = np.empty_like(arr)
        out[:, W - 1] = arr[:, W - 1] >> np.uint64(2)
        for i in range(W - 2, -1, -1):
            out[:, i + 1] |= arr[:, i] << np.uint64(62)
            out[:, i] = arr[:, i] >> np.uint64(2)
        top_bits = 2 * self.k - 64 * (W - 1)
        out[:, 0] |= np.uint64(code) << np.uint64(top_bits - 2)
        return out

    def low_bits(self, arr, nbases: int):
        """value & mask(nbases), re-spanned into Span(nbases) layout."""
        sp = Span(nbases)
        out = arr[:, self.W - sp.W :].copy()
        out[:, 0] &= sp.top_mask
        return out

    def shifted_right2(self, arr):
        """value >> 2 within the same span width."""
        W = self.W
        out = np.empty_like(arr)
        out[:, W - 1] = arr[:, W - 1] >> np.uint64(2)
        for i in range(W - 2, -1, -1):
            out[:, i + 1] |= arr[:, i] << np.uint64(62)
            out[:, i] = arr[:, i] >> np.uint64(2)
        return out

    # -- keys / conversions -------------------------------------------------
    def keys(self, arr):
        """Sortable void keys (memcmp order == numeric order)."""
        be = np.ascontiguousarray(arr.astype(">u8"))
        return be.view("V%d" % (8 * self.W)).reshape(-1)

    def from_keys(self, keys):
        be = np.ascontiguousarray(keys).view(">u8").reshape(-1, self.W)
        return be.astype(np.uint64)

    def to_ints(self, arr):
        out = arr[:, 0].astype(object)
        for i in range(1, self.W):
            out = (out << 64) | arr[:, i].astype(object)
        return out

    def int_to_row(self, x: int) -> np.ndarray:
        row = np.zeros(self.W, np.uint64)
        for i in range(self.W - 1, -1, -1):
            row[i] = np.uint64(x & 0xFFFFFFFFFFFFFFFF)
            x >>= 64
        return row

    def int_key(self, x: int):
        return np.frombuffer(int(x).to_bytes(8 * self.W, "big"), dtype="V%d" % (8 * self.W))[0]
