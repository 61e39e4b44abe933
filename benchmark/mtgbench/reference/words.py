"""K-mers of k <= 64 as two uint64 words (hi, lo): the value is
hi * 2^64 + lo, first base most significant, two bits a base (A=0 C=1 T=2
G=3; the complement of a base is `code ^ 2`). Numpy, vectorized over
positions; in torch on the run's device (the `_t` functions) at k <= 31 as
one int64, and at 32 <= k <= 62 as a pair of int64 (a, b): b the last 31
bases, a the bases before them, so that both words are >= 0 and (a, b)
sorts as the value does."""

from __future__ import annotations

import numpy as np
import torch

_COMP = np.uint64(0xAAAAAAAAAAAAAAAA)
_M = [np.uint64(m) for m in (0x3333333333333333, 0x0F0F0F0F0F0F0F0F, 0x00FF00FF00FF00FF,
                             0x0000FFFF0000FFFF, 0x00000000FFFFFFFF)]
TWO = np.uint64(2)


def _mask(bits: int) -> np.uint64:
    return np.uint64((1 << bits) - 1) if bits < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)


def masks(k: int):
    """(hi mask, lo mask) of a k-mer's 2k bits."""
    if k > 64:
        raise ValueError(f"k = {k}: the reference holds k-mers of at most 64 bases")
    return (_mask(2 * k - 64) if k > 32 else np.uint64(0)), _mask(min(2 * k, 64))


def forward(codes: np.ndarray, k: int):
    """Forward k-mer of every position of a code array (no invalid codes)."""
    p = codes.size - k + 1
    if p <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    c = codes.astype(np.uint64)
    hi = np.zeros(p, np.uint64)
    lo = np.zeros(p, np.uint64)
    for j in range(k):
        hi = (hi << TWO) | (lo >> np.uint64(62))
        lo = (lo << TWO) | c[j:j + p]
    mh, ml = masks(k)
    return hi & mh, lo & ml


def _rev64(x):
    """Reverse the order of the 32 two-bit groups of each word."""
    x = ((x >> np.uint64(2)) & _M[0]) | ((x & _M[0]) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M[1]) | ((x & _M[1]) << np.uint64(4))
    x = ((x >> np.uint64(8)) & _M[2]) | ((x & _M[2]) << np.uint64(8))
    x = ((x >> np.uint64(16)) & _M[3]) | ((x & _M[3]) << np.uint64(16))
    return (x >> np.uint64(32)) | (x << np.uint64(32))


def revcomp(hi, lo, k: int):
    if k <= 32:
        return np.zeros_like(lo), _rev64(lo ^ _COMP) >> np.uint64(64 - 2 * k)
    # the 128-bit reversal holds the reverse complement in its top 2k bits
    r_hi, r_lo = _rev64(lo ^ _COMP), _rev64(hi ^ _COMP)
    s = 128 - 2 * k
    if s == 0:
        return r_hi, r_lo
    return r_hi >> np.uint64(s), (r_lo >> np.uint64(s)) | (r_hi << np.uint64(64 - s))


def canonical(hi, lo, k: int):
    rh, rl = revcomp(hi, lo, k)
    take = (rh < hi) | ((rh == hi) & (rl < lo))
    return np.where(take, rh, hi), np.where(take, rl, lo)


def shift_out(hi, lo, k: int, code: int):
    """Out-neighbour: drop the first base, append `code`."""
    mh, ml = masks(k)
    return ((hi << TWO) | (lo >> np.uint64(62))) & mh, ((lo << TWO) | np.uint64(code)) & ml


def shift_in(hi, lo, k: int, code: int):
    """In-neighbour: drop the last base, prepend `code`."""
    nhi, nlo = hi >> TWO, (lo >> TWO) | (hi << np.uint64(62))
    top = 2 * (k - 1)
    if top >= 64:
        nhi = nhi | (np.uint64(code) << np.uint64(top - 64))
    else:
        nlo = nlo | (np.uint64(code) << np.uint64(top))
    return nhi, nlo


def low_bases(hi, lo, n: int):
    """The last n bases of each k-mer, as an n-mer."""
    mh, ml = masks(n)
    return hi & mh, lo & ml


def to_ints(hi, lo, k: int):
    """Python ints (an object array) of the values."""
    if k <= 32:
        return lo.astype(object)
    return (hi.astype(object) << 64) | lo.astype(object)


def order_of(hi, lo, k: int):
    """The permutation that sorts k-mers by value."""
    return np.argsort(lo) if k <= 32 else np.lexsort((lo, hi))


class KeySet:
    """A sorted set of canonical k-mers, with their counts."""

    def __init__(self, hi, lo, k: int, counts=None):
        self.k = k
        order = order_of(hi, lo, k)
        self.hi, self.lo = hi[order], lo[order]
        self.counts = None if counts is None else np.asarray(counts)[order]
        self._keys = self._as_keys(self.hi, self.lo)
        self._keys_t = None
        self._pair_t = None

    def __len__(self):
        return int(self.lo.size)

    def _as_keys(self, hi, lo):
        if self.k <= 32:
            return np.ascontiguousarray(lo)
        # big-endian bytes of (hi, lo): byte order equals numeric order
        be = np.ascontiguousarray(np.stack([hi, lo], axis=1).astype(">u8"))
        return be.view("V16").reshape(-1)

    def contains(self, hi, lo) -> np.ndarray:
        if len(self) == 0:
            return np.zeros(lo.shape, bool)
        # queries in order: the binary searches then walk the keys in order
        order = order_of(hi, lo, self.k)
        q = self._as_keys(hi[order], lo[order])
        idx = np.minimum(np.searchsorted(self._keys, q), len(self) - 1)
        out = np.empty(lo.shape, bool)
        out[order] = self._keys[idx] == q
        return out

    def contains_t(self, x):
        """Membership of int64 k-mers (k <= 31) in torch, on x's device."""
        if self._keys_t is None or self._keys_t.device != x.device:
            self._keys_t = torch.as_tensor(self.lo.view(np.int64), device=x.device)
        return member_t(self._keys_t, x)

    def contains_pair_t(self, a, b):
        """Membership of (a, b) k-mers (k <= 62) in torch, on a's device."""
        if self._pair_t is None or self._pair_t[0].device != a.device:
            ka = (self.hi << TWO) | (self.lo >> np.uint64(62))
            kb = self.lo & _mask(62)
            self._pair_t = tuple(torch.as_tensor(w.view(np.int64), device=a.device) for w in (ka, kb))
        return member_pair_t(*self._pair_t, a, b)

    def contains_int(self, canon: int) -> bool:
        hi = np.array([canon >> 64], np.uint64)
        lo = np.array([canon & 0xFFFFFFFFFFFFFFFF], np.uint64)
        return bool(self.contains(hi, lo)[0])


def count_kmers(codes: np.ndarray, k: int, min_occ: int) -> KeySet:
    """Canonical k-mers that occur at least `min_occ` times in `codes`."""
    hi, lo = canonical(*forward(codes, k), k)
    order = order_of(hi, lo, k)
    hi, lo = hi[order], lo[order]
    new = np.ones(lo.size, bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    idx = np.flatnonzero(new)
    counts = np.diff(idx, append=lo.size)
    keep = counts >= min_occ
    return KeySet(hi[idx][keep], lo[idx][keep], k, counts[keep])


# ---------------------------------------------------------------------------
# k <= 31 in torch on the run's device: every k-mer is a positive int64

def forward_t(codes, k: int, device):
    c = torch.as_tensor(np.ascontiguousarray(codes), device=device).long()
    p = c.numel() - k + 1
    fwd = torch.zeros(max(p, 0), dtype=torch.int64, device=device)
    for j in range(k):
        fwd = (fwd << 2) | c[j:j + p]
    return fwd


def canonical_t(x, k: int):
    rc, y = torch.zeros_like(x), x
    for _ in range(k):
        rc = (rc << 2) | ((y & 3) ^ 2)
        y = y >> 2
    return torch.minimum(x, rc)


def member_t(keys, x):
    """Membership of x in the sorted int64 tensor `keys`."""
    if keys.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    idx = torch.searchsorted(keys, x).clamp_(max=keys.numel() - 1)
    return keys[idx] == x


def count_kmers_t(codes, k: int, min_occ: int, device) -> KeySet:
    """count_kmers for k <= 31, in torch."""
    keys, counts = torch.unique(canonical_t(forward_t(codes, k, device), k), sorted=True, return_counts=True)
    keep = counts >= min_occ
    lo = keys[keep].cpu().numpy().view(np.uint64)
    return KeySet(np.zeros_like(lo), lo, k, counts[keep].cpu().numpy())


# ---------------------------------------------------------------------------
# 32 <= k <= 62 in torch: (a, b), b the last 31 bases, a the first k - 31

_M62 = (1 << 62) - 1


def _amask(k: int) -> int:
    return (1 << (2 * (k - 31))) - 1 if k > 31 else 0


def forward_pair_t(codes, k: int, device):
    c = torch.as_tensor(np.ascontiguousarray(codes), device=device).long()
    p = max(c.numel() - k + 1, 0)
    a = torch.zeros(p, dtype=torch.int64, device=device)
    b = torch.zeros_like(a)
    for j in range(k):
        a, b = ((a << 2) | (b >> 60)) & _amask(k), ((b << 2) | c[j:j + p]) & _M62
    return a, b


def shift_out_pair_t(a, b, k: int, code: int):
    """Out-neighbour: drop the first base, append `code`."""
    return ((a << 2) | (b >> 60)) & _amask(k), ((b << 2) | code) & _M62


def shift_right_pair_t(a, b):
    """Drop the last base (the first k - 1 bases, as a (k-1)-mer)."""
    return a >> 2, (b >> 2) | ((a & 3) << 60)


def shift_in_pair_t(a, b, k: int, code: int):
    """In-neighbour: drop the last base, prepend `code`."""
    a, b = shift_right_pair_t(a, b)
    top = 2 * (k - 1)
    if top >= 62:
        return a | (code << (top - 62)), b
    return a, b | (code << top)


def low_bases_pair_t(a, b, n: int):
    """The last n >= 31 bases of each k-mer, as an n-mer."""
    return a & _amask(n), b


def revcomp_pair_t(a, b, k: int):
    ra, rb = torch.zeros_like(a), torch.zeros_like(b)
    for _ in range(k):
        base = b & 3
        a, b = shift_right_pair_t(a, b)
        ra, rb = shift_out_pair_t(ra, rb, k, 0)
        rb = rb | (base ^ 2)
    return ra, rb


def min_pair_t(a, b, ra, rb):
    """The lesser of two pairs: the canonical k-mer of a k-mer and its
    reverse complement."""
    take = (ra < a) | ((ra == a) & (rb < b))
    return torch.where(take, ra, a), torch.where(take, rb, b)


def member_pair_t(ka, kb, qa, qb):
    """Membership of the pairs (qa, qb) in the unique pairs (ka, kb),
    sorted by (a, b): the run of keys with a's word, then a binary search
    of b in it."""
    n = ka.numel()
    if n == 0:
        return torch.zeros_like(qa, dtype=torch.bool)
    lo = torch.searchsorted(ka, qa, side="left")
    hi = torch.searchsorted(ka, qa, side="right")
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
        mid = (lo + hi) // 2
        right = active & (kb[mid.clamp(max=n - 1)] < qb)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    idx = lo.clamp(max=n - 1)
    return (lo < n) & (ka[idx] == qa) & (kb[idx] == qb)
