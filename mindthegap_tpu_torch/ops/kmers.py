"""K-mer extraction and bit-twiddling on packed 2-bit words.

A k-mer (k <= 32) is a uint64 holding 2k bits, first base most significant —
identical bit layout to the reference's ``Kmer<span>::Type`` for span 64
(reference src/FindSNP.hpp:87-96 ``mutate_kmer``: base at 1-based position
``pos`` from the start lives at bit offset ``2*(k-pos)``; ``kmer & 3`` is the
last base). Encoding A=0 C=1 T=2 G=3, so complement is ``x ^ 0b10`` per base.

Host code works on numpy uint64. Device code works on torch int64 tensors
holding the same 64-bit patterns, because torch has no usable uint64
arithmetic: the helpers below keep the unsigned meaning (logical right
shifts, unsigned compare and min), constants above 2^63 are carried as
their int64 bit patterns, and multiplies wrap modulo 2^64 as in uint64.
``revcomp_u64`` and ``canonical_u64`` take either flavor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import dna

_COMP_MASK = np.uint64(0xAAAAAAAAAAAAAAAA)  # 0b10 repeated: per-base complement

_M1 = np.uint64(0x3333333333333333)
_M2 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M3 = np.uint64(0x00FF00FF00FF00FF)
_M4 = np.uint64(0x0000FFFF0000FFFF)
_M5 = np.uint64(0x00000000FFFFFFFF)


def kmer_mask(k: int) -> np.uint64:
    """(1 << 2k) - 1 without overflow at k=32."""
    if k == 32:
        return np.uint64(0xFFFFFFFFFFFFFFFF)
    return np.uint64((1 << (2 * k)) - 1)


# ---------------------------------------------------------------------------
# 64-bit words on int64 tensors

SIGN_BIT = -(1 << 63)


def i64(v: int) -> int:
    """The int64 bit pattern of an unsigned 64-bit constant."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >> 63 else v


def as_i64(a: np.ndarray) -> np.ndarray:
    """Zero-copy int64 view of a uint64 array (what goes up to the device)."""
    return np.ascontiguousarray(a, np.uint64).view(np.int64)


def as_u64(a) -> np.ndarray:
    """uint64 view of int64 words (a tensor is first brought to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a, np.int64).view(np.uint64)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 words held in int64 (torch's >> is arithmetic)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b: flipping the sign bit maps unsigned order onto signed order."""
    return (a ^ SIGN_BIT) < (b ^ SIGN_BIT)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(ult(b, a), b, a)


def _revcomp_words(x: torch.Tensor, k: int) -> torch.Tensor:
    x = x ^ i64(_COMP_MASK)
    x = (shr(x, 2) & int(_M1)) | ((x & int(_M1)) << 2)
    x = (shr(x, 4) & int(_M2)) | ((x & int(_M2)) << 4)
    x = (shr(x, 8) & int(_M3)) | ((x & int(_M3)) << 8)
    x = (shr(x, 16) & int(_M4)) | ((x & int(_M4)) << 16)
    x = shr(x, 32) | ((x & int(_M5)) << 32)
    return shr(x, 64 - 2 * k)


def revcomp_u64(kmer, k: int):
    """Reverse-complement of packed k-mer(s): numpy uint64 (scalars or
    arrays) or an int64 tensor of u64 bit patterns."""
    if isinstance(kmer, torch.Tensor):
        return _revcomp_words(kmer, k)
    x = kmer ^ _COMP_MASK  # complement every base (A<->T, C<->G)
    # reverse 2-bit groups within the 64-bit word
    x = ((x >> np.uint64(2)) & _M1) | ((x & _M1) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M2) | ((x & _M2) << np.uint64(4))
    x = ((x >> np.uint64(8)) & _M3) | ((x & _M3) << np.uint64(8))
    x = ((x >> np.uint64(16)) & _M4) | ((x & _M4) << np.uint64(16))
    x = ((x >> np.uint64(32)) & _M5) | ((x & _M5) << np.uint64(32))
    # the k-mer now sits in the high 2k bits; shift it back down
    return x >> np.uint64(64 - 2 * k)


def canonical_u64(fwd, k: int):
    """min(fwd, revcomp) in unsigned order (numpy uint64 or int64 tensor)."""
    rc = revcomp_u64(fwd, k)
    if isinstance(fwd, torch.Tensor):
        return umin(fwd, rc)
    return np.minimum(fwd, rc)


def kmers_from_codes(codes: np.ndarray, k: int):
    """Rolling forward k-mers over a code array (host, numpy).

    Returns (fwd[N-k+1] uint64, valid[N-k+1] bool). A k-mer is valid iff all
    its k bases are ACGT — matching the reference iterator's ``isValid()``
    (used at src/FindBreakpoints.hpp:426).
    """
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    lib = _load_native()
    if lib is not None:
        import ctypes

        codes_c = np.ascontiguousarray(codes, np.uint8)
        npos = n - k + 1
        fwd = np.empty(npos, np.uint64)
        valid = np.empty(npos, np.uint8)
        lib.extract_fwd(
            codes_c.ctypes.data_as(ctypes.c_void_p), n, k,
            fwd.ctypes.data_as(ctypes.c_void_p), valid.ctypes.data_as(ctypes.c_void_p),
        )
        return fwd, valid.astype(bool)
    bad = codes == dna.INVALID
    c = np.where(bad, 0, codes).astype(np.uint64)
    npos = n - k + 1
    # prefix "polynomial" trick: fwd[i] = sum c[i+j] << 2(k-1-j)
    # done with a simple rolling loop over k using vectorized shifts is O(k·n);
    # use cumulative packing instead: O(n) passes of log structure not needed
    # for host oracle. Vectorized O(k) loop:
    fwd = np.zeros(npos, np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | c[j : j + npos]
    # validity: no invalid base in window
    badc = np.cumsum(bad.astype(np.int64))
    badc = np.concatenate([[0], badc])
    valid = (badc[k:] - badc[:-k]) == 0
    return fwd, valid


_KM_LIB = None


def _load_native():
    """native/kmers.cpp: scalar rolling extraction (far faster than the numpy loop)."""
    global _KM_LIB
    if _KM_LIB is None:
        import ctypes

        from .._build import native_library

        lib = native_library("kmers.cpp", "libmtgkmers.so")
        lib.extract_fwd.restype = None
        lib.extract_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.extract_canonical.restype = ctypes.c_int64
        lib.extract_canonical.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        _KM_LIB = lib
    return _KM_LIB


def canonical_compact(codes: np.ndarray, k: int) -> np.ndarray:
    """All valid canonical k-mers of a code array, compacted (the counting
    stream). Native scalar pass when available, numpy fallback otherwise."""
    lib = _load_native()
    if lib is not None and k <= 32:
        import ctypes

        codes_c = np.ascontiguousarray(codes, np.uint8)
        n = codes_c.shape[0]
        if n < k:
            return np.zeros(0, np.uint64)
        out = np.empty(n - k + 1, np.uint64)
        m = lib.extract_canonical(codes_c.ctypes.data_as(ctypes.c_void_p), n, k,
                                  out.ctypes.data_as(ctypes.c_void_p))
        return out[:m]
    fwd, valid = kmers_from_codes(codes, k)
    if fwd.size == 0:
        return fwd
    return canonical_u64(fwd[valid], k)


def kmer_to_str(kmer: int, k: int) -> str:
    out = []
    km = int(kmer)
    for i in range(k):
        out.append(dna.NUC_CHARS[(km >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def str_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        code = int(dna.seq_to_codes(ch)[0])
        if code == dna.INVALID:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | code
    return v


def _mask_int(k: int) -> int:
    """(1 << 2k) - 1 as a python int (any k; the point-query helpers below
    run on python ints so k > 32 spans work unchanged)."""
    return (1 << (2 * k)) - 1


def mutate_kmer(kmer: int, nuc: int, pos: int, k: int) -> int:
    """Set base at 1-based position ``pos`` (from the start) to ``nuc``
    (reference src/FindSNP.hpp:87-96)."""
    p = k - pos
    reset = ~(3 << (p * 2))
    return (int(kmer) & reset & _mask_int(k)) | (nuc << (p * 2))


def shift_left(kmer: int, nuc: int, k: int) -> int:
    """Append base on the right (out-neighbor): drop leftmost base."""
    return ((int(kmer) << 2) | nuc) & _mask_int(k)


def shift_right(kmer: int, nuc: int, k: int) -> int:
    """Prepend base on the left (in-neighbor): drop rightmost base."""
    return (int(kmer) >> 2) | (nuc << (2 * (k - 1)))
