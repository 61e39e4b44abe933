"""K-mers as python ints for the reference automaton: first base most
significant, two bits a base, A=0 C=1 T=2 G=3 (the complement of a base is
`code ^ 2`)."""

from __future__ import annotations

NUC_CHARS = "ACTG"
_CODE = {"A": 0, "C": 1, "T": 2, "G": 3, "a": 0, "c": 1, "t": 2, "g": 3}


def kmer_to_str(kmer: int, k: int) -> str:
    km = int(kmer)
    return "".join(NUC_CHARS[(km >> (2 * (k - 1 - i))) & 3] for i in range(k))


def str_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        code = _CODE.get(ch)
        if code is None:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | code
    return v


def mutate_kmer(kmer: int, nuc: int, pos: int, k: int) -> int:
    """Set the base at 1-based position `pos` (from the start) to `nuc`."""
    p = k - pos
    reset = ~(3 << (p * 2))
    return (int(kmer) & reset & ((1 << (2 * k)) - 1)) | (nuc << (p * 2))


def revcomp_int(kmer: int, k: int) -> int:
    x, out = int(kmer), 0
    for _ in range(k):
        out = (out << 2) | ((x & 3) ^ 2)
        x >>= 2
    return out


def canonical_int(kmer: int, k: int) -> int:
    return min(kmer, revcomp_int(kmer, k))
