"""DNA alphabet utilities (host side, numpy).

Encoding follows the reference's 2-bit convention A=0, C=1, T=2, G=3
(reference src/FindSNP.hpp:99-117 `nuc_to_char`), so complement is
`code ^ 2` and canonical k-mers compare identically to the reference.
"""

from __future__ import annotations

import numpy as np

# A=0 C=1 T=2 G=3 ; anything else (incl. N) = 255 = invalid
CODE_A, CODE_C, CODE_T, CODE_G = 0, 1, 2, 3
INVALID = 255

_ENCODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("T", 2), ("G", 3)):
    _ENCODE_LUT[ord(_c)] = _v
    _ENCODE_LUT[ord(_c.lower())] = _v

_DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)

NUC_CHARS = "ACTG"  # index = 2-bit code


def seq_to_codes(seq) -> np.ndarray:
    """Encode an ASCII sequence (str/bytes) to uint8 codes (255 = invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def codes_to_seq(codes: np.ndarray) -> str:
    """Decode 2-bit codes back to an ACTG string (invalid -> 'N')."""
    out = np.where(codes == INVALID, np.uint8(ord("N")), _DECODE[np.minimum(codes, 3)])
    return out.tobytes().decode("ascii")


def revcomp(dna: str) -> str:
    """Reverse complement, copying-string semantics of the reference
    (src/Utils.cpp:41-77): lowercase maps to lowercase, characters outside
    acgtACGT are *dropped* (reference switch has no default case)."""
    out = []
    for c in reversed(dna):
        out.append(_RC_MAP.get(c, ""))
    return "".join(out)


def revcomp_inplace_style(dna: str) -> str:
    """Reverse complement, in-place-buffer semantics of the reference
    (src/Utils.cpp:23-38): characters outside ACGT (uppercase only!) are kept
    as-is while the string is reversed. Used by contig-graph path assembly
    (src/GraphAnalysis.cpp:374-377)."""
    m = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(m.get(c, c) for c in reversed(dna))


_RC_MAP = {
    "a": "t", "t": "a", "c": "g", "g": "c",
    "A": "T", "T": "A", "C": "G", "G": "C",
}


def ident_nt(a: str, b: str) -> int:
    """Case-tolerant char identity (reference src/Utils.cpp:81-84).

    Exact semantics: ``(a==b || a-b==32 || a-b==-32) && a != 'N'`` — note the
    reference only excludes uppercase 'N' on the *first* argument."""
    return int((a == b or abs(ord(a) - ord(b)) == 32) and a != "N")
