"""Needleman-Wunsch global alignment.

Exact port of the reference DP + traceback (src/Utils.cpp:87-189): gap -5,
mismatch -5, match +10; identity = #diagonal-matches / max(len); traceback
prefers diagonal, then up (i-1,j), then left (i,j-1); terminal gaps handled
the reference way. Used by solution dedup (>=90% identity) and the nwalign
tool.

``nw_identity`` routes through three equivalent engines:
- native C++ rolling-row pair-DP (native/nw.cpp) — default, O(m) memory;
- the full python DP + traceback below (oracle, also returns mis/gap counts);
- a CUDA anti-diagonal wavefront kernel (nw_device.py, csrc/nw.cu) that
  `nwalign --device` runs on the GPU.

All three reproduce the traceback's tie-breaking exactly (the traceback
makes purely local decisions on score values, so a forward selection DP
carrying the match count yields the identical identity).
"""

from __future__ import annotations

import numpy as np

GAP = -5.0
MIS = -5.0
MATCH = 10.0


def _score(a: str, b: str) -> float:
    return MATCH if a == b else MIS


def needleman_wunsch(a: str, b: str):
    """Returns (identity, nb_mis, nb_gaps) with reference semantics."""
    n_a, n_b = len(a), len(b)
    score = np.zeros((n_a + 1, n_b + 1), dtype=np.float32)
    score[:, 0] = GAP * np.arange(n_a + 1)
    score[0, :] = GAP * np.arange(n_b + 1)

    if n_a and n_b:
        av = np.frombuffer(a.encode(), dtype=np.uint8)
        bv = np.frombuffer(b.encode(), dtype=np.uint8)
        sub = np.where(av[:, None] == bv[None, :], np.float32(MATCH), np.float32(MIS))
        for i in range(1, n_a + 1):
            # vectorized row update for the del/match terms; the insert term
            # needs the running maximum along j — do it with a scan
            prev = score[i - 1]
            row = score[i]
            diag = prev[:-1] + sub[i - 1]
            up = prev[1:] + GAP
            best = np.maximum(diag, up)
            acc = row[0]
            for j in range(1, n_b + 1):
                acc = max(best[j - 1], acc + GAP)
                row[j] = acc

    # traceback (same preference order as the reference)
    i, j = n_a, n_b
    identity = 0.0
    nb_mis = 0
    nb_gaps = 0
    end_gap = True
    while i > 0 and j > 0:
        cur = score[i][j]
        if cur == score[i - 1][j - 1] + _score(a[i - 1], b[j - 1]):
            if a[i - 1] == b[j - 1]:
                identity += 1
            else:
                nb_mis += 1
            i -= 1
            j -= 1
            end_gap = False
        else:
            if cur == score[i - 1][j] + GAP:
                i -= 1
            elif cur == score[i][j - 1] + GAP:
                j -= 1
            if not end_gap:
                nb_gaps += 1
    nb_gaps += i + j
    identity /= max(n_a, n_b)
    return identity, nb_mis, nb_gaps


_NW_LIB = None


def _load_native():
    global _NW_LIB
    if _NW_LIB is None:
        import ctypes

        from .._build import native_library

        lib = native_library("nw.cpp", "libmtgnw.so")
        lib.nw_identity.restype = ctypes.c_double
        lib.nw_identity.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        _NW_LIB = lib
    return _NW_LIB


def nw_identity(a: str, b: str) -> float:
    lib = _load_native()
    if lib is not None:
        ab, bb = a.encode(), b.encode()
        return float(lib.nw_identity(ab, len(ab), bb, len(bb)))
    return needleman_wunsch(a, b)[0]
