"""Device pass of the find scan over the pair-coalesced map (ops/extmap.py
QMapP), on int64 tensors.

Per window of W reference bases the pass computes the fused 9-bit payload
stream pay[j] of the (k-1)-mers q_j (one pair-map row lookup per TWO
positions) and ships it to the native automaton in one of two forms:

- scan_cls_qp: a reference-delta class stream (2 bits per payload) plus the
  exception payloads, compacted in payload order — the main path;
- scan_pay_qp: the dense payload bytes plus packed repeat bits — the
  re-dispatch for a window with more exceptions than the cap.

Every function here is plain PyTorch and runs on any device, except the
core of scan_cls_qp, which on a CUDA tensor runs the hand kernel K1
(csrc/scan_qp.cu) and on a CPU tensor its plain version below.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_kernel_tensor
from ..ops import extmap as X
from ..ops import kmers as K

INVALID = 255


def pack_codes_host(rows: np.ndarray):
    """2-bit-pack base codes for the host->device boundary (4x less upload
    than raw u8 codes). rows: u8[..., n] with n % 8 == 0 (255 = invalid).
    Returns (packed u8[..., n/4] — base j in bits 2*(j%4) of byte j//4 —
    and bad u8[..., n/8], np.packbits bit order)."""
    n = rows.shape[-1]
    assert n % 8 == 0
    bad = rows == INVALID
    c = np.where(bad, 0, rows).astype(np.uint8)
    q = c.reshape(rows.shape[:-1] + (n // 4, 4))
    packed = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
    badbits = np.packbits(bad, axis=-1)
    return packed, badbits


def unpack_codes(packed: torch.Tensor, badbits: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_codes_host: u8[..., 4*m] codes with 255 at bad positions."""
    cols = torch.stack([(packed >> (2 * j)) & 3 for j in range(4)], dim=-1)
    cols = cols.reshape(packed.shape[:-1] + (-1,))
    bits = torch.stack([(badbits >> (7 - i)) & 1 for i in range(8)], dim=-1)
    bits = bits.reshape(badbits.shape[:-1] + (-1,))
    return torch.where(bits != 0, INVALID, cols).to(torch.uint8)


def rolling_kmers(codes: torch.Tensor, k: int):
    """Forward k-mers (int64 words) + validity of a padded window.

    codes: uint8[W] (255 = invalid/padding). Returns (fwd int64[P], valid
    bool[P]) with P = W - k + 1."""
    p = codes.shape[0] - k + 1
    bad = codes == INVALID
    c = torch.where(bad, 0, codes).to(torch.int64)
    fwd = torch.zeros(p, dtype=torch.int64, device=codes.device)
    for j in range(k):
        fwd = (fwd << 2) | c[j : j + p]  # k = 32 wraps into the sign bit
    badc = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                      torch.cumsum(bad.to(torch.int64), 0)])
    valid = (badc[k:] - badc[:-k]) == 0
    return fwd, valid


def _pair_pay(codes, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Shared core of the qp passes: the per-position fused 9-bit payload
    stream (int64[2*n_pairs], oriented as-read) via one pair-map lookup per
    TWO positions, at the canonical (k-2)-mer the two positions share
    (ops/extmap.py QMapP). Bases that are invalid or beyond the window read
    as 0."""
    qp = X.QMapP(slots2, log_size, k, stash_k, stash_l, stash_r)
    p = codes.shape[0] - k + 1
    n_pay = p + 1
    n_pairs = (n_pay + 1) // 2

    # even/odd base columns; base 2m+1+j lives in col_{(1+j)%2}[m + (1+j)//2]
    clean = torch.where(codes == INVALID, 0, codes).to(torch.int64)
    n2 = n_pairs + (k + 1) // 2 + 1
    clean_p = torch.zeros(2 * n2, dtype=torch.int64, device=codes.device)
    clean_p[: clean.shape[0]] = clean
    col0 = clean_p[0::2]  # bases at even positions
    col1 = clean_p[1::2]  # bases at odd positions

    # r_m = (k-2)-mer at position 2m+1
    r_asread = torch.zeros(n_pairs, dtype=torch.int64, device=codes.device)
    for j in range(k - 2):
        col = col1 if (1 + j) & 1 else col0
        off = (1 + j) >> 1
        r_asread = (r_asread << 2) | col[off : off + n_pairs]
    canon_r = K.canonical_u64(r_asread, k - 2)
    strand = r_asread == canon_r
    l36, r36 = X.lookup_qp(qp, canon_r)

    y = col0[:n_pairs]
    # base 2m + (k-1): even when k is odd -> col0, else col1
    if (k - 1) % 2 == 0:
        x = col0[(k - 1) // 2 : (k - 1) // 2 + n_pairs]
    else:
        x = col1[(k - 2) // 2 : (k - 2) // 2 + n_pairs]

    def sub(blk, i4):
        return (blk >> (9 * i4)) & 0x1FF

    pay_even = torch.where(strand, sub(l36, y), X._flip9(sub(r36, y ^ 2)))
    pay_odd = torch.where(strand, sub(r36, x), X._flip9(sub(l36, x ^ 2)))
    return torch.stack([pay_even, pay_odd], dim=1).reshape(-1)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # big-endian, as np.packbits


def scan_pay_qp(codes, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Dense payload stream of one window: pay8 u8[P+1] (ext|pre nibbles,
    oriented as-read) and rep8, the repeat bits packed big-endian (the
    np.unpackbits order the native automaton reads)."""
    p = codes.shape[0] - k + 1
    n_pay = p + 1
    pay = _pair_pay(codes, slots2, stash_k, stash_l, stash_r, log_size, k)
    n8 = -(-n_pay // 8) * 8  # >= 2 * n_pairs
    padded = torch.zeros(n8, dtype=torch.int64, device=codes.device)
    padded[: pay.shape[0]] = pay
    pay8 = (padded & 0xFF).to(torch.uint8)
    rep = ((padded >> 8) & 1).reshape(-1, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=codes.device)
    rep8 = (rep * w).sum(dim=1).to(torch.uint8)
    return {"pay8": pay8[:n_pay], "rep8": rep8}


# ---------------------------------------------------------------------------
# Reference-delta class stream
#
#   cls 0 (REF):  pay == 1-hot ext at base(j+k-1) | 1-hot pre at base(j-1),
#                 rep = 0 — the unique-coverage common case; the automaton
#                 reconstructs it from the sequence
#   cls 1 (ZERO): pay == 0 (gap interior)
#   cls 3 (REP):  REF payload with the repeat bit set
#   cls 2 (EXC):  anything else — shipped explicitly, in payload order


def _cls_core_plain(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Plain version of K1: (cls2 u8[n4/4], pay16 int16[n4])."""
    codes = unpack_codes(packed, badbits)
    w = codes.shape[0]
    p = w - k + 1
    n_pay = p + 1
    n4 = -(-n_pay // 4) * 4  # >= 2 * n_pairs
    pair = _pair_pay(codes, slots2, stash_k, stash_l, stash_r, log_size, k)
    pay = torch.zeros(n4, dtype=torch.int64, device=codes.device)
    pay[: pair.shape[0]] = pair

    dev = codes.device
    b_hi = torch.cat([codes[k - 1 :], torch.full((n4 - p,), INVALID, dtype=torch.uint8, device=dev)])
    b_lo = torch.cat([torch.full((1,), INVALID, dtype=torch.uint8, device=dev), codes])[:n4]
    ok = (b_hi < 4) & (b_lo < 4)
    one = torch.ones((), dtype=torch.int64, device=dev)
    ref_pay = (one << torch.where(ok, b_hi, 0).to(torch.int64)) | (
        (one << torch.where(ok, b_lo, 0).to(torch.int64)) << 4
    )
    ref_hit = ok & ((pay & 0xFF) == ref_pay)
    rep_bit = (pay >> 8) & 1
    cls = torch.where(ref_hit, torch.where(rep_bit != 0, 3, 0), torch.where(pay == 0, 1, 2))
    q = cls.reshape(-1, 4)
    cls2 = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).to(torch.uint8)
    return cls2, pay.to(torch.int16)


_CLS_LIB = None


def _cls_lib():
    global _CLS_LIB
    if _CLS_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("scan_qp.cu", "libmtg_scan_qp.so")
        lib.scan_cls_qp_launch.restype = ctypes.c_int
        lib.scan_cls_qp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        _CLS_LIB = lib
    return _CLS_LIB


def cls_core_cuda(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """K1 (csrc/scan_qp.cu): the same (cls2, pay16) as _cls_core_plain, one
    thread per four payload entries. Counts its launches in
    `cls_core_cuda.launches`."""
    check_kernel_tensor(packed, "packed", torch.uint8, 1)
    check_kernel_tensor(badbits, "badbits", torch.uint8, 1)
    check_kernel_tensor(slots2, "slots2", torch.int64, 2)
    for name, t in (("stash_k", stash_k), ("stash_l", stash_l), ("stash_r", stash_r)):
        check_kernel_tensor(t, name, torch.int64, 1)
    w = packed.shape[0] * 4
    n_stash = stash_k.shape[0]
    if badbits.shape[0] * 8 != w or w % 8:
        raise ValueError("badbits must hold one bit per base of packed (window % 8 == 0)")
    if tuple(slots2.shape) != (1 << log_size, 2) or not 19 <= log_size <= 40:
        raise ValueError(f"slots2 must be [2**log_size, 2] with log_size in [19, 40], got {tuple(slots2.shape)}")
    if slots2.data_ptr() % 16:
        raise ValueError("slots2 rows must be 16-byte aligned (one ulonglong2 load each)")
    if not 1 <= n_stash <= 64 or stash_l.shape[0] != n_stash or stash_r.shape[0] != n_stash:
        raise ValueError("stash tables must hold 1..64 entries each")
    if not 3 <= k <= 32 or w < k + 8:
        raise ValueError(f"k must be in [3, 32] and below the window, got k={k}, window={w}")
    n_pay = w - k + 2
    n4 = -(-n_pay // 4) * 4
    cls2 = torch.empty(n4 // 4, dtype=torch.uint8, device=packed.device)
    pay16 = torch.empty(n4, dtype=torch.int16, device=packed.device)
    err = _cls_lib().scan_cls_qp_launch(
        packed.data_ptr(), badbits.data_ptr(), w,
        slots2.data_ptr(), log_size,
        stash_k.data_ptr(), stash_l.data_ptr(), stash_r.data_ptr(), n_stash,
        k, cls2.data_ptr(), pay16.data_ptr(), n4,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_cls_qp kernel launch failed: CUDA error {err}")
    cls_core_cuda.launches += 1
    return cls2, pay16


cls_core_cuda.launches = 0


def scan_cls_qp(packed, badbits, slots2, stash_k, stash_l, stash_r,
                log_size: int, k: int, exc_cap: int):
    """Reference-delta scan of one window, from 2-bit packed codes + bad mask
    (pack_codes_host): classify each payload index j against what the
    reference's own continuation implies (classes above).

    Returns cls2 (u8, 4 classes per byte), exc16 (int16[exc_cap]: the EXC
    payloads in payload order, then the other payloads in order) and n_exc
    (0-d int64). n_exc > exc_cap means the window must be re-dispatched
    through scan_pay_qp. On a CUDA tensor the core runs the kernel K1; on a
    CPU tensor its plain version."""
    core = cls_core_cuda if packed.is_cuda else _cls_core_plain
    cls2, pay16 = core(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)
    cls = torch.stack([(cls2 >> (2 * j)) & 3 for j in range(4)], dim=1).reshape(-1)
    exc = cls == 2
    n_exc = exc.sum()
    # stable partition (EXC entries first, both halves in payload order) by
    # prefix sums: no sort, and no host sync, so the next window's dispatch
    # can overlap this one's replay
    dest = torch.where(exc, torch.cumsum(exc, 0) - 1, n_exc + torch.cumsum(~exc, 0) - 1)
    order = torch.empty_like(pay16).scatter_(0, dest, pay16)
    return {"cls2": cls2, "exc16": order[:exc_cap], "n_exc": n_exc}
