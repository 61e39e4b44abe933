"""Device pass of the find scan, on int64 tensors, and the host side of
its plane path.

Per window of W reference bases the pass looks up, for each (k-1)-mer q_j,
its fused 9-bit payload (ext | pre << 4 | repeat << 8, ops/extmap.py) and
sends it to an automaton in one of these forms:

- scan_cls_qp (k <= 32, the pair map QMapP): a reference-delta class
  stream (2 bits per payload) plus the exception payloads, compacted in
  payload order — the main path, into the native automaton; the hand
  kernel K1 (csrc/scan_qp.cu) on CUDA;
- scan_pay_qp (pair map): the dense payload bytes plus packed repeat bits
  — the re-dispatch of a window with more exceptions than the cap, and
  the plane feed of `-automaton host`; the hand kernel K10 (beside K1);
- scan_planes_q / scan_planes_qb (`-scan-engine device` / `device-qb`,
  k <= 32, the cuckoo map QMap / the bucket map QMapB): the seven planes
  of find/scan.py Planes themselves; the hand kernels K8 and K9
  (csrc/scan_planes.cu);
- scan_planes_qp (k <= 32, the pair map) and scan_planes_q_span (32 < k
  <= 256, the span map): the same planes, the pass that the branching
  filter script (scripts/context_genome_wg.py) runs over a reference; the
  hand kernels K15 (csrc/scan_planes.cu) and K16
  (csrc/scan_planes_span.cu);
- scan_pay_q_span (32 < k <= 256, the span map QMapSpan): payload bytes
  with repeat and strand bits; the hand kernel K6 (csrc/scan_span.cu);
- scan_planes_sorted (k <= 32, the solid and repeat sets as sorted words,
  no map): the seven planes by membership lookups — the graft entry point
  and parallel/mesh.py sharded_scan; the hand kernel K14
  (csrc/scan_sorted.cu, over each set's bucket index, ops/sorted_index.py),
  with compute_planes_device, its windowed host wrapper.

Each dispatcher runs its kernel on a CUDA tensor and its plain version
(`_..._plain`, plain PyTorch) on a CPU tensor. planes_from_pay and
planes_from_pay_span turn a payload stream into Planes on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_kernel_tensor, launch
from ..ops import extmap as X
from ..ops import kmers as K
from ..ops import sorted_index as SI

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


def pair_keys(codes, k: int):
    """The keys of a window's pair lookups: the even and odd base columns
    (bases that are invalid or beyond the window read as 0) and, for each
    pair m, the (k-2)-mer at base 2m+1 as read and canonical."""
    p = codes.shape[0] - k + 1
    n_pairs = (p + 2) // 2

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
    return col0, col1, r_asread, K.canonical_u64(r_asread, k - 2)


def _pair_pay(codes, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Shared core of the qp passes: the per-position fused 9-bit payload
    stream (int64[2*n_pairs], oriented as-read) via one pair-map lookup per
    TWO positions, at the canonical (k-2)-mer the two positions share
    (ops/extmap.py QMapP)."""
    qp = X.QMapP(slots2, log_size, k, stash_k, stash_l, stash_r)
    col0, col1, r_asread, canon_r = pair_keys(codes, k)
    n_pairs = r_asread.shape[0]
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


def _scan_pay_qp_plain(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Plain version of K10: the pair payloads of the window, then pack."""
    codes = unpack_codes(packed, badbits)
    n_pay = codes.shape[0] - k + 2
    pay = _pair_pay(codes, slots2, stash_k, stash_l, stash_r, log_size, k)
    n8 = -(-n_pay // 8) * 8  # >= 2 * n_pairs
    padded = torch.zeros(n8, dtype=torch.int64, device=codes.device)
    padded[: pay.shape[0]] = pay
    pay8 = (padded & 0xFF).to(torch.uint8)
    rep = ((padded >> 8) & 1).reshape(-1, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=codes.device)
    rep8 = (rep * w).sum(dim=1).to(torch.uint8)
    return {"pay8": pay8[:n_pay], "rep8": rep8}


def scan_pay_qp_cuda(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """K10 (csrc/scan_qp.cu, beside K1): the same {pay8, rep8} as
    _scan_pay_qp_plain, K1's pairs and probes with each payload written
    out. Counts one launch per window in `scan_pay_qp_cuda.launches`."""
    w = _check_qp_args(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)
    dev = packed.device
    n_pay = w - k + 2
    pay8 = torch.empty(n_pay, dtype=torch.uint8, device=dev)
    rep8 = torch.empty(-(-n_pay // 8), dtype=torch.uint8, device=dev)
    launch("scan_pay_qp", _cls_lib().scan_pay_qp_launch,
           packed.data_ptr(), badbits.data_ptr(), w, slots2.data_ptr(), log_size,
           stash_k.data_ptr(), stash_l.data_ptr(), stash_r.data_ptr(), stash_k.shape[0], k,
           pay8.data_ptr(), rep8.data_ptr(),
           device=dev)
    scan_pay_qp_cuda.launches += 1
    return {"pay8": pay8, "rep8": rep8}


scan_pay_qp_cuda.launches = 0


def scan_pay_qp(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Dense payload stream of one window, from 2-bit packed codes and bad
    bits (pack_codes_host): pay8 u8[P+1] (ext|pre nibbles, oriented as-read)
    and rep8, the repeat bits packed big-endian (the np.unpackbits order the
    native automaton reads). On a CUDA tensor this runs the kernel K10; on
    a CPU tensor its plain version."""
    fn = scan_pay_qp_cuda if packed.is_cuda else _scan_pay_qp_plain
    return fn(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)


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
    """Classes and payloads of one window: (cls2 u8[n4/4], pay16 int16[n4])."""
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


def _scan_cls_qp_plain(packed, badbits, slots2, stash_k, stash_l, stash_r,
                       log_size: int, k: int, exc_cap: int):
    """Plain version of K1: the classes, then the EXC-first stable
    compaction by prefix sums (no sort, and no host sync, so that the next
    window's dispatch can overlap this one's replay)."""
    cls2, pay16 = _cls_core_plain(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)
    cls = torch.stack([(cls2 >> (2 * j)) & 3 for j in range(4)], dim=1).reshape(-1)
    exc = cls == 2
    n_exc = exc.sum()
    dest = torch.where(exc, torch.cumsum(exc, 0) - 1, n_exc + torch.cumsum(~exc, 0) - 1)
    order = torch.empty_like(pay16).scatter_(0, dest, pay16)
    return {"cls2": cls2, "exc16": order[:exc_cap], "n_exc": n_exc}


_CLS_LIB = None


def _cls_lib():
    global _CLS_LIB
    if _CLS_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("scan_qp.cu", "libmtg_scan_qp.so")
        lib.scan_cls_qp_tile_pairs.restype = ctypes.c_int
        lib.scan_cls_qp_tile_pairs.argtypes = []
        lib.scan_cls_qp_launch.restype = ctypes.c_int
        lib.scan_cls_qp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.scan_pay_qp_launch.restype = ctypes.c_int
        lib.scan_pay_qp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _CLS_LIB = lib
    return _CLS_LIB


def _check_qp_args(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int) -> int:
    """Validate the window and pair-map tensors of K1 and K10; returns the
    window's length in bases."""
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
    if not 3 <= k <= 32 or w < k + 8 or w >= 1 << 31:
        raise ValueError(f"k must be in [3, 32] and the window in [k + 8, 2^31), got k={k}, window={w}")
    return w


def scan_cls_qp_cuda(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int,
                     exc_cap: int):
    """K1 (csrc/scan_qp.cu): the same {cls2, exc16, n_exc} as
    _scan_cls_qp_plain, in one pass: tiles of 256 x 2 pairs classified from
    shared memory (the second cuckoo probe only after the first misses),
    the EXC count carried across tiles by a decoupled look-back, then a
    small kernel that places the non-EXC tail of exc16 behind the n_exc EXC
    payloads. Counts one launch per window in `scan_cls_qp_cuda.launches`."""
    w = _check_qp_args(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)
    if exc_cap < 0:
        raise ValueError(f"exc_cap must be >= 0, got {exc_cap}")
    dev = packed.device
    lib = _cls_lib()
    n_stash = stash_k.shape[0]
    n4 = -(-(w - k + 2) // 4) * 4
    out_len = min(exc_cap, n4)
    n_tiles = -(-n4 // (2 * lib.scan_cls_qp_tile_pairs()))
    cls2 = torch.empty(n4 // 4, dtype=torch.uint8, device=dev)
    exc16 = torch.empty(out_len, dtype=torch.int16, device=dev)
    n_exc = torch.empty((), dtype=torch.int64, device=dev)
    # the non-EXC payloads by rank, then the tiles' look-back states and the
    # tile counter (zeroed by the launch)
    tail = torch.empty(out_len, dtype=torch.int16, device=dev)
    states = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
    launch("scan_cls_qp", lib.scan_cls_qp_launch,
           packed.data_ptr(), badbits.data_ptr(), w,
           slots2.data_ptr(), log_size,
           stash_k.data_ptr(), stash_l.data_ptr(), stash_r.data_ptr(), n_stash, k,
           cls2.data_ptr(), exc16.data_ptr(), n_exc.data_ptr(), out_len, tail.data_ptr(), states.data_ptr(),
           device=dev)
    scan_cls_qp_cuda.launches += 1
    return {"cls2": cls2, "exc16": exc16, "n_exc": n_exc}


scan_cls_qp_cuda.launches = 0


def scan_cls_qp(packed, badbits, slots2, stash_k, stash_l, stash_r,
                log_size: int, k: int, exc_cap: int):
    """Reference-delta scan of one window, from 2-bit packed codes + bad mask
    (pack_codes_host): classify each payload index j against what the
    reference's own continuation implies (classes above).

    Returns cls2 (u8, 4 classes per byte), exc16 (int16[min(exc_cap, n4)]:
    the EXC payloads in payload order, then the other payloads in order) and
    n_exc (0-d int64). n_exc > exc_cap means the window must be
    re-dispatched through scan_pay_qp. On a CUDA tensor this runs the
    kernel K1; on a CPU tensor its plain version."""
    fn = scan_cls_qp_cuda if packed.is_cuda else _scan_cls_qp_plain
    return fn(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k, exc_cap)


# ---------------------------------------------------------------------------
# The span scan (32 < k <= 256) over the multi-word map (ops/extmap.py
# QMapSpan): one lookup per (k-1)-mer, no pair coalescing. Its payload is
# the canonical (k-1)-mer's, not oriented to the strand, so the strand bits
# travel with it and the native automaton orients each payload itself.


def _scan_pay_q_span_plain(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v,
                           salt: int, log_size: int, k: int):
    """Plain version of K6: roll, canonicalize and look up every (k-1)-mer
    of the window (an invalid base reads as base 0), then pack."""
    from ..ops import span_device as SD

    codes = unpack_codes(packed, badbits)
    qm = X.QMapSpan(slots, sat, log_size, salt, stash_k64, stash_sat, stash_v)
    qwords, _valid = SD.rolling_span(codes, k - 1)
    canon, is_canon = SD.canonical_span(qwords, k - 1)
    pay = X.lookup_q_span(qm, canon)
    n_pay = pay.shape[0]
    n8 = -(-n_pay // 8) * 8
    padded = torch.zeros(n8, dtype=torch.int64, device=codes.device)
    padded[:n_pay] = pay
    strand = torch.zeros(n8, dtype=torch.int64, device=codes.device)
    strand[:n_pay] = is_canon.to(torch.int64)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=codes.device)
    rep8 = (((padded >> 8) & 1).reshape(-1, 8) * w).sum(dim=1).to(torch.uint8)
    str8 = (strand.reshape(-1, 8) * w).sum(dim=1).to(torch.uint8)
    return {"pay8": (pay & 0xFF).to(torch.uint8), "rep8": rep8, "str8": str8}


_SPAN_LIB = None


def _span_scan_lib():
    global _SPAN_LIB
    if _SPAN_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("scan_span.cu", "libmtg_scan_span.so")
        lib.scan_pay_q_span_launch.restype = ctypes.c_int
        lib.scan_pay_q_span_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _SPAN_LIB = lib
    return _SPAN_LIB


def _check_span_args(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v, log_size: int, k: int) -> int:
    """Validate the window and span-map tensors of K6 and K16; returns the
    window's length in bases."""
    check_kernel_tensor(packed, "packed", torch.uint8, 1)
    check_kernel_tensor(badbits, "badbits", torch.uint8, 1)
    X.check_span_tables(slots, sat, stash_k64, stash_sat, stash_v, log_size, k)
    w = packed.shape[0] * 4
    if badbits.shape[0] * 8 != w or w % 8:
        raise ValueError("badbits must hold one bit per base of packed (window % 8 == 0)")
    if w < k + 8 or w >= 1 << 31:
        raise ValueError(f"the window must hold [k + 8, 2^31) bases, got {w} at k={k}")
    return w


def scan_pay_q_span_cuda(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v,
                         salt: int, log_size: int, k: int):
    """K6 (csrc/scan_span.cu): the same {pay8, rep8, str8} as
    _scan_pay_q_span_plain, a thread for each 4 consecutive (k-1)-mers (2
    past 128 bases) with all of their probes in flight, from bases staged
    in shared memory. Counts one launch per window in
    `scan_pay_q_span_cuda.launches`."""
    w = _check_span_args(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v, log_size, k)
    dev = packed.device
    n_pay = w - k + 2
    n8 = -(-n_pay // 8)
    pay8 = torch.empty(n_pay, dtype=torch.uint8, device=dev)
    rep8 = torch.empty(n8, dtype=torch.uint8, device=dev)
    str8 = torch.empty(n8, dtype=torch.uint8, device=dev)
    launch("scan_pay_q_span", _span_scan_lib().scan_pay_q_span_launch,
           packed.data_ptr(), badbits.data_ptr(), w,
           slots.data_ptr(), sat.data_ptr() if sat.numel() else None, log_size, K.i64(salt),
           stash_k64.data_ptr(), stash_sat.data_ptr() if stash_sat.numel() else None, stash_v.data_ptr(),
           stash_k64.shape[0], k,
           pay8.data_ptr(), rep8.data_ptr(), str8.data_ptr(),
           device=dev)
    scan_pay_q_span_cuda.launches += 1
    return {"pay8": pay8, "rep8": rep8, "str8": str8}


scan_pay_q_span_cuda.launches = 0


def scan_pay_q_span(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v,
                    salt: int, log_size: int, k: int):
    """Span payload scan of one window (32 < k <= 256), from 2-bit packed
    codes and bad bits (pack_codes_host), over the int64 tables of
    QMapSpan.to. For each of the n_pay = W - k + 2 (k-1)-mers (an invalid
    base read as base 0): its canonical form's 9-bit payload, of which
    pay8 u8[n_pay] holds the low byte, rep8 the repeat bit and str8 whether
    the (k-1)-mer as read is canonical, both packed big-endian as
    np.packbits (u8[ceil(n_pay / 8)], padding bits 0). On a CUDA tensor
    this runs the kernel K6; on a CPU tensor its plain version."""
    fn = scan_pay_q_span_cuda if packed.is_cuda else _scan_pay_q_span_plain
    return fn(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v, salt, log_size, k)


# ---------------------------------------------------------------------------
# The plane path: the seven planes of find/scan.py Planes for every position
# of a window, computed on the device (K8, K9; the plain qp and span
# passes) or rebuilt on the host from a payload stream (planes_from_pay,
# planes_from_pay_span). Position i's planes come from the payloads of its
# (k-1)-mers q_i and q_{i+1} (ops/extmap.py planes_from_payload).

PLANE_KEYS = ("fwd", "valid", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep")


def _planes_of_payloads(codes, p: int, valid, pay, strand, k: int) -> dict:
    """Every plane but the forward k-mers, from the 9-bit payloads of the
    window's first P + 1 (k-1)-mers (int64, as their canonical forms hold
    them) and whether each is read on its canonical strand."""
    tail = codes[k - 1:]
    last_base = torch.where(tail == INVALID, 0, tail).to(torch.int64)
    low = pay & 0xFF
    contains, nb_in, nb_out = X.planes_from_payload(low[:p], low[1 : p + 1], strand[:p], strand[1 : p + 1],
                                                    last_base)
    rep = ((pay >> 8) & 1) != 0
    return {"valid": valid, "contains": contains,
            "nb_in": torch.where(contains, nb_in, 0), "nb_out": torch.where(contains, nb_out, 0),
            "suffix_rep": rep[1 : p + 1], "prefix_rep": rep[:p]}


def _scan_planes_plain(packed, badbits, k: int, lookup) -> dict:
    codes = unpack_codes(packed, badbits)
    q, _ = rolling_kmers(codes, k - 1)
    fwd, valid = rolling_kmers(codes, k)
    canon = K.canonical_u64(q, k - 1)
    return {"fwd": fwd, **_planes_of_payloads(codes, fwd.shape[0], valid, lookup(canon), q == canon, k)}


def _scan_planes_q_plain(packed, badbits, slots, stash_k, stash_v, log_size: int, k: int) -> dict:
    """Plain version of K8: roll the window's k-mers and (k-1)-mers (an
    invalid base reads as base 0), look every canonical (k-1)-mer up in the
    cuckoo map, derive the planes."""
    qm = X.QMap(slots, log_size, stash_k, stash_v)
    return _scan_planes_plain(packed, badbits, k, lambda keys: X.lookup_q(qm, keys))


def _scan_planes_qb_plain(packed, badbits, slots, stash_k, stash_v, log_nb: int, k: int) -> dict:
    """Plain version of K9: as K8's, over the bucket map."""
    qm = X.QMapB(slots, log_nb, stash_k, stash_v)
    return _scan_planes_plain(packed, badbits, k, lambda keys: X.lookup_qb(qm, keys))


_PLANES_LIB = None


def _planes_lib():
    global _PLANES_LIB
    if _PLANES_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("scan_planes.cu", "libmtg_scan_planes.so")
        lib.scan_planes_launch.restype = ctypes.c_int
        lib.scan_planes_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_void_p] * 7,
            ctypes.c_void_p,
        ]
        lib.scan_planes_qp_tile_pairs.restype = ctypes.c_int
        lib.scan_planes_qp_tile_pairs.argtypes = []
        lib.scan_planes_qp_launch.restype = ctypes.c_int
        lib.scan_planes_qp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_void_p] * 7,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _PLANES_LIB = lib
    return _PLANES_LIB


def _scan_planes_cuda(packed, badbits, slots, stash_k, stash_v, log: int, k: int, bucket: bool) -> dict:
    p = max(packed.shape[0] * 4 - k + 1, 0)
    out = {key: torch.empty(p, dtype=_plane_dtype(key), device=packed.device) for key in PLANE_KEYS}
    _scan_planes_into(packed, badbits, slots, stash_k, stash_v, log, k, bucket, out)
    return out


def _plane_dtype(key: str) -> torch.dtype:
    return torch.int64 if key == "fwd" else torch.int32 if key.startswith("nb_") else torch.bool


def _scan_planes_into(packed, badbits, slots, stash_k, stash_v, log: int, k: int, bucket: bool, out: dict):
    """K8 or K9 into the planes `out` ({PLANE_KEYS: P entries}, views at
    any offset: those not 16-byte aligned are written element by element)."""
    check_kernel_tensor(packed, "packed", torch.uint8, 1)
    check_kernel_tensor(badbits, "badbits", torch.uint8, 1)
    check_kernel_tensor(slots, "slots", torch.int64, 1)
    check_kernel_tensor(stash_k, "stash_k", torch.int64, 1)
    check_kernel_tensor(stash_v, "stash_v", torch.int64, 1)
    w = packed.shape[0] * 4
    n_stash = stash_k.shape[0]
    if badbits.shape[0] * 8 != w or w % 8:
        raise ValueError("badbits must hold one bit per base of packed (window % 8 == 0)")
    lo, width = (10, X._QB_SLOTS) if bucket else (11, 1)
    if slots.shape[0] != width << log or not lo <= log <= 40:
        raise ValueError(f"slots must hold {width} * 2**log words with log in [{lo}, 40], "
                         f"got {slots.shape[0]} at log {log}")
    if slots.data_ptr() % 16:
        raise ValueError("slots must be 16-byte aligned (the bucket line's 16-byte loads)")
    if not 1 <= n_stash <= 64 or stash_v.shape[0] != n_stash:
        raise ValueError("the stash must hold 1..64 keys and as many payloads")
    if not 2 <= k <= 32 or w < k or w >= 1 << 31:
        raise ValueError(f"k must be in [2, 32] and the window in [k, 2^31), got k={k}, window={w}")
    p = w - k + 1
    for key in PLANE_KEYS:
        t = out[key]
        if t.shape != (p,) or t.dtype != _plane_dtype(key) or t.device != packed.device or t.stride() != (1,):
            raise ValueError(f"plane {key} must hold {p} contiguous {_plane_dtype(key)} on {packed.device}")
    launch("scan_planes", _planes_lib().scan_planes_launch,
           packed.data_ptr(), badbits.data_ptr(), w, slots.data_ptr(), log, int(bucket),
           stash_k.data_ptr(), stash_v.data_ptr(), n_stash, k,
           *(out[key].data_ptr() for key in PLANE_KEYS),
           device=packed.device)


def scan_planes_q_cuda(packed, badbits, slots, stash_k, stash_v, log_size: int, k: int) -> dict:
    """K8 (csrc/scan_planes.cu over the cuckoo map): the same planes as
    _scan_planes_q_plain, in one launch of persistent blocks over tiles of
    1,024 positions: a tile's first-choice probes in flight with the tile
    before's second-choice probes (the keys that missed, queued in shared
    memory) and plane stores. Counts one launch per window in
    `scan_planes_q_cuda.launches`."""
    out = _scan_planes_cuda(packed, badbits, slots, stash_k, stash_v, log_size, k, bucket=False)
    scan_planes_q_cuda.launches += 1
    return out


scan_planes_q_cuda.launches = 0


def scan_planes_qb_cuda(packed, badbits, slots, stash_k, stash_v, log_nb: int, k: int) -> dict:
    """K9 (csrc/scan_planes.cu over the bucket map): the same planes as
    _scan_planes_qb_plain, each thread probing 2 consecutive (k-1)-mers,
    one 128-byte bucket line each. Counts one launch per window in
    `scan_planes_qb_cuda.launches`."""
    out = _scan_planes_cuda(packed, badbits, slots, stash_k, stash_v, log_nb, k, bucket=True)
    scan_planes_qb_cuda.launches += 1
    return out


scan_planes_qb_cuda.launches = 0


def scan_planes_q(packed, badbits, slots, stash_k, stash_v, log_size: int, k: int) -> dict:
    """Planes of one window over the cuckoo map (k <= 32; tables from
    QMap.to), from 2-bit packed codes and bad bits (pack_codes_host): for
    each of the P = W - k + 1 positions fwd (int64 bit patterns of the
    forward k-mer, an invalid base read as base 0), valid, contains, nb_in
    and nb_out (int32), suffix_rep and prefix_rep. On a CUDA tensor this
    runs the kernel K8; on a CPU tensor its plain version."""
    fn = scan_planes_q_cuda if packed.is_cuda else _scan_planes_q_plain
    return fn(packed, badbits, slots, stash_k, stash_v, log_size, k)


def scan_planes_qb(packed, badbits, slots, stash_k, stash_v, log_nb: int, k: int) -> dict:
    """scan_planes_q over the bucket map (tables from QMapB.to). On a CUDA
    tensor this runs the kernel K9; on a CPU tensor its plain version."""
    fn = scan_planes_qb_cuda if packed.is_cuda else _scan_planes_qb_plain
    return fn(packed, badbits, slots, stash_k, stash_v, log_nb, k)


def _scan_planes_qp_plain(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int) -> dict:
    """Plain version of K15: the pair payloads of the window (one lookup per
    two positions, the payloads oriented as read), then the planes."""
    codes = unpack_codes(packed, badbits)
    fwd, valid = rolling_kmers(codes, k)
    p = fwd.shape[0]
    pay = _pair_pay(codes, slots2, stash_k, stash_l, stash_r, log_size, k)[: p + 1]
    as_read = torch.ones(p + 1, dtype=torch.bool, device=codes.device)
    return {"fwd": fwd, **_planes_of_payloads(codes, p, valid, pay, as_read, k)}


def scan_planes_qp_cuda(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int) -> dict:
    """K15 (csrc/scan_planes.cu, K10's probe with K8's plane stores): the
    same planes as _scan_planes_qp_plain, a block a tile of 512 pairs, a
    thread's four positions from its two pairs' payloads and the next
    thread's first (the tile's last position written by the next tile,
    from the payload this tile publishes). Counts one launch per window in
    `scan_planes_qp_cuda.launches`."""
    w = _check_qp_args(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)
    dev = packed.device
    lib = _planes_lib()
    p = w - k + 1
    out = {key: torch.empty(p, dtype=_plane_dtype(key), device=dev) for key in PLANE_KEYS}
    n_tiles = -(-((p + 2) // 2) // lib.scan_planes_qp_tile_pairs())
    states = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)  # zeroed by the launch
    launch("scan_planes_qp", lib.scan_planes_qp_launch,
           packed.data_ptr(), badbits.data_ptr(), w, slots2.data_ptr(), log_size,
           stash_k.data_ptr(), stash_l.data_ptr(), stash_r.data_ptr(), stash_k.shape[0], k,
           *(out[key].data_ptr() for key in PLANE_KEYS), states.data_ptr(),
           device=dev)
    scan_planes_qp_cuda.launches += 1
    return out


scan_planes_qp_cuda.launches = 0


def scan_planes_qp(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size: int, k: int) -> dict:
    """Planes of one window over the pair map (3 <= k <= 32; tables from
    QMapP.to), from 2-bit packed codes and bad bits (pack_codes_host): the
    seven planes of scan_planes_q, from one pair-map lookup per two
    positions (the JAX package's scan_planes_device_qp). On a CUDA tensor
    this runs the kernel K15; on a CPU tensor its plain version."""
    fn = scan_planes_qp_cuda if packed.is_cuda else _scan_planes_qp_plain
    return fn(packed, badbits, slots2, stash_k, stash_l, stash_r, log_size, k)


def _scan_planes_q_span_plain(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v,
                              salt: int, log_size: int, k: int) -> dict:
    """Plain version of K16: roll the window's (k-1)-mers and k-mers (an
    invalid base reads as base 0), look every canonical (k-1)-mer up in the
    span map, derive the planes with each payload turned to its strand."""
    from ..ops import span_device as SD

    codes = unpack_codes(packed, badbits)
    qm = X.QMapSpan(slots, sat, log_size, salt, stash_k64, stash_sat, stash_v)
    qwords, _ = SD.rolling_span(codes, k - 1)
    fwd_words, valid = SD.rolling_span(codes, k)
    p = fwd_words.shape[1]
    canon, is_canon = SD.canonical_span(qwords, k - 1)
    pay = X.lookup_q_span(qm, canon)
    return {"fwd_words": fwd_words, **_planes_of_payloads(codes, p, valid, pay, is_canon, k)}


_PLANES_SPAN_LIB = None


def _planes_span_lib():
    global _PLANES_SPAN_LIB
    if _PLANES_SPAN_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("scan_planes_span.cu", "libmtg_scan_planes_span.so")
        lib.scan_planes_span_tile_keys.restype = ctypes.c_int
        lib.scan_planes_span_tile_keys.argtypes = [ctypes.c_int]
        lib.scan_planes_span_launch.restype = ctypes.c_int
        lib.scan_planes_span_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_void_p] * 7,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _PLANES_SPAN_LIB = lib
    return _PLANES_SPAN_LIB


def scan_planes_q_span_cuda(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v,
                            salt: int, log_size: int, k: int) -> dict:
    """K16 (csrc/scan_planes_span.cu, K6's probe with the plane stores):
    the same planes as _scan_planes_q_span_plain, a thread's 4 (2 past k =
    129) positions from its (k-1)-mers' payloads and the next thread's
    first. Counts one launch per window in
    `scan_planes_q_span_cuda.launches`."""
    from ..ops.span_device import span_width

    w = _check_span_args(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v, log_size, k)
    dev = packed.device
    lib = _planes_span_lib()
    p = w - k + 1
    out = {"fwd_words": torch.empty((span_width(k), p), dtype=torch.int64, device=dev)}
    out.update({key: torch.empty(p, dtype=_plane_dtype(key), device=dev) for key in PLANE_KEYS[1:]})
    n_tiles = -(-(p + 1) // lib.scan_planes_span_tile_keys(k))
    states = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)  # zeroed by the launch
    launch("scan_planes_q_span", lib.scan_planes_span_launch,
           packed.data_ptr(), badbits.data_ptr(), w,
           slots.data_ptr(), sat.data_ptr() if sat.numel() else None, log_size, K.i64(salt),
           stash_k64.data_ptr(), stash_sat.data_ptr() if stash_sat.numel() else None, stash_v.data_ptr(),
           stash_k64.shape[0], k,
           *(out[key].data_ptr() for key in ("fwd_words",) + PLANE_KEYS[1:]), states.data_ptr(),
           device=dev)
    scan_planes_q_span_cuda.launches += 1
    return out


scan_planes_q_span_cuda.launches = 0


def scan_planes_q_span(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v,
                       salt: int, log_size: int, k: int) -> dict:
    """Planes of one window over the span map (32 < k <= 256; tables from
    QMapSpan.to), from 2-bit packed codes and bad bits (pack_codes_host),
    with `fwd_words` ((Wk, P) int64 words of the forward k-mers, word 0
    most significant) in place of fwd (the JAX package's
    scan_planes_device_q_span). On a CUDA tensor this runs the kernel K16;
    on a CPU tensor its plain version."""
    fn = scan_planes_q_span_cuda if packed.is_cuda else _scan_planes_q_span_plain
    return fn(packed, badbits, slots, sat, stash_k64, stash_sat, stash_v, salt, log_size, k)


def planes_from_pay(pay8: np.ndarray, rep8: np.ndarray, codes: np.ndarray, k: int):
    """Host side of the pair map's plane path: the Planes of a window
    (codes u8, 255 = invalid) from its dense payload stream (scan_pay_qp's
    pay8 and rep8, payloads oriented as read), with the forward k-mers and
    validity extracted natively. Equal to scan_planes_qp's planes."""
    from .scan import Planes

    fwd, valid = K.kmers_from_codes(codes, k)
    p = fwd.shape[0]
    pay8 = np.asarray(pay8, np.uint8)
    rep = np.unpackbits(np.asarray(rep8, np.uint8))
    ext_i = pay8[:p] & np.uint8(0xF)
    pre_i = (pay8[:p] >> np.uint8(4)) & np.uint8(0xF)
    ext_i1 = pay8[1 : p + 1] & np.uint8(0xF)
    last_base = np.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(np.uint8)
    contains = ((ext_i >> last_base) & 1).astype(bool)
    nb_out = np.where(contains, X._popcount4(ext_i1), 0).astype(np.int32)
    nb_in = np.where(contains, X._popcount4(pre_i), 0).astype(np.int32)
    return Planes(
        valid=valid,
        fwd=fwd,
        contains=contains,
        nb_in=nb_in,
        nb_out=nb_out,
        suffix_rep=rep[1 : p + 1].astype(bool),
        prefix_rep=rep[:p].astype(bool),
    )


def planes_from_pay_span(pay8, rep8, str8, codes: np.ndarray, k: int):
    """Host side of the span plane path (32 < k <= 256): the Planes of a
    window from scan_pay_q_span's payload bytes and packed repeat and
    strand bits, with the forward k-mer rows extracted on the host. Equal
    to scan_planes_q_span's planes."""
    from ..ops.span import Span
    from .scan import Planes

    sp = Span(k)
    fwd_rows, valid = sp.from_codes(codes)
    p = fwd_rows.shape[0]
    pay8 = np.asarray(pay8, np.uint8)
    rep = np.unpackbits(np.asarray(rep8, np.uint8)).astype(bool)
    is_canon = np.unpackbits(np.asarray(str8, np.uint8)).astype(bool)
    last_base = np.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(np.uint8)
    contains, nb_in, nb_out = X.planes_from_payload(
        pay8[:p], pay8[1 : p + 1], is_canon[:p], is_canon[1 : p + 1], last_base
    )
    nb_out = np.where(contains, nb_out, 0).astype(np.int32)
    nb_in = np.where(contains, nb_in, 0).astype(np.int32)
    return Planes(
        valid=valid,
        fwd=sp.to_ints(fwd_rows),
        contains=contains,
        nb_in=nb_in,
        nb_out=nb_out,
        suffix_rep=rep[1 : p + 1],
        prefix_rep=rep[:p],
        fwd_rows=fwd_rows,
    )


# ---------------------------------------------------------------------------
# Planes over sorted sets (the graft entry point and the mesh's sharded_scan)

def _member(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Whether each u64 key (int64 bit patterns) is in `sorted_keys` (sorted
    in unsigned order): a lower bound on the biased words, then equality."""
    if sorted_keys.shape[0] == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    idx = torch.searchsorted(sorted_keys ^ K.SIGN_BIT, keys ^ K.SIGN_BIT)
    return sorted_keys[idx.clamp(max=sorted_keys.shape[0] - 1)] == keys


def _scan_planes_sorted_plain(codes: torch.Tensor, solid: torch.Tensor, repeat: torch.Tensor, k: int) -> dict:
    """Plain version of K14: roll the window's k-mers (an invalid base reads
    as A), then 1 + 8 + 2 binary searches a position."""
    fwd, valid = rolling_kmers(codes, k)
    contains = _member(solid, K.canonical_u64(fwd, k))
    mask = K.i64(K.kmer_mask(k))
    nb_out = torch.zeros(fwd.shape, dtype=torch.int32, device=fwd.device)
    nb_in = torch.zeros_like(nb_out)
    for x in range(4):
        nb_out += _member(solid, K.canonical_u64(((fwd << 2) | x) & mask, k))
        nb_in += _member(solid, K.canonical_u64(K.shr(fwd, 2) | K.i64(x << (2 * (k - 1))), k))
    km1 = K.i64(K.kmer_mask(k - 1))
    return {
        "fwd": fwd, "valid": valid, "contains": contains,
        "nb_in": torch.where(contains, nb_in, 0), "nb_out": torch.where(contains, nb_out, 0),
        "suffix_rep": _member(repeat, K.canonical_u64(fwd & km1, k - 1)),
        "prefix_rep": _member(repeat, K.canonical_u64(K.shr(fwd, 2) & km1, k - 1)),
    }


_SORTED_LIB = None


def _sorted_lib():
    global _SORTED_LIB
    if _SORTED_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("scan_sorted.cu", "libmtg_scan_sorted.so")
        lib.scan_sorted_launch.restype = ctypes.c_int
        lib.scan_sorted_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            *[ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p] * 2,
            *[ctypes.c_void_p] * 8,
        ]
        _SORTED_LIB = lib
    return _SORTED_LIB


def set_indexes(solid: torch.Tensor, repeat: torch.Tensor):
    """The bucket indexes (ops/sorted_index.py) of the solid and the repeat
    set on a CUDA device, for a caller that holds the sets fixed over many
    scan_planes_sorted calls to build once and pass in; None on the CPU,
    whose plain version needs none."""
    return (SI.build(solid), SI.build(repeat)) if solid.is_cuda else None


def scan_planes_sorted_cuda(codes: torch.Tensor, solid: torch.Tensor, repeat: torch.Tensor, k: int,
                            indexes=None) -> dict:
    """K14 (csrc/scan_sorted.cu): the same planes as _scan_planes_sorted_plain.
    `indexes` are the sets' bucket indexes (set_indexes); where none are
    given, the wrapper builds them first (two launches of the build kernel,
    in the same stream). Then a thread a position looks its eleven words up
    in two dependent steps each. Counts one launch per window in
    `scan_planes_sorted_cuda.launches`."""
    check_kernel_tensor(codes, "codes", torch.uint8, 1)
    check_kernel_tensor(solid, "solid", torch.int64, 1)
    check_kernel_tensor(repeat, "repeat", torch.int64, 1)
    w = codes.shape[0]
    if not 2 <= k <= 32 or w < k or w >= 1 << 40:
        raise ValueError(f"k must be in [2, 32] and the window at least k, got k={k}, window={w}")
    dev = codes.device
    p = w - k + 1
    out = {"fwd": torch.empty(p, dtype=torch.int64, device=dev)}
    for key in PLANE_KEYS[1:]:
        out[key] = torch.empty(p, dtype=torch.int32 if key.startswith("nb_") else torch.bool, device=dev)
    if indexes is None:
        indexes = set_indexes(solid, repeat)
    # an empty set's keys are never read: any valid address stands in for them
    sets = [arg for keys, index in zip((solid, repeat), indexes)
            for arg in (keys.data_ptr() or codes.data_ptr(), keys.shape[0], index.start.data_ptr(),
                        index.head.data_ptr())]
    launch("scan_sorted", _sorted_lib().scan_sorted_launch,
           codes.data_ptr(), w, k, *sets, *(out[key].data_ptr() for key in PLANE_KEYS),
           device=dev)
    scan_planes_sorted_cuda.launches += 1
    return out


scan_planes_sorted_cuda.launches = 0


def scan_planes_sorted(codes: torch.Tensor, solid: torch.Tensor, repeat: torch.Tensor, k: int,
                       indexes=None) -> dict:
    """The plane pass of one padded window over sorted sets (the JAX
    package's scan_planes_device; k <= 32): codes u8[W] (255 = invalid),
    the solid set and the (k-1)-mer repeat set as int64 u64 words sorted in
    unsigned order, and optionally their bucket indexes (set_indexes, built
    once by a caller that holds the sets fixed). Returns the seven planes
    of find/scan.py Planes, each [W - k + 1] (fwd int64, nb_in/nb_out
    int32, the rest bool). On a CUDA tensor this runs the kernel K14; on a
    CPU tensor its plain version."""
    if codes.is_cuda:
        return scan_planes_sorted_cuda(codes, solid, repeat, k, indexes)
    return _scan_planes_sorted_plain(codes, solid, repeat, k)


def compute_planes_device(codes: np.ndarray, k: int, solid_sorted, repeat_sorted, device,
                          window: int = 1 << 20):
    """Host wrapper of scan_planes_sorted: windows a chromosome (halo k-1,
    each padded to `window` with invalid bases), runs the pass on `device`
    and stitches numpy planes identical to find/scan.py compute_planes."""
    from .scan import Planes

    device = torch.device(device)
    if codes.shape[0] < k:
        z = np.zeros(0)
        return Planes(*(z.astype(t) for t in (bool, np.uint64, bool, np.int32, np.int32, bool, bool)))
    solid = torch.from_numpy(K.as_i64(solid_sorted)).to(device)
    repeat = torch.from_numpy(K.as_i64(repeat_sorted)).to(device)
    indexes = set_indexes(solid, repeat)
    outs = {key: [] for key in PLANE_KEYS}
    npos = codes.shape[0] - k + 1
    pos = 0
    while pos < npos:
        take = min(window - (k - 1), npos - pos)
        chunk = np.full(window, INVALID, np.uint8)
        part = codes[pos : pos + take + k - 1]
        chunk[: part.shape[0]] = part
        res = scan_planes_sorted(torch.from_numpy(chunk).to(device), solid, repeat, k, indexes)
        for key in PLANE_KEYS:
            outs[key].append(res[key][:take].cpu().numpy())
        pos += take
    planes = {key: np.concatenate(v) for key, v in outs.items()}
    planes["fwd"] = planes["fwd"].view(np.uint64)
    return Planes(**planes)
