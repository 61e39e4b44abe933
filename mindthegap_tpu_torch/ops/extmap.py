"""Fused quotient maps over canonical (k-1)- and (k-2)-mers — the graph
probe structures of the find scan and the fill walk (k <= 32).

The find scan needs, per reference position: membership of kmer_i, its
forward-strand in/out degrees and two (k-1)-mer repeat bits. All of it
rides in a 9-bit payload per canonical (k-1)-mer p:

    ext[4 bits]  — which bases x make  p·x  a solid k-mer (as-read p)
    pre[4 bits]  — which bases y make  y·p  a solid k-mer (as-read p)
    rep[1 bit]   — p is a repeat of the reference

and one canonical entry serves both strands (ext_{rc(p)}[x] = pre_p[x^2],
complement is code^2 in the A=0,C=1,T=2,G=3 alphabet). The tables are built
on the host by the native builders (native/tables.cpp); the cuckoo hash
`mix` is a bijection on u64, so a slot stores only the hash remainder plus
which hash placed it and still identifies its key exactly.

Two layouts are used here:
- QMap (cuckoo, one u64 slot per (k-1)-mer) and QMapB (16-slot buckets):
  the fill walk's probes, scalar on the host (fill/traversal.py GraphView)
  and batched on the device (lookup_q, lookup_qb; fill/walk_device.py,
  csrc/walk.cu);
- QMapP (pair-coalesced): one 16-byte row per canonical (k-2)-mer r holding
  the payloads of all eight (k-1)-mers containing r, so ONE row lookup
  yields the payloads of two consecutive reference positions. The find
  scan's device pass (find/scan_device.py, csrc/scan_qp.cu) reads it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import kmers as K

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

_H1 = np.uint64(0x9E3779B97F4A7C15)
_H2 = np.uint64(0xC2B2AE3D27D4EB4F)

_NATIVE_LIB = None


def _load_native():
    """Build/load the native table builder (native/tables.cpp)."""
    global _NATIVE_LIB
    if _NATIVE_LIB is None:
        from .._build import native_library

        lib = native_library("tables.cpp", "libmtgtables.so")
        lib.qmap_build.restype = ctypes.c_int64
        lib.qmap_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.qbmap_build.restype = ctypes.c_int64
        lib.qbmap_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.qpmap_build.restype = ctypes.c_int64
        lib.qpmap_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        _NATIVE_LIB = lib
    return _NATIVE_LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _shuffle02(bits):
    """Permute bitmap positions b -> b^2 (swap bits 0<->2 and 1<->3)."""
    b0 = (bits >> 0) & 1
    b1 = (bits >> 1) & 1
    b2 = (bits >> 2) & 1
    b3 = (bits >> 3) & 1
    return (b2 << 0) | (b3 << 1) | (b0 << 2) | (b1 << 3)


def _flip9(p):
    """rc transform of a 9-bit fused payload (as-read -> other strand);
    numpy or torch integers."""
    ext = p & 0xF
    pre = (p >> 4) & 0xF
    return _shuffle02(pre) | (_shuffle02(ext) << 4) | (p & 0x100)


def _oriented(payload: torch.Tensor, is_canon: torch.Tensor):
    """(ext, pre) bitmaps of a (k-1)-mer as read, from the payload of its
    canonical form: ext_{rc(p)}[x] = pre_p[x^2] and pre_{rc(p)}[y] = ext_p[y^2]."""
    ext_c = payload & 0x0F
    pre_c = (payload >> 4) & 0x0F
    ext = torch.where(is_canon, ext_c, _shuffle02(pre_c))
    pre = torch.where(is_canon, pre_c, _shuffle02(ext_c))
    return ext, pre


def _popcount4(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 0) & 1) + ((bits >> 1) & 1) + ((bits >> 2) & 1) + ((bits >> 3) & 1)


def _mix(keys: torch.Tensor, const) -> torch.Tensor:
    """The bijective cuckoo hash on u64 words held in int64 (the multiply
    wraps mod 2^64 like u64)."""
    h = (keys ^ K.shr(keys, 33)) * K.i64(const)
    return h ^ K.shr(h, 29)


def _stash_payload(keys: torch.Tensor, stash_keys: torch.Tensor, stash_payload: torch.Tensor):
    """Payload of each key in the <= 64-entry stash, 0 when absent: one
    broadcast compare. Stash keys are unique and the EMPTY padding (-1)
    never equals a canonical (k-1)-mer, so at most one entry matches."""
    eq = keys[..., None] == stash_keys
    return torch.where(eq, stash_payload, 0).sum(-1)


def _up(a: np.ndarray, device) -> torch.Tensor:
    """A host table as int64 words on `device`."""
    return torch.from_numpy(K.as_i64(a)).to(device)


# ---------------------------------------------------------------------------
# QMap: 2-choice cuckoo, one u64 slot per canonical (k-1)-mer
#
#     [ rem : 64-log_size ][ valid:1 ][ hash-choice:1 ][ payload:9 ]
#      bit 11+               bit 10     bit 9            bits 0-8

QREP_BIT = np.uint16(1 << 8)  # repeat flag inside the payload
QPAY_MASK = 0x1FF  # payload bits 0..8
_Q_SHIFT_PAY = 11
_Q_VALID = 1 << 10
_Q_CHOICE = 1 << 9


@dataclass
class QMap:
    """Host tables are numpy arrays (slots u64, stash payloads u16);
    `to(device)` gives the same tables as int64 tensors."""

    slots: np.ndarray | torch.Tensor  # u64 [2**log_size]; 0 = empty
    log_size: int
    stash_keys: np.ndarray | torch.Tensor  # u64 [<=64] (EMPTY-padded never matches)
    stash_payload: np.ndarray | torch.Tensor  # u16

    @property
    def nbytes(self):
        return self.slots.nbytes

    def to(self, device) -> "QMap":
        return QMap(_up(self.slots, device), self.log_size,
                    _up(self.stash_keys, device), _up(self.stash_payload, device))


def _sorted_stash(stash_k, *vals, n: int):
    """The first n stash entries sorted by key; an EMPTY sentinel row when n == 0."""
    order = np.argsort(stash_k[:n])
    if n == 0:
        return (np.array([EMPTY], np.uint64),) + tuple(np.zeros(1, v.dtype) for v in vals)
    return (stash_k[:n][order],) + tuple(v[:n][order] for v in vals)


def build_fused(solid_canonical: np.ndarray, k: int, repeat_canonical: np.ndarray,
                load_factor: float = 0.35) -> QMap:
    """Union table over canonical (k-1)-mers: ext/pre bitmap (bits 0-7) from
    the solid k-mer set + repeat bit (bit 8) from the reference repeat set
    (native/tables.cpp qmap_build; k <= 32)."""
    lib = _load_native()
    solid = np.ascontiguousarray(solid_canonical, dtype=np.uint64)
    repeat = np.ascontiguousarray(np.unique(np.asarray(repeat_canonical, dtype=np.uint64)))
    # distinct (k-1)-mer keys are ~|solid| in practice; start there and grow
    # on placement failure
    n_est = max(int(solid.size) + int(repeat.size), 4)
    log_size = max(12, int(np.ceil(np.log2(n_est / load_factor))))
    for _ in range(6):
        size = 1 << log_size
        tab_k = np.full(size, EMPTY, np.uint64)
        tab_v = np.zeros(size, np.uint16)
        tab_c = np.zeros(size, np.uint8)
        slots = np.zeros(size, np.uint64)
        stash_k = np.zeros(64, np.uint64)
        stash_v = np.zeros(64, np.uint16)
        n_stash = lib.qmap_build(
            _ptr(solid), solid.size, k, _ptr(repeat), repeat.size, log_size,
            _ptr(tab_k), _ptr(tab_v), _ptr(tab_c), _ptr(slots),
            _ptr(stash_k), _ptr(stash_v), 64,
        )
        if n_stash >= 0:
            sk, sv = _sorted_stash(stash_k, stash_v, n=int(n_stash))
            return QMap(slots, log_size, sk, sv)
        log_size += 1
    raise RuntimeError("quotient map build: placement failed at every table size")


# ---------------------------------------------------------------------------
# QMapB: single-probe map, 16-slot buckets
#
#   slot = [rem : 54][valid:1][payload:9]   (requires log_nb >= 10)

_QB_SLOTS = 16
_QB_SHIFT_PAY = 10
_QB_VALID = 1 << 9


@dataclass
class QMapB:
    """Host tables as in QMap; `to(device)` gives int64 tensors."""

    slots: np.ndarray | torch.Tensor  # u64 [NB * 16]; 0 = empty
    log_nb: int
    stash_keys: np.ndarray | torch.Tensor  # u64 (EMPTY-padded)
    stash_payload: np.ndarray | torch.Tensor  # u16

    @property
    def nbytes(self):
        return self.slots.nbytes

    def to(self, device) -> "QMapB":
        return QMapB(_up(self.slots, device), self.log_nb,
                     _up(self.stash_keys, device), _up(self.stash_payload, device))


def build_fused_bucket(solid_canonical: np.ndarray, k: int, repeat_canonical: np.ndarray,
                       mean_load: float = 4.0) -> QMapB:
    """Bucketized union table over canonical (k-1)-mers (payload semantics
    identical to build_fused; native/tables.cpp qbmap_build)."""
    lib = _load_native()
    solid = np.ascontiguousarray(solid_canonical, dtype=np.uint64)
    repeat = np.ascontiguousarray(np.unique(np.asarray(repeat_canonical, dtype=np.uint64)))
    n_est = max(int(solid.size) + int(repeat.size), 4)
    log_nb = max(10, int(np.ceil(np.log2(n_est / mean_load))))
    for _ in range(4):
        slots = np.zeros((1 << log_nb) * _QB_SLOTS, np.uint64)
        stash_k = np.zeros(64, np.uint64)
        stash_v = np.zeros(64, np.uint16)
        n_stash = lib.qbmap_build(
            _ptr(solid), solid.size, k, _ptr(repeat), repeat.size, log_nb,
            _ptr(slots), _ptr(stash_k), _ptr(stash_v), 64,
        )
        if n_stash >= 0:
            sk, sv = _sorted_stash(stash_k, stash_v, n=int(n_stash))
            return QMapB(slots, log_nb, sk, sv)
        log_nb += 1
    raise RuntimeError("bucket map build: placement failed at every table size")


def lookup_q(qm: QMap, canon_keys: torch.Tensor) -> torch.Tensor:
    """Fused payload lookup on int64 tensors (qm from QMap.to): 2 u64
    gathers plus the stash pass. Returns the 9-bit payload (0 for absent
    keys): ext bits 0-3, pre bits 4-7, repeat bit 8."""
    keys = canon_keys
    shift = 64 - qm.log_size
    rem_mask = (1 << shift) - 1
    out = torch.zeros_like(keys)
    for i, const in enumerate((_H1, _H2)):
        h = _mix(keys, const)
        v = qm.slots[K.shr(h, shift)]
        hit = (
            (K.shr(v, _Q_SHIFT_PAY) == (h & rem_mask))
            & ((v & _Q_VALID) != 0)
            & (((v & _Q_CHOICE) != 0) == (i == 1))
        )
        out = torch.where(hit, v & QPAY_MASK, out)
    return out | _stash_payload(keys, qm.stash_keys, qm.stash_payload)


def lookup_qb(qm: QMapB, canon_keys: torch.Tensor) -> torch.Tensor:
    """Fused payload lookup on int64 tensors (qm from QMapB.to): ONE
    16-slot bucket gather plus the stash pass. Returns the 9-bit payload
    (0 for absent keys)."""
    keys = canon_keys
    shift = 64 - qm.log_nb
    h = _mix(keys, _H1)
    rem = h & ((1 << shift) - 1)
    start = K.shr(h, shift) * _QB_SLOTS
    rows = qm.slots[start[..., None] + torch.arange(_QB_SLOTS, device=keys.device)]
    hit = (K.shr(rows, _QB_SHIFT_PAY) == rem[..., None]) & ((rows & _QB_VALID) != 0)
    out = torch.where(hit, rows & QPAY_MASK, 0).amax(-1)
    return out | _stash_payload(keys, qm.stash_keys, qm.stash_payload)


# ---------------------------------------------------------------------------
# QMapP: pair-coalesced quotient map, ONE 16-byte row per TWO positions.
#
# Consecutive (k-1)-mers q_i = ref[i:i+k-1] and q_{i+1} share the (k-2)-mer
# r = q_i[1:] = q_{i+1}[:-1]. The table is indexed by canonical (k-2)-mers
# r̂; the 128-bit slot stores the 9-bit payloads of ALL EIGHT (k-1)-mers
# containing r̂:
#
#     L[y] = payload of (y + r̂), oriented as-read, y = 0..3   (36 bits)
#     R[x] = payload of (r̂ + x), oriented as-read, x = 0..3   (36 bits)
#
# One lookup at canon(r_i) (i even) + the two flanking bases yields the
# payloads of q_i and q_{i+1} exactly:
#
#     strand (r == r̂):   pay(q_i) = L[codes[i]]        pay(q_{i+1}) = R[x]
#     rc     (r == rc̄):   pay(q_i) = FLIP(R[y^2])       pay(q_{i+1}) = FLIP(L[x^2])
#
# where x = codes[i+k-1] and FLIP is _flip9. A missing bucket is correct by
# construction: q_i having any payload implies r is a suffix of a table
# (k-1)-mer, hence bucket(r) exists.
#
# Slot encoding (2 u64 lanes, 2-choice quotient cuckoo, log_size >= 19):
#   lane0: [0:8) L bits 28..35 | [8] hash-choice | [9] valid | [10:55) rem45
#   lane1: [0:36) R | [36:64) L bits 0..27

_QP_REM_MASK = (1 << 45) - 1
_QP_CHOICE = 1 << 8
_QP_VALID = 1 << 9
_QP_L36 = (1 << 36) - 1


@dataclass
class QMapP:
    """Host tables are uint64 numpy arrays; `to(device)` gives the same
    tables as int64 tensors holding the u64 bit patterns."""

    slots: np.ndarray | torch.Tensor  # [2**log_size, 2]; all-zero row = empty
    log_size: int
    k: int
    stash_keys: np.ndarray | torch.Tensor  # [>=1] sorted (EMPTY-padded)
    stash_l: np.ndarray | torch.Tensor  # L36 per stash key
    stash_r: np.ndarray | torch.Tensor  # R36 per stash key

    @property
    def nbytes(self):
        return self.slots.nbytes

    def to(self, device) -> "QMapP":
        return QMapP(_up(self.slots, device), self.log_size, self.k,
                     _up(self.stash_keys, device), _up(self.stash_l, device), _up(self.stash_r, device))


def build_fused_pair(solid_canonical: np.ndarray, k: int, repeat_canonical: np.ndarray,
                     load_factor: float = 0.35) -> QMapP:
    """Build the pair-coalesced map from the same inputs as build_fused
    (native/tables.cpp qpmap_build)."""
    if not 3 <= k <= 32:
        raise ValueError(f"pair map: k must be in [3, 32], got {k}")
    lib = _load_native()
    solid = np.ascontiguousarray(solid_canonical, dtype=np.uint64)
    repeat = np.ascontiguousarray(np.unique(np.asarray(repeat_canonical, dtype=np.uint64)))
    n_est = max(int(solid.size) + int(repeat.size), 4)
    log1 = max(12, int(np.ceil(np.log2(n_est / load_factor))))
    log2s = max(19, int(np.ceil(np.log2(n_est / load_factor))))
    for _ in range(5):
        t1_keys = np.full(1 << log1, EMPTY, np.uint64)
        t1_vals = np.zeros(1 << log1, np.uint16)
        t1_choice = np.zeros(1 << log1, np.uint8)
        t2_keys = np.full(1 << log2s, EMPTY, np.uint64)
        t2_choice = np.zeros(1 << log2s, np.uint8)
        slots2 = np.zeros((1 << log2s, 2), np.uint64)
        stash_k = np.zeros(64, np.uint64)
        stash_l = np.zeros(64, np.uint64)
        stash_r = np.zeros(64, np.uint64)
        rc = lib.qpmap_build(
            _ptr(solid), solid.size, k, _ptr(repeat), repeat.size, log1, log2s,
            _ptr(t1_keys), _ptr(t1_vals), _ptr(t1_choice), _ptr(t2_keys), _ptr(t2_choice),
            _ptr(slots2), _ptr(stash_k), _ptr(stash_l), _ptr(stash_r), 64,
        )
        if rc >= 0:
            sk, sl, sr = _sorted_stash(stash_k, stash_l, stash_r, n=int(rc))
            return QMapP(slots2, log2s, k, sk, sl, sr)
        if rc == -1:
            log1 += 1
        else:
            log2s += 1
    raise RuntimeError("pair map build: placement failed at every table size")


def lookup_qp(qp: QMapP, canon_keys: torch.Tensor):
    """Pair lookup on int64 tensors (qp from QMapP.to): 2 row gathers plus a
    pass over the <= 64-entry stash. Returns (L36, R36) int64 tensors (0 for
    absent buckets)."""
    keys = canon_keys
    shift = 64 - qp.log_size
    rem_mask = (1 << shift) - 1
    l36 = torch.zeros_like(keys)
    r36 = torch.zeros_like(keys)
    for i, const in enumerate((_H1, _H2)):
        h = _mix(keys, const)
        rows = qp.slots[K.shr(h, shift)]  # [N, 2] row gather
        lane0 = rows[..., 0]
        lane1 = rows[..., 1]
        hit = (
            ((K.shr(lane0, 10) & _QP_REM_MASK) == (h & rem_mask))
            & ((lane0 & _QP_VALID) != 0)
            & (((lane0 & _QP_CHOICE) != 0) == (i == 1))
        )
        lv = ((lane0 & 0xFF) << 28) | K.shr(lane1, 36)
        rv = lane1 & _QP_L36
        l36 = torch.where(hit, lv, l36)
        r36 = torch.where(hit, rv, r36)
    # stash: keys are unique and the EMPTY padding (-1) never equals a
    # canonical (k-2)-mer, so at most one entry matches
    for s in range(qp.stash_keys.shape[0]):
        eq = keys == qp.stash_keys[s]
        l36 = l36 | torch.where(eq, qp.stash_l[s], 0)
        r36 = r36 | torch.where(eq, qp.stash_r[s], 0)
    return l36, r36


def pair_payload_stream(qp: QMapP, codes: np.ndarray, n_pay: int) -> np.ndarray:
    """The per-position fused payload stream pay[j] (9-bit, oriented as-read)
    for the (k-1)-mers q_0..q_{n_pay-1} of `codes`, one pair lookup per two
    positions. Host reference (numpy around a CPU lookup) for the device
    pass in find/scan_device.py; qp holds host tables."""
    k = qp.k
    km2 = k - 2
    w = codes.shape[0]
    n_pairs = (n_pay + 1) // 2
    c = np.where(codes == 255, 0, codes).astype(np.uint64)
    # r_m = (k-2)-mer at position 2m+1 (the shared core of q_{2m}, q_{2m+1})
    full, _valid = K.kmers_from_codes(np.where(codes == 255, 0, codes).astype(np.uint8), km2)
    ridx = np.minimum(1 + 2 * np.arange(n_pairs), full.shape[0] - 1)
    r_asread = full[ridx]
    canon_r = K.canonical_u64(r_asread, km2)
    strand = r_asread == canon_r
    l36, r36 = lookup_qp(qp.to("cpu"), torch.from_numpy(K.as_i64(canon_r)))
    L36, R36 = K.as_u64(l36), K.as_u64(r36)
    y = c[np.minimum(2 * np.arange(n_pairs), w - 1)]
    x = c[np.minimum(2 * np.arange(n_pairs) + k - 1, w - 1)]

    def sub(blk, i4):
        return (blk >> (np.uint64(9) * i4)) & np.uint64(0x1FF)

    pay_even = np.where(strand, sub(L36, y), _flip9(sub(R36, y ^ np.uint64(2))))
    pay_odd = np.where(strand, sub(R36, x), _flip9(sub(L36, x ^ np.uint64(2))))
    pay = np.empty(2 * n_pairs, np.uint64)
    pay[0::2] = pay_even
    pay[1::2] = pay_odd
    return pay[:n_pay].astype(np.uint16)
