"""Fused quotient maps over canonical (k-1)- and (k-2)-mers — the graph
probe structures of the find scan and the fill walk (k <= 256).

The find scan needs, per reference position: membership of kmer_i, its
forward-strand in/out degrees and two (k-1)-mer repeat bits. All of it
rides in a 9-bit payload per canonical (k-1)-mer p:

    ext[4 bits]  — which bases x make  p·x  a solid k-mer (as-read p)
    pre[4 bits]  — which bases y make  y·p  a solid k-mer (as-read p)
    rep[1 bit]   — p is a repeat of the reference

and one canonical entry serves both strands (ext_{rc(p)}[x] = pre_p[x^2],
complement is code^2 in the A=0,C=1,T=2,G=3 alphabet). The tables are built
on the host, by the native builders (native/tables.cpp) or, for the span
map, in numpy; the cuckoo hash `mix` is a bijection on u64, so a slot
stores only the hash remainder plus which hash placed it and still
identifies its key exactly.

The layouts used here:
- QMap (cuckoo, one u64 slot per (k-1)-mer) and QMapB (16-slot buckets):
  the fill walk's probes, scalar on the host (fill/traversal.py GraphView)
  and batched on the device (lookup_q, lookup_qb; fill/walk_device.py,
  csrc/walk.cu), and the find scan's plane path (`-scan-engine device`
  and `device-qb`: find/scan_device.py scan_planes_q and scan_planes_qb,
  csrc/scan_planes.cu), whose planes come from adjacent payloads
  (planes_from_payload);
- QMapP (pair-coalesced): one 16-byte row per canonical (k-2)-mer r holding
  the payloads of all eight (k-1)-mers containing r, so ONE row lookup
  yields the payloads of two consecutive reference positions. The find
  scan's device pass (find/scan_device.py, csrc/scan_qp.cu) reads it;
- QMapSpan (32 < k <= 256): QMap's slots keyed by a 64-bit digest of the
  multi-word (k-1)-mer, with the other words in satellite planes; the
  span scan and the span walker read it (lookup_q_span; csrc/span_map.cuh).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..device import check_kernel_tensor
from ..utils.phases import count, span
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


def _where(cond, a, b):
    """np.where or torch.where, by the type of `cond`."""
    return torch.where(cond, a, b) if isinstance(cond, torch.Tensor) else np.where(cond, a, b)


def _oriented(payload, is_canon):
    """(ext, pre) bitmaps of a (k-1)-mer as read, from the payload of its
    canonical form: ext_{rc(p)}[x] = pre_p[x^2] and pre_{rc(p)}[y] = ext_p[y^2]
    (numpy arrays or tensors)."""
    ext_c = payload & 0x0F
    pre_c = (payload >> 4) & 0x0F
    ext = _where(is_canon, ext_c, _shuffle02(pre_c))
    pre = _where(is_canon, pre_c, _shuffle02(ext_c))
    return ext, pre


def _popcount4(bits):
    return ((bits >> 0) & 1) + ((bits >> 1) & 1) + ((bits >> 2) & 1) + ((bits >> 3) & 1)


def planes_from_payload(payload_i, payload_i1, strand_i, strand_i1, last_base_i):
    """Derive (contains_i, nb_in_i, nb_out_i) from the payloads of
    q_i = kmer_i[0:k-1] and q_{i+1} = kmer_i[1:k]:

      contains(kmer_i) = ext_{q_i}[last base of kmer_i]
      nb_out(kmer_i)   = popcount(ext_{q_{i+1}})
      nb_in(kmer_i)    = popcount(pre_{q_i})

    strand_*: True where the as-read (k-1)-mer equals its canonical form.
    last_base_i: kmer_i's last base code (= base at position i+k-1). numpy
    arrays (any unsigned payload type) or int64 tensors; the degrees are
    int32."""
    ext_i, pre_i = _oriented(payload_i, strand_i)
    ext_i1, _ = _oriented(payload_i1, strand_i1)
    contains = ((ext_i >> last_base_i) & 1) != 0
    nb_out, nb_in = _popcount4(ext_i1), _popcount4(pre_i)
    if isinstance(contains, torch.Tensor):
        return contains, nb_in.to(torch.int32), nb_out.to(torch.int32)
    return contains, nb_in.astype(np.int32), nb_out.astype(np.int32)


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
    out = torch.zeros_like(keys)
    for choice in (0, 1):
        hit, v = q_probe(qm, keys, choice)
        out = torch.where(hit, v & QPAY_MASK, out)
    return out | _stash_payload(keys, qm.stash_keys, qm.stash_payload)


def q_probe(qm: QMap, keys: torch.Tensor, choice: int):
    """One slot probe of lookup_q, hash choice 0 or 1 (qm from QMap.to):
    whether each key's slot holds it, and the slot word."""
    shift = 64 - qm.log_size
    h = _mix(keys, (_H1, _H2)[choice])
    v = qm.slots[K.shr(h, shift)]
    hit = (
        (K.shr(v, _Q_SHIFT_PAY) == (h & ((1 << shift) - 1)))
        & ((v & _Q_VALID) != 0)
        & (((v & _Q_CHOICE) != 0) == (choice == 1))
    )
    return hit, v


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
    with span("place"):
        for attempt in range(1, 6):
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
                break
            if rc == -1:
                log1 += 1
            else:
                log2s += 1
        else:
            raise RuntimeError("pair map build: placement failed at every table size")
    count("placement attempts", attempt)
    return QMapP(slots2, log2s, k, sk, sl, sr)


def qp_probe(qp: QMapP, keys: torch.Tensor, choice: int):
    """One row probe of lookup_qp, hash choice 0 or 1 (qp from QMapP.to):
    whether each key's row holds it, and the row's (L36, R36)."""
    shift = 64 - qp.log_size
    h = _mix(keys, (_H1, _H2)[choice])
    rows = qp.slots[K.shr(h, shift)]  # [N, 2] row gather
    lane0 = rows[..., 0]
    lane1 = rows[..., 1]
    hit = (
        ((K.shr(lane0, 10) & _QP_REM_MASK) == (h & ((1 << shift) - 1)))
        & ((lane0 & _QP_VALID) != 0)
        & (((lane0 & _QP_CHOICE) != 0) == (choice == 1))
    )
    return hit, ((lane0 & 0xFF) << 28) | K.shr(lane1, 36), lane1 & _QP_L36


def lookup_qp(qp: QMapP, canon_keys: torch.Tensor):
    """Pair lookup on int64 tensors (qp from QMapP.to): 2 row gathers plus a
    pass over the <= 64-entry stash. Returns (L36, R36) int64 tensors (0 for
    absent buckets)."""
    keys = canon_keys
    l36 = torch.zeros_like(keys)
    r36 = torch.zeros_like(keys)
    for choice in (0, 1):
        hit, lv, rv = qp_probe(qp, keys, choice)
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


# ---------------------------------------------------------------------------
# QMapSpan: the multi-word (32 < k <= 256) fused quotient map. Keys are
# canonical (k-1)-mers of Wq = ceil((k-1)/32) words, exact through a 64-bit
# residual digest:
#
#   key64 = w0 ^ G(w1..w_{Wq-1})        (ops/span_device.py digest64)
#
# The quotient slot pins mix(key64 ^ salt) fully (mix is a bijection), and
# satellite planes store words 1..Wq-1 raw; equal digest and equal
# satellites mean equal keys (w0 recovered by the xor). A probe reads one
# slot and Wq-1 satellite words. `salt` keeps every salted digest off the
# EMPTY sentinel (digests span the full u64 range). The slot encoding is
# QMap's. The table is placed in numpy (_place), as in the JAX package,
# whose native placer takes no row-index payloads: the same keys give the
# same table slot for slot.


@dataclass
class _Placed:
    """A 2-choice cuckoo placement: keys[slot] (EMPTY = free), payload[slot],
    and the keys left over in the stash, sorted."""

    keys: np.ndarray
    payload: np.ndarray
    log_size: int
    stash_keys: np.ndarray
    stash_payload: np.ndarray


def _mix_np(keys, const):
    h = (keys ^ (keys >> np.uint64(33))) * const
    return h ^ (h >> np.uint64(29))


def _place(keys: np.ndarray, values: np.ndarray, load_factor: float, min_log: int = 4) -> _Placed:
    """2-choice cuckoo placement of unique u64 keys (numpy; the JAX
    package's placement, step for step): parallel greedy rounds with
    staggered forced evictions, then a sequential random-walk cleanup; at
    most 64 keys go to the stash."""
    n = max(int(keys.size), 1)
    log_size = max(min_log, int(np.ceil(np.log2(n / load_factor))))
    size = 1 << log_size
    tab_k = np.full(size, EMPTY, np.uint64)
    tab_v = np.zeros(size, values.dtype)
    choice = np.zeros(size, np.uint8)

    pend_k, pend_v = keys, values
    ptry = np.zeros(pend_k.size, np.uint8)
    attempts = np.zeros(pend_k.size, np.uint8)
    consts = (_H1, _H2)

    for rnd in range(300):
        if pend_k.size == 0:
            break
        slots = np.empty(pend_k.size, np.int64)
        for h in range(2):
            m = ptry == h
            if m.any():
                slots[m] = (_mix_np(pend_k[m], consts[h]) >> np.uint64(64 - log_size)).astype(np.int64)
        force = attempts >= 2
        greedy = ~force & (tab_k[slots] == EMPTY)
        gidx = np.nonzero(greedy)[0]
        u, fi = np.unique(slots[gidx], return_index=True)
        tab_k[u] = pend_k[gidx[fi]]
        tab_v[u] = pend_v[gidx[fi]]
        choice[u] = ptry[gidx[fi]]
        placed = np.zeros(pend_k.size, bool)
        placed[gidx[fi]] = True

        ev_k = np.zeros(0, np.uint64)
        ev_v = np.zeros(0, values.dtype)
        ev_t = np.zeros(0, np.uint8)
        fidx = np.nonzero(force)[0]
        if fidx.size:
            # stagger evictions (random ~25% per round, varying by round) to
            # break symmetric eviction cycles between parallel force keys
            gate = ((_mix_np(pend_k[fidx], np.uint64(0xA0761D6478BD642F + 2 * rnd + 1)) >> np.uint64(62)) == 0)
            fidx = fidx[gate]
        if fidx.size:
            u, fi = np.unique(slots[fidx], return_index=True)
            occ = tab_k[u] != EMPTY
            ev_k, ev_v = tab_k[u][occ], tab_v[u][occ]
            ev_t = (choice[u][occ] + 1) % 2
            tab_k[u] = pend_k[fidx[fi]]
            tab_v[u] = pend_v[fidx[fi]]
            choice[u] = ptry[fidx[fi]]
            placed[fidx[fi]] = True

        rest = ~placed
        pend_k = np.concatenate([pend_k[rest], ev_k])
        pend_v = np.concatenate([pend_v[rest], ev_v])
        ptry = np.concatenate([(ptry[rest] + 1) % 2, ev_t])
        attempts = np.concatenate([attempts[rest] + 1, np.zeros(ev_k.size, np.uint8)])

    # sequential random-walk cleanup
    rng = np.random.default_rng(0xBEEF)
    stuck_k, stuck_v = [], []
    for key, val in zip(pend_k, pend_v):
        cur_k, cur_v = np.uint64(key), values.dtype.type(val)
        ch = 0
        ok = False
        for _ in range(500):
            slot = int(_mix_np(cur_k[None], consts[ch])[0] >> np.uint64(64 - log_size))
            if tab_k[slot] == EMPTY:
                tab_k[slot], tab_v[slot], choice[slot] = cur_k, cur_v, ch
                ok = True
                break
            cur_k, tab_k[slot] = tab_k[slot], cur_k
            cur_v, tab_v[slot] = tab_v[slot], cur_v
            oc = int(choice[slot])
            choice[slot] = ch
            ch = (oc + 1) % 2
        if not ok:
            stuck_k.append(int(cur_k))
            stuck_v.append(int(cur_v))
    if len(stuck_k) > 64:
        raise ValueError(f"extmap build left {len(stuck_k)} keys unplaced")
    order = np.argsort(np.array(stuck_k, np.uint64))
    return _Placed(
        tab_k, tab_v, log_size,
        np.array(stuck_k, np.uint64)[order],
        np.array(stuck_v, values.dtype)[order],
    )


def _quotient_encode(tab_keys: np.ndarray, tab_vals: np.ndarray, log_size: int) -> np.ndarray:
    """Pack an explicit (key, payload) cuckoo table into quotient slots.

    The hash choice per slot is recovered from the keys themselves: a key
    sits either at its H1 or its H2 slot (when both coincide, H1 works)."""
    shift = np.uint64(64 - log_size)
    occ = tab_keys != EMPTY
    sidx = np.arange(tab_keys.size, dtype=np.uint64)
    h1 = _mix_np(tab_keys, _H1)
    h2 = _mix_np(tab_keys, _H2)
    use1 = (h1 >> shift) == sidx
    ok = use1 | ((h2 >> shift) == sidx)
    if not ok[occ].all():
        raise AssertionError("quotient encode: slot not reachable by either hash")
    h = np.where(use1, h1, h2)
    rem_mask = (np.uint64(1) << shift) - np.uint64(1)
    val = (
        ((h & rem_mask) << np.uint64(_Q_SHIFT_PAY))
        | np.uint64(_Q_VALID)
        | np.where(use1, np.uint64(0), np.uint64(_Q_CHOICE))
        | tab_vals.astype(np.uint64)
    )
    return np.where(occ, val, np.uint64(0))


@dataclass
class QMapSpan:
    """Host tables are numpy arrays; `to(device)` gives the same tables as
    int64 tensors (QMapP.to's layout)."""

    slots: np.ndarray | torch.Tensor  # u64 [S]; 0 = empty
    sat: np.ndarray | torch.Tensor  # u64 [Wq-1, S] satellite word planes
    log_size: int
    salt: int
    stash_key64: np.ndarray | torch.Tensor  # u64 [n] (salted digests; EMPTY-padded)
    stash_sat: np.ndarray | torch.Tensor  # u64 [n, Wq-1]
    stash_payload: np.ndarray | torch.Tensor  # u16 [n]

    @property
    def nbytes(self):
        return self.slots.nbytes + self.sat.nbytes

    def to(self, device) -> "QMapSpan":
        return QMapSpan(_up(self.slots, device), _up(self.sat, device), self.log_size, self.salt,
                        _up(self.stash_key64, device), _up(self.stash_sat, device),
                        _up(self.stash_payload, device))


def check_span_tables(slots, sat, stash_k64, stash_sat, stash_v, log_size: int, k: int):
    """Validate a span map's int64 tensors (QMapSpan.to on the card) for
    the kernels K6 and K7, which read them through csrc/span_map.cuh."""
    check_kernel_tensor(slots, "slots", torch.int64, 1)
    check_kernel_tensor(sat, "sat", torch.int64, 2)
    check_kernel_tensor(stash_k64, "stash_k64", torch.int64, 1)
    check_kernel_tensor(stash_sat, "stash_sat", torch.int64, 2)
    check_kernel_tensor(stash_v, "stash_v", torch.int64, 1)
    if not 33 <= k <= 256:
        raise ValueError(f"the span map serves 32 < k <= 256, got k={k}")
    wq = -(-(k - 1) // 32)
    n_stash = stash_k64.shape[0]
    if not 12 <= log_size <= 40 or slots.shape[0] != 1 << log_size:
        raise ValueError(f"slots must hold 2**log_size words with log_size in [12, 40], got {slots.shape[0]}")
    if tuple(sat.shape) != (wq - 1, 1 << log_size):
        raise ValueError(f"sat must be [{wq - 1}, 2**log_size] at k={k}, got {tuple(sat.shape)}")
    if not 1 <= n_stash <= 64 or tuple(stash_sat.shape) != (n_stash, wq - 1) or stash_v.shape[0] != n_stash:
        raise ValueError("the stash must hold 1..64 entries, each with Wq-1 satellite words and a payload")


def build_fused_span(solid_rows: np.ndarray, k: int, repeat_rows: np.ndarray,
                     load_factor: float = 0.35) -> QMapSpan:
    """Fused (k-1)-mer map for k > 32: ext/pre bits from the multi-word solid
    set (rows of ceil(k/32) words) plus the repeat bit from the (k-1)-mer
    repeat rows, quotient-encoded with satellite word planes."""
    from .span import Span

    sp = Span(k)
    spm1 = Span(k - 1)
    wq = spm1.W
    solid_rows = np.asarray(solid_rows, np.uint64).reshape(-1, sp.W)
    repeat_rows = np.asarray(repeat_rows, np.uint64).reshape(-1, wq)

    with span("keys"):
        rows, vals, dig_s, salt, redraws = _span_keys(sp, spm1, solid_rows, k, repeat_rows)
    count("placement attempts", 1 + redraws)
    with span("place"):
        return _span_place(rows, vals, dig_s, salt, wq, load_factor)


def _span_keys(sp, spm1, solid_rows: np.ndarray, k: int, repeat_rows: np.ndarray):
    """build_fused_span's keys: the (k-1)-mer edge rows of both strands and
    the repeat rows, deduplicated by void keys with their payload bits ORed,
    and their salted digests. Returns (rows, payloads, salted digests,
    salt, salt redraws)."""
    from .span_device import digest64

    wq = spm1.W
    rows_parts, bits_parts = [], []
    fwd = solid_rows
    orientations = (fwd, sp.revcomp(fwd)) if fwd.size else (fwd,)
    for F in orientations:
        if F.shape[0] == 0:
            continue
        # prefix rule: p = (F >> 2) & mask(k-1), x = last base -> ext_p[x]
        p = sp.low_bits(sp.shifted_right2(F), k - 1)
        x = (F[:, -1] & np.uint64(3)).astype(np.uint8)
        cp = spm1.canonical(p)
        is_c = spm1.keys(p) == spm1.keys(cp)
        bit = np.where(is_c, x, 4 + (x ^ 2))
        rows_parts.append(cp)
        bits_parts.append(np.left_shift(np.uint16(1), bit.astype(np.uint16)).astype(np.uint16))
        # suffix rule: s = F & mask(k-1), y = first base -> pre_s[y]
        s = sp.low_bits(F, k - 1)
        top_bits = 2 * k - 64 * (sp.W - 1)
        y = ((F[:, 0] >> np.uint64(top_bits - 2)) & np.uint64(3)).astype(np.uint8)
        cs = spm1.canonical(s)
        is_cs = spm1.keys(s) == spm1.keys(cs)
        bit = np.where(is_cs, 4 + y, (y ^ 2))
        rows_parts.append(cs)
        bits_parts.append(np.left_shift(np.uint16(1), bit.astype(np.uint16)).astype(np.uint16))
    if repeat_rows.shape[0]:
        rows_parts.append(repeat_rows)
        bits_parts.append(np.full(repeat_rows.shape[0], QREP_BIT, np.uint16))

    if rows_parts:
        rows_all = np.concatenate(rows_parts)
        bits_all = np.concatenate(bits_parts)
    else:
        rows_all = np.zeros((0, wq), np.uint64)
        bits_all = np.zeros(0, np.uint16)

    # dedup by void keys, OR the payload bits
    keys_v = spm1.keys(rows_all)
    order = np.argsort(keys_v, kind="stable")
    kv, bv = keys_v[order], bits_all[order]
    uniq = np.empty(kv.size, bool)
    if kv.size:
        uniq[0] = True
        uniq[1:] = kv[1:] != kv[:-1]
        group = np.cumsum(uniq) - 1
        merged = np.zeros(int(group[-1]) + 1, np.uint16)
        np.bitwise_or.at(merged, group, bv)
        rows = spm1.from_keys(kv[uniq])
        vals = merged
    else:
        rows = rows_all
        vals = bits_all

    count("rows before dedup", rows_all.shape[0])
    count("rows after dedup", rows.shape[0])
    dig = digest64(rows.T) if rows.shape[0] else np.zeros(0, np.uint64)
    salt = np.uint64(0)
    redraws = 0
    rng = np.random.default_rng(0xD1CE)
    while rows.shape[0] and bool(((dig ^ salt) == EMPTY).any()):
        salt = np.uint64(rng.integers(0, 1 << 63, dtype=np.uint64))
        redraws += 1
    return rows, vals, dig ^ salt, salt, redraws


def _span_place(rows: np.ndarray, vals: np.ndarray, dig_s: np.ndarray, salt, wq: int,
                load_factor: float) -> QMapSpan:
    """build_fused_span's table: the salted digests placed (_place), the
    slots quotient-encoded with each row's payload, the satellite word
    planes and the stash."""
    em = _place(dig_s, np.arange(max(rows.shape[0], 1), dtype=np.uint32)[: rows.shape[0]]
                if rows.shape[0] else np.zeros(0, np.uint32),
                load_factor, min_log=12)
    size = 1 << em.log_size
    occ = em.keys != EMPTY
    idx = em.payload.astype(np.int64)
    pay_slot = np.where(occ, vals[np.minimum(idx, max(vals.size - 1, 0))] if vals.size else 0, 0).astype(np.uint16)
    slots = _quotient_encode(em.keys, pay_slot, em.log_size)
    sat = np.zeros((wq - 1, size), np.uint64)
    if rows.shape[0]:
        occ_idx = np.nonzero(occ)[0]
        for i in range(1, wq):
            sat[i - 1, occ_idx] = rows[idx[occ_idx], i]

    n_st = em.stash_keys.size
    stash_key64 = em.stash_keys if n_st else np.array([EMPTY], np.uint64)
    if n_st:
        sidx = em.stash_payload.astype(np.int64)
        stash_sat = rows[sidx][:, 1:] if wq > 1 else np.zeros((n_st, 0), np.uint64)
        stash_pay = vals[sidx].astype(np.uint16)
    else:
        stash_sat = np.zeros((1, wq - 1), np.uint64)
        stash_pay = np.zeros(1, np.uint16)
    return QMapSpan(slots, sat, em.log_size, int(salt), stash_key64, stash_sat, stash_pay)


def span_probe(qms: QMapSpan, words: torch.Tensor):
    """Both cuckoo probes of multi-word keys (qms from QMapSpan.to; words:
    (Wq, P) canonical (k-1)-mers), row 0 under H1 and row 1 under H2:
    (the salted digests [P], the slot words [2, P], whether each slot holds
    the key's digest — remainder, valid bit and choice — [2, P], and
    whether it holds the key, its satellite words equal too, [2, P])."""
    from .span_device import digest64

    shift = 64 - qms.log_size
    dig = digest64(words) ^ K.i64(qms.salt)
    consts = torch.tensor([[K.i64(_H1)], [K.i64(_H2)]], device=words.device)
    h = (dig ^ K.shr(dig, 33))[None] * consts  # _mix, under both constants
    h = h ^ K.shr(h, 29)
    slot = K.shr(h, shift)
    v = qms.slots[slot]
    choice = torch.tensor([[_Q_VALID], [_Q_VALID | _Q_CHOICE]], device=words.device)
    here = (v & ~QPAY_MASK) == (((h & ((1 << shift) - 1)) << _Q_SHIFT_PAY) | choice)
    hit = here & (qms.sat[:, slot] == words[1:, None]).all(0) if words.shape[0] > 1 else here
    return dig, v, here, hit


def lookup_q_span(qms: QMapSpan, words: torch.Tensor) -> torch.Tensor:
    """Fused payload lookup of multi-word keys on int64 tensors (qms from
    QMapSpan.to): per probe one slot and Wq-1 satellite gathers, for both
    hash choices (span_probe), then the stash, whose hit is ORed in.
    words: (Wq, P) canonical (k-1)-mers. Returns the 9-bit payloads (0 for
    absent keys)."""
    dig, v, _here, hit = span_probe(qms, words)
    # a key sits in one place; the second choice's hit is taken over the first's
    out = torch.where(hit[1], v[1], torch.where(hit[0], v[0], 0)) & QPAY_MASK
    # the stash: its rows are unique, so at most one entry matches; the
    # EMPTY padding carries payload 0, so a digest equal to it adds nothing
    for s in range(qms.stash_key64.shape[0]):
        eq = dig == qms.stash_key64[s]
        if words.shape[0] > 1:
            eq = eq & (words[1:] == qms.stash_sat[s][:, None]).all(0)
        out = out | torch.where(eq, qms.stash_payload[s], 0)
    return out
