"""Per-position "plane" computation for the reference scan, on the host.

This is the hot loop of `find` (reference src/FindBreakpoints.hpp:560-622:
|ref| iterations x ~11 membership probes). Instead of probing one k-mer at a
time, the planes of a whole chromosome (or window) are computed at once:

    valid[i]      k-mer validity (no N)
    fwd[i]        forward-strand packed k-mer
    contains[i]   solid-set membership of the canonical k-mer
    nb_in[i]      in-degree of the forward-oriented node (0 if !contains)
    nb_out[i]     out-degree (0 if !contains)
    suffix_rep[i] canonical (k-1)-suffix present in the reference-repeat set
    prefix_rep[i] canonical (k-1)-prefix present in the reference-repeat set

An automaton (the native one, find/native_scan.py, or the Python one,
automaton.py) then replays the reference state machine over these planes.
compute_planes is the exact numpy oracle (`-scan-engine host`); the device
engines produce the same planes (find/scan_device.py). A copy of the JAX
package's find/scan.py, numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import kmers as K


@dataclass
class Planes:
    valid: np.ndarray
    fwd: np.ndarray
    contains: np.ndarray
    nb_in: np.ndarray
    nb_out: np.ndarray
    suffix_rep: np.ndarray
    prefix_rep: np.ndarray
    # k > 32 only: the forward kmers as (P, W) uint64 word rows (the span
    # layout, ops/span.py) for the native automaton; `fwd` stays the
    # object-int array the python automaton consumes.
    fwd_rows: np.ndarray | None = None

    def __len__(self):
        return int(self.valid.shape[0])


def _member_sorted(sorted_arr, keys):
    """Vectorized membership of keys in a sorted uint64 array."""
    if sorted_arr.shape[0] == 0:
        return np.zeros(keys.shape, dtype=bool)
    idx = np.searchsorted(sorted_arr, keys)
    idx = np.minimum(idx, sorted_arr.shape[0] - 1)
    return sorted_arr[idx] == keys


def compute_planes(codes: np.ndarray, k: int, solid_kmers, repeat_kmers) -> Planes:
    """Compute scan planes for one chromosome (the exact host oracle).

    solid_kmers / repeat_kmers: sorted uint64 arrays (k and k-1 sized
    canonical sets). For k > 32 this is compute_planes_span (multi-word
    keys)."""
    if k > 32:
        return compute_planes_span(codes, k, solid_kmers, repeat_kmers)
    fwd, valid = K.kmers_from_codes(codes, k)
    if fwd.size == 0:
        z = np.zeros(0)
        return Planes(*(z.astype(t) for t in (bool, np.uint64, bool, np.int32, np.int32, bool, bool)))
    canon = K.canonical_u64(fwd, k)
    contains = _member_sorted(solid_kmers, canon)

    mask = K.kmer_mask(k)
    shift_hi = np.uint64(2 * (k - 1))
    nb_out = np.zeros(fwd.shape, np.int32)
    nb_in = np.zeros(fwd.shape, np.int32)
    for x in range(4):
        out_n = ((fwd << np.uint64(2)) | np.uint64(x)) & mask
        nb_out = nb_out + _member_sorted(solid_kmers, K.canonical_u64(out_n, k))
        in_n = (fwd >> np.uint64(2)) | (np.uint64(x) << shift_hi)
        nb_in = nb_in + _member_sorted(solid_kmers, K.canonical_u64(in_n, k))
    nb_out = np.where(contains, nb_out, 0)
    nb_in = np.where(contains, nb_in, 0)

    # (k-1)-mer repeat bits (store_kmer_info, src/FindBreakpoints.hpp:1029-1045)
    km1_mask = K.kmer_mask(k - 1)
    suffix = fwd & km1_mask
    prefix = (fwd >> np.uint64(2)) & km1_mask
    suffix_rep = _member_sorted(repeat_kmers, K.canonical_u64(suffix, k - 1))
    prefix_rep = _member_sorted(repeat_kmers, K.canonical_u64(prefix, k - 1))

    return Planes(
        valid=np.asarray(valid),
        fwd=np.asarray(fwd),
        contains=np.asarray(contains),
        nb_in=np.asarray(nb_in, dtype=np.int32),
        nb_out=np.asarray(nb_out, dtype=np.int32),
        suffix_rep=np.asarray(suffix_rep),
        prefix_rep=np.asarray(prefix_rep),
    )


def compute_planes_span(codes: np.ndarray, k: int, solid_keys, repeat_keys) -> Planes:
    """Host plane pass for k > 32: multi-word kmers as (P, W) uint64 rows,
    membership via big-endian void keys (ops/span.py). The `fwd` plane is an
    object array of python ints (what the host automaton consumes)."""
    from ..ops.span import Span

    sp = Span(k)
    spm1 = Span(k - 1)
    arr, valid = sp.from_codes(codes)
    p = arr.shape[0]
    if p == 0:
        z = np.zeros(0)
        return Planes(*(z.astype(t) for t in (bool, object, bool, np.int32, np.int32, bool, bool)))

    def member(keyset, keys):
        if len(keyset) == 0:
            return np.zeros(keys.shape, bool)
        idx = np.searchsorted(keyset, keys)
        idx = np.minimum(idx, len(keyset) - 1)
        return keyset[idx] == keys

    contains = member(solid_keys, sp.keys(sp.canonical(arr)))
    nb_out = np.zeros(p, np.int32)
    nb_in = np.zeros(p, np.int32)
    for x in range(4):
        nb_out += member(solid_keys, sp.keys(sp.canonical(sp.shift_left_insert(arr, x))))
        nb_in += member(solid_keys, sp.keys(sp.canonical(sp.shift_right_insert(arr, x))))
    nb_out = np.where(contains, nb_out, 0)
    nb_in = np.where(contains, nb_in, 0)

    suffix = sp.low_bits(arr, k - 1)
    prefix = sp.low_bits(sp.shifted_right2(arr), k - 1)
    if k - 1 <= 32:
        # k = 33 edge: the (k-1)-mer repeat set is a plain u64 SolidSet
        # (span is only used above 32); query it in its native key form
        suffix_rep = member(repeat_keys, K.canonical_u64(suffix[:, -1], k - 1))
        prefix_rep = member(repeat_keys, K.canonical_u64(prefix[:, -1], k - 1))
    else:
        suffix_rep = member(repeat_keys, spm1.keys(spm1.canonical(suffix)))
        prefix_rep = member(repeat_keys, spm1.keys(spm1.canonical(prefix)))

    return Planes(
        valid=np.asarray(valid),
        fwd=sp.to_ints(arr),
        contains=contains,
        nb_in=nb_in,
        nb_out=nb_out,
        suffix_rep=suffix_rep,
        prefix_rep=prefix_rep,
        fwd_rows=arr,
    )
