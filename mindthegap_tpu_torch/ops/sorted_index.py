"""The bucket index of a sorted set of u64 words held in int64, so that a
lookup on the card costs two dependent steps instead of a binary search
over the whole set (layout and lookup in csrc/sorted_index.cuh; used by
K13's probe, parallel/sharded_membership.py, and K14,
find/scan_device.py scan_planes_sorted).

The set may end in a tail of SENTINEL (all-ones) keys, as the last key
shard of sharded membership does; n_real keys lie below it. The index
covers [lo, hi], lo the first key and hi the last below SENTINEL, with
B = 2^b buckets (b from the set's size, about KEYS_PER_BUCKET keys a
bucket): key x falls in bucket (x - lo) >> s, s = max(0, bitlen(hi - lo) -
b). `start` (int32[B + 1]) holds each bucket's first key (n_real past the
last); `head` (int64[4]) holds lo, hi, s and n_real on the set's device,
so that no wrapper reads them back. With no key below SENTINEL the head is
(SENTINEL, 0, 0, 0), an empty range, and every start is 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..device import check_kernel_tensor, launch
from . import kmers as K

KEYS_PER_BUCKET = 1  # K14 took 0.79 / 0.96 / 1.25 ms a 2^22 window at 1 / 2 / 4 on an H100 (PERF.md §6)
MAX_LOG_BUCKETS = 30  # starts are int32


class SortedIndex(NamedTuple):
    start: torch.Tensor  # int32[2^b + 1]
    head: torch.Tensor  # int64[4]: lo, hi, s, n_real


def log_buckets(n: int) -> int:
    """b for a set of n keys: 2^b buckets of about KEYS_PER_BUCKET keys
    (1 to 2 times as many on a uniform set), at least 2 buckets."""
    return min(MAX_LOG_BUCKETS, max(1, (n // KEYS_PER_BUCKET).bit_length() - 1))


def _build_plain(keys: torch.Tensor, log_b: int) -> SortedIndex:
    """Plain version of the build kernel: the bucket of every key below
    SENTINEL, and torch.searchsorted of the bucket numbers 0..B."""
    dev = keys.device
    n_buckets = 1 << log_b
    real = int(torch.searchsorted(keys ^ K.SIGN_BIT, torch.tensor([K.SIGN_BIT ^ -1], device=dev)))
    if real == 0:
        return SortedIndex(torch.zeros(n_buckets + 1, dtype=torch.int32, device=dev),
                           torch.tensor([-1, 0, 0, 0], dtype=torch.int64, device=dev))
    lo, hi = keys[0], keys[real - 1]
    shift = max(0, (int(hi - lo) & 0xFFFFFFFFFFFFFFFF).bit_length() - log_b)
    buckets = K.shr(keys[:real] - lo, shift)
    start = torch.searchsorted(buckets, torch.arange(n_buckets + 1, device=dev)).to(torch.int32)
    return SortedIndex(start, torch.stack([lo, hi, torch.tensor(shift, device=dev), torch.tensor(real, device=dev)]))


def _lower_bound_plain(keys: torch.Tensor, index: SortedIndex, q: torch.Tensor) -> torch.Tensor:
    """The first position of a key >= each query (unsigned), through the
    index as the lookup of csrc/sorted_index.cuh takes it: 0 below lo,
    n_real above hi (SENTINEL too), else a bisection inside q's bucket."""
    lo, hi, shift, real = index.head
    inside = ~(K.ult(q, lo) | K.ult(hi, q))
    j = torch.where(inside, K.shr(q - lo, int(shift)), 0)
    a = index.start[j].long()
    b = torch.where(inside, index.start[j + 1].long(), a)
    while bool((live := a < b).any()):
        mid = (a + b) // 2
        less = live & K.ult(keys[torch.where(live, mid, 0)], q)
        a = torch.where(less, mid + 1, a)
        b = torch.where(live & ~less, mid, b)
    return torch.where(inside, a, torch.where(K.ult(q, lo), 0, real))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import cuda_library

        lib = cuda_library("sorted_index.cu", "libmtg_sorted_index.so")
        lib.sorted_index_launch.restype = ctypes.c_int
        lib.sorted_index_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def build_cuda(keys: torch.Tensor, log_b: int) -> SortedIndex:
    """The build kernel (csrc/sorted_index.cu): the same index as
    _build_plain, one launch on the keys' card and stream, no readback.
    Counts its launches in `build_cuda.launches`."""
    check_kernel_tensor(keys, "keys", torch.int64, 1)
    n = keys.shape[0]
    if n >= 1 << 31 or not 1 <= log_b <= MAX_LOG_BUCKETS:
        raise ValueError(f"the index takes fewer than 2^31 keys and 1 <= log_b <= {MAX_LOG_BUCKETS}, "
                         f"got {n} keys, log_b {log_b}")
    dev = keys.device
    start = torch.empty((1 << log_b) + 1, dtype=torch.int32, device=dev)
    head = torch.empty(4, dtype=torch.int64, device=dev)
    # an empty set's keys are never read: any valid address stands in for them
    launch("sorted_index", _lib().sorted_index_launch,
           keys.data_ptr() or start.data_ptr(), n, log_b, start.data_ptr(), head.data_ptr(),
           device=dev)
    build_cuda.launches += 1
    return SortedIndex(start, head)


build_cuda.launches = 0


def build(keys: torch.Tensor) -> SortedIndex:
    """The bucket index of sorted int64 u64 words, on their device. On a
    CUDA tensor this runs the build kernel; on a CPU tensor its plain
    version."""
    log_b = log_buckets(keys.shape[0])
    return (build_cuda if keys.is_cuda else _build_plain)(keys, log_b)
