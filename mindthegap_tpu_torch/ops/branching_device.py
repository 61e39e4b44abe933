"""The branching count of a solid set on its device (build_graph's
"branching" span, k <= 32): K17 (csrc/branching.cu) on a CUDA tensor, its
plain version on a CPU tensor, both through the set's bucket index
(ops/sorted_index.py) and both equal to the host function
graph/dbg.py Graph.nb_branching, which stays the path for k > 32, for a
graph built without a device and for a set that does not fit (`fits`).

A key x, taken as a forward k-mer, is a branching node when its in-degree
or its out-degree is not 1: of its 4 out-neighbours ((x << 2) | b) & mask
and its 4 in-neighbours (x >> 2) | (b << 2(k-1)), in canonical form, how
many are in the set.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import check_kernel_tensor, launch
from . import kmers as K
from . import sorted_index as SI

CHUNK = 1 << 20  # keys a step of the plain version


def neighbours(x: torch.Tensor, k: int) -> torch.Tensor:
    """The canonical neighbours of forward k-mers (u64 words in int64,
    k <= 32): (n, 8), the 4 out-neighbours, then the 4 in-neighbours, b = 0
    to 3 each. One reverse complement a key: rc(out_b x) = rc(x) >> 2 |
    comp(b) << 2(k-1), rc(in_b x) = (rc(x) << 2 & mask) | comp(b)."""
    mask = K.i64(K.kmer_mask(k))
    top = 2 * (k - 1)
    rc = K.revcomp_u64(x, k)
    out = [K.umin(((x << 2) | b) & mask, K.shr(rc, 2) | K.i64((b ^ 2) << top)) for b in range(4)]
    into = [K.umin(K.shr(x, 2) | K.i64(b << top), ((rc << 2) & mask) | (b ^ 2)) for b in range(4)]
    return torch.stack(out + into, dim=-1)


def _count_plain(keys: torch.Tensor, index: SI.SortedIndex, k: int) -> torch.Tensor:
    """Plain version of K17: the neighbours of CHUNK keys at a time, each
    looked up through the index as the kernel does (_lower_bound_plain,
    then equality). The count as one int64 on the keys' device."""
    n = keys.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=keys.device)
    for a in range(0, n, CHUNK):
        q = neighbours(keys[a:a + CHUNK], k)
        pos = SI._lower_bound_plain(keys, index, q.reshape(-1)).clamp_(max=n - 1)
        hit = (keys[pos] == q.reshape(-1)).reshape(q.shape)
        nb_out, nb_in = hit[:, :4].sum(1), hit[:, 4:].sum(1)
        total += ((nb_in != 1) | (nb_out != 1)).sum()
    return total


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import cuda_library

        lib = cuda_library("branching.cu", "libmtg_branching.so")
        lib.branching_launch.restype = ctypes.c_int
        lib.branching_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def branching_cuda(keys: torch.Tensor, index: SI.SortedIndex, k: int) -> torch.Tensor:
    """K17: the same count as _count_plain, one launch on the keys' card
    and stream, as one int64 on the card (no readback). Counts its launches
    in `branching_cuda.launches`."""
    check_kernel_tensor(keys, "keys", torch.int64, 1)
    n = keys.shape[0]
    if n >= 1 << 31 or not 1 <= k <= 32:
        raise ValueError(f"K17 takes fewer than 2^31 keys and 1 <= k <= 32, got {n} keys, k {k}")
    dev = keys.device
    out = torch.zeros((), dtype=torch.int64, device=dev)
    # an empty set's keys are never read: any valid address stands in for them
    launch("branching", _lib().branching_launch, keys.data_ptr() or out.data_ptr(), n, k,
           index.start.data_ptr(), index.head.data_ptr(), out.data_ptr(), device=dev)
    branching_cuda.launches += 1
    return out


branching_cuda.launches = 0


def fits(n: int, device: torch.device) -> bool:
    """Whether a set of n keys can be counted on `device`: fewer than 2^31
    keys (the index's starts are int32) and, on a card, room for the keys
    and their index in its free memory (torch's cached blocks included)."""
    if n >= 1 << 31:
        return False
    if device.type != "cuda":
        return True
    need = 8 * n + 4 * ((1 << SI.log_buckets(n)) + 1) + 4 * 8 + 8  # keys, starts, head, the count
    free, _total = torch.cuda.mem_get_info(device)
    return need <= free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def nb_branching(keys: torch.Tensor, k: int) -> int:
    """The branching nodes of sorted int64 u64 words taken as k-mers
    (k <= 32), on their device: the bucket index's build, then K17 on a
    CUDA tensor or its plain version on a CPU tensor; one scalar comes
    back."""
    index = SI.build(keys)
    return int((branching_cuda if keys.is_cuda else _count_plain)(keys, index, k))
