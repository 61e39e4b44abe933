"""Sharded exact membership with a Bloom prefilter and owner routing (the
counterpart of mindthegap_tpu/parallel/sharded_membership.py).

When the replicated scan map would not fit one device, the solid set is
sharded by contiguous key range over the mesh (sorted, so each shard stays
binary-searchable) and a small replicated Bloom filter (ops/bloom.py, 12
bits a key) prefilters the queries:

  1. each shard probes the Bloom filter for its query lanes (negatives are
     exact and answered absent) and routes each positive, with its lane, to
     the owner shard of its key range, into fixed-capacity send buffers
     (kernel K12, csrc/sharded_member.cu);
  2. the buffers are exchanged (each owner gets its rows of every shard's);
  3. the owner looks each query up in its sorted shard (kernel K13,
     through the shard's bucket index, ops/sorted_index.py; Bloom false
     positives die here);
  4. the verdicts go back the same way and are scattered into lane order
     (K13's scatter).

Keys are u64 words held in int64; the all-ones SENTINEL that pads the key
shards sorts last in the unsigned order every compare uses. On capacity
overflow the batch takes the exact host route.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..device import check_kernel_tensor, launch
from ..ops import bloom
from ..ops import kmers as K
from ..ops import sorted_index as SI
from . import mesh as M

_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _route_plain(queries, bits, log_bits: int, n_hash: int, bounds, n: int, cap: int):
    """Plain version of K12: (send_q int64[n * cap], send_lane int32[n * cap],
    overflow int32[1]): per owner, its Bloom-positive queries and their
    lanes in ascending lane order, padded with (SENTINEL, -1)."""
    dev = queries.device
    lanes = queries.shape[0]
    positive = bloom.contains_tensor(bits, log_bits, n_hash, queries)
    owner = torch.searchsorted(bounds ^ K.SIGN_BIT, queries ^ K.SIGN_BIT, right=True) - 1
    owner = torch.where(positive, owner.clamp(0, n - 1), n)
    owner_s, order = torch.sort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(lanes, device=dev) - starts[owner_s]
    keep = (owner_s < n) & (rank < cap)
    slot = owner_s[keep] * cap + rank[keep]
    send_q = torch.full((n * cap,), -1, dtype=torch.int64, device=dev)
    send_lane = torch.full((n * cap,), -1, dtype=torch.int32, device=dev)
    send_q[slot] = queries[order[keep]]
    send_lane[slot] = order[keep].to(torch.int32)
    overflow = (counts[:n] > cap).any().to(torch.int32).reshape(1)
    return send_q, send_lane, overflow


def _probe_plain(recv, keys):
    """Plain version of K13's probe: whether each received query is in the
    shard's sorted keys, as bytes."""
    idx = torch.searchsorted(keys ^ K.SIGN_BIT, recv ^ K.SIGN_BIT).clamp(max=keys.shape[0] - 1)
    return (keys[idx] == recv).to(torch.uint8)


def _scatter_plain(back, send_lane, lanes: int):
    """Plain version of K13's scatter: the verdicts in slot order written to
    their lanes (padding slots, lane -1, write nothing)."""
    out = torch.zeros(lanes, dtype=torch.bool, device=back.device)
    real = send_lane >= 0
    out[send_lane[real].long()] = back[real] != 0
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import cuda_library

        lib = cuda_library("sharded_member.cu", "libmtg_sharded_member.so")
        lib.member_route_launch.restype = ctypes.c_int
        lib.member_route_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, *[ctypes.c_void_p] * 5,
        ]
        lib.member_route_tile.restype = ctypes.c_int
        lib.member_route_tile.argtypes = []
        lib.member_probe_launch.restype = ctypes.c_int
        lib.member_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                            *[ctypes.c_void_p] * 4]
        lib.member_scatter_launch.restype = ctypes.c_int
        lib.member_scatter_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                              ctypes.c_void_p]
        _LIB = lib
    return _LIB


def member_route_cuda(queries, bits, log_bits: int, n_hash: int, bounds, n: int, cap: int):
    """K12 (csrc/sharded_member.cu): the same send buffers and overflow flag
    as _route_plain, in one pass over the lanes after the buffers are
    filled with their padding (tiles of lanes ranked per owner, joined by a
    decoupled look-back; a hash a round of every live lane's Bloom probes in
    flight). Counts one launch per call in `member_route_cuda.launches`."""
    check_kernel_tensor(queries, "queries", torch.int64, 1)
    check_kernel_tensor(bits, "bits", torch.int32, 1)
    check_kernel_tensor(bounds, "bounds", torch.int64, 1)
    lanes = queries.shape[0]
    if not 1 <= n <= 64 or bounds.shape[0] != n or bits.shape[0] != 1 << (log_bits - 5) or lanes < 1 or cap < 1:
        raise ValueError(f"K12 takes 1..64 shards with a bound each, 2^(log_bits-5) bitset words, lanes and "
                         f"cap >= 1; got n={n}, bounds {bounds.shape[0]}, bits {bits.shape[0]} at "
                         f"log_bits {log_bits}, lanes {lanes}, cap {cap}")
    dev = queries.device
    lib = _lib()
    states = torch.empty(-(-lanes // lib.member_route_tile()) * n + 1, dtype=torch.int64, device=dev)
    send_q = torch.empty(n * cap, dtype=torch.int64, device=dev)
    send_lane = torch.empty(n * cap, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    launch("member_route", lib.member_route_launch,
           queries.data_ptr(), lanes, bits.data_ptr(), log_bits, n_hash, bounds.data_ptr(), n, cap,
           send_q.data_ptr(), send_lane.data_ptr(), overflow.data_ptr(), states.data_ptr(),
           device=queries.device)
    member_route_cuda.launches += 1
    return send_q, send_lane, overflow


member_route_cuda.launches = 0


def member_probe_cuda(recv, keys, index: SI.SortedIndex | None = None):
    """K13's probe (csrc/sharded_member.cu): the same bytes as _probe_plain,
    through the shard's bucket index (ops/sorted_index.py; built here, by
    its build kernel, when the caller has none), 4 received queries a
    thread, the padding answered without a lookup. Counts its launches in
    `member_probe_cuda.launches`."""
    check_kernel_tensor(recv, "recv", torch.int64, 1)
    check_kernel_tensor(keys, "keys", torch.int64, 1)
    if keys.shape[0] < 1 or recv.shape[0] < 1:
        raise ValueError("K13 probes at least one query in a shard of at least one key")
    if index is None:
        index = SI.build(keys)
    found = torch.empty(recv.shape[0], dtype=torch.uint8, device=recv.device)
    launch("member_probe", _lib().member_probe_launch,
           recv.data_ptr(), recv.shape[0], keys.data_ptr(), keys.shape[0], index.start.data_ptr(),
           index.head.data_ptr(), found.data_ptr(),
           device=recv.device)
    member_probe_cuda.launches += 1
    return found


member_probe_cuda.launches = 0


def member_scatter_cuda(back, send_lane, lanes: int):
    """K13's scatter (csrc/sharded_member.cu): the same lanes as
    _scatter_plain, a thread a slot. Counts its launches in
    `member_scatter_cuda.launches`."""
    check_kernel_tensor(back, "back", torch.uint8, 1)
    check_kernel_tensor(send_lane, "send_lane", torch.int32, 1)
    if back.shape != send_lane.shape or back.shape[0] < 1:
        raise ValueError("K13's scatter takes a lane for each of at least one verdict")
    out = torch.zeros(lanes, dtype=torch.bool, device=back.device)
    launch("member_scatter", _lib().member_scatter_launch,
           back.data_ptr(), send_lane.data_ptr(), back.shape[0], out.data_ptr(),
           device=back.device)
    member_scatter_cuda.launches += 1
    return out


member_scatter_cuda.launches = 0


def route(queries, bits, log_bits: int, n_hash: int, bounds, n: int, cap: int):
    """One shard's routing of its query lanes (int64 u64 keys) to their
    owners: the Bloom filter (bits: uint32 words as int32), the owners' first
    keys (bounds, int64[n]) and the capacity cap. Returns (send_q int64[n *
    cap], send_lane int32[n * cap], overflow int32[1]). On a CUDA tensor
    this runs the kernel K12; on a CPU tensor its plain version."""
    fn = member_route_cuda if queries.is_cuda else _route_plain
    return fn(queries, bits, log_bits, n_hash, bounds, n, cap)


def probe(recv, keys, index: SI.SortedIndex | None = None):
    """The owner's verdicts (uint8) on its received queries, over its sorted
    shard and, on the card, the shard's bucket index. On a CUDA tensor this
    runs K13's probe; on a CPU tensor its plain version."""
    return member_probe_cuda(recv, keys, index) if recv.is_cuda else _probe_plain(recv, keys)


def scatter(back, send_lane, lanes: int):
    """The verdicts that came back (slot order) as bools in lane order. On a
    CUDA tensor this runs K13's scatter; on a CPU tensor its plain version."""
    return (member_scatter_cuda if back.is_cuda else _scatter_plain)(back, send_lane, lanes)


class ShardedMembership:
    """A sorted canonical key set sharded by key range over a mesh (a list
    of devices, mesh.py), with the Bloom prefilter on every device.
    `contains(keys)` is exact."""

    def __init__(self, mesh: list, sorted_keys: np.ndarray, bits_per_key: int = 12, cap_factor: float = 1.25):
        self.mesh = mesh
        self.n_dev = len(mesh)
        keys = np.ascontiguousarray(sorted_keys, np.uint64)
        n = keys.size
        # pad so the key plane splits evenly; the sentinel never matches a
        # canonical k-mer (canonical < revcomp(all-G) for every k <= 32)
        per = -(-max(n, self.n_dev) // self.n_dev)
        padded = np.full(per * self.n_dev, _SENTINEL, np.uint64)
        padded[:n] = keys
        # first key of each shard: owner(q) = #boundaries <= q - 1
        self._bounds = padded[::per].copy()
        self._cap_factor = cap_factor
        self._host_keys = padded
        bf = bloom.build(keys if n else np.zeros(1, np.uint64), bits_per_key)
        self._bloom_log = bf.log_bits
        self._bloom_nh = bf.n_hash
        self.shard_keys = [torch.from_numpy(K.as_i64(padded[j * per : (j + 1) * per])).to(d)
                           for j, d in enumerate(mesh)]
        # each owner's bucket index on its own card, for K13 (the plain probe needs none)
        self.shard_index = [SI.build(t) if t.is_cuda else None for t in self.shard_keys]
        self._replicated = M.per_device(mesh, lambda d: (torch.from_numpy(bf.bits.view(np.int32)).to(d),
                                                          torch.from_numpy(K.as_i64(self._bounds)).to(d)))

    def batch(self, keys: np.ndarray):
        """The query rows of a batch: ([n_shards, lanes] u64, the keys then
        the SENTINEL; lanes a power of two >= 64) and the capacity per owner."""
        n = self.n_dev
        lanes = max(64, 1 << math.ceil(math.log2(-(-keys.size // n))))
        rows = np.full((n, lanes), _SENTINEL, np.uint64)
        rows.reshape(-1)[: keys.size] = keys
        return rows, int(lanes * self._cap_factor / n) + 64

    def route_args(self, j: int, rows: np.ndarray, cap: int):
        """The arguments of route for shard j's rows, on its device."""
        bits, bounds = self._replicated[j]
        return (torch.from_numpy(K.as_i64(rows[j])).to(self.mesh[j]), bits, self._bloom_log, self._bloom_nh,
                bounds, self.n_dev, cap)

    def contains(self, keys: np.ndarray) -> np.ndarray:
        """Exact vectorized membership for a host batch of canonical keys."""
        keys = np.asarray(keys, np.uint64)
        nq = keys.size
        if nq == 0:
            return np.zeros(0, bool)
        n = self.n_dev
        rows, cap = self.batch(keys)
        lanes = rows.shape[1]
        routed = [route(*self.route_args(j, rows, cap)) for j in range(n)]
        found = [probe(recv, self.shard_keys[o], self.shard_index[o]).reshape(n, cap)
                 for o, recv in enumerate(M.exchange([r[0].reshape(n, cap) for r in routed], self.mesh))]
        back = M.exchange(found, self.mesh)
        out = [scatter(back[d], routed[d][1], lanes).cpu() for d in range(n)]
        if any(int(r[2].item()) for r in routed):
            # exact host route for this batch
            idx = np.minimum(np.searchsorted(self._host_keys, keys), self._host_keys.size - 1)
            return self._host_keys[idx] == keys
        return torch.cat(out).numpy()[:nq]
