"""Mesh-sharded k-mer counting, `-count-engine sharded` (the counterpart of
mindthegap_tpu/parallel/sharded_count.py).

A flush of read bases is cut into one chunk a shard (C positions and a k-1
halo). Each shard computes its chunk's canonical k-mers and a bijective
swizzle of each (kernel K11, csrc/sharded_count.cu), sorts them by swizzle
(torch.sort), and slices the owner segments: the top log2(n) bits of the
swizzle name the owner shard, so each owner holds a disjoint shard of the
key space. The fixed-capacity segments are exchanged (each owner gets its
rows of every shard's buffers) and each owner sorts what it received. The
host merges each owner's sorted runs flush by flush; the sum of the
owners' histograms is the exact global histogram, and the result equals the
host StreamingCounter's.

In a run across processes the mesh is a GlobalMesh: every rank feeds the
same reads, each runs its block's chunks, the send buffers cross ranks by
an all_to_all, and every owner's sorted runs are gathered to every rank,
which merges every owner. The overflow flags are gathered first, so that
every rank takes the host route of a flush, or none does.

Swizzles travel biased (XOR 2^63), so that torch.sort's signed order is
their unsigned order and the all-ones SENTINEL of an invalid window (INT64_MAX
biased) sorts last. The swizzle constant is chosen so that mix^-1(2^64 - 1)
is not a canonical k-mer for this k: the SENTINEL never collides with a key.
On capacity overflow the flush takes the exact host route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_kernel_tensor, launch
from ..ops import kmers as K
from . import distributed as D
from . import mesh as M

_MASK64 = (1 << 64) - 1
_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

# candidate odd multipliers for the swizzle bijection (splitmix64 / xxhash /
# murmur finalizer constants)
_SWZ_CONSTS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0xFF51AFD7ED558CCD,
    0xC4CEB9FE1A85EC53,
    0xD6E8FEB86659FD93,
)


def _mix_int(x: int, c: int) -> int:
    x = (x ^ (x >> 33)) & _MASK64
    x = (x * c) & _MASK64
    return (x ^ (x >> 29)) & _MASK64


def _inv_xorshift(y: int, s: int) -> int:
    x = y
    while True:
        nx = y ^ (x >> s)
        if nx == x:
            return x
        x = nx


def _mix_inverse(y: int, c: int) -> int:
    y = _inv_xorshift(y, 29)
    y = (y * pow(c, -1, 1 << 64)) & _MASK64
    return _inv_xorshift(y, 33)


def pick_swizzle_const(k: int) -> int:
    """First mix constant whose preimage of 2^64-1 cannot be a canonical
    k-mer (canonical = min(fwd, revcomp), always < revcomp-of-itself when
    fwd is all-G, so specific values are checkable exactly)."""
    from ..ops.span import canonical_int

    for c in _SWZ_CONSTS:
        pre = _mix_inverse(_MASK64, c)
        if pre >= (1 << (2 * k)) or canonical_int(pre, k) != pre:
            return c
    raise AssertionError("no safe swizzle constant for k=%d" % k)


def _swizzle_keys_plain(codes: torch.Tensor, k: int, const: int):
    """Plain version of K11: (swizzles XOR 2^63, canonical k-mers) of every
    window of the chunk, (INT64_MAX, all ones) where a window holds an
    invalid base."""
    from ..find.scan_device import rolling_kmers

    fwd, valid = rolling_kmers(codes, k)
    canon = K.canonical_u64(fwd, k)
    swz = (canon ^ K.shr(canon, 33)) * K.i64(const)
    swz = swz ^ K.shr(swz, 29)
    return torch.where(valid, swz ^ K.SIGN_BIT, M.BIASED_SENTINEL), torch.where(valid, canon, -1)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import cuda_library

        lib = cuda_library("sharded_count.cu", "libmtg_sharded_count.so")
        lib.swizzle_keys_launch.restype = ctypes.c_int
        lib.swizzle_keys_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
                                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def swizzle_keys_cuda(codes: torch.Tensor, k: int, const: int):
    """K11 (csrc/sharded_count.cu): the same pair as _swizzle_keys_plain,
    each window read in constant work from a tile's codes staged as 2-bit
    codes and bad bits in shared memory. The codes must be 0, 1, 2, 3 or
    255 (invalid), as the encoders write them: the kernel keeps two bits of
    a valid code. Counts its launches in `swizzle_keys_cuda.launches`."""
    check_kernel_tensor(codes, "codes", torch.uint8, 1)
    n = codes.shape[0]
    if not 1 <= k <= 32 or n < k:
        raise ValueError(f"k must be in [1, 32] and at most the chunk, got k={k}, chunk={n}")
    swz = torch.empty(n - k + 1, dtype=torch.int64, device=codes.device)
    canon = torch.empty_like(swz)
    launch("swizzle_keys", _lib().swizzle_keys_launch,
           codes.data_ptr(), n, k, const, swz.data_ptr(), canon.data_ptr(),
           device=codes.device)
    swizzle_keys_cuda.launches += 1
    return swz, canon


swizzle_keys_cuda.launches = 0


def swizzle_keys(codes: torch.Tensor, k: int, const: int):
    """The routing keys of one shard's chunk of base codes (u8, 255 =
    invalid; k <= 32): (the swizzle of each window's canonical k-mer XOR
    2^63, the canonical k-mer), both int64[n - k + 1], (INT64_MAX, -1) for an
    invalid window. On a CUDA tensor this runs the kernel K11; on a CPU
    tensor its plain version."""
    fn = swizzle_keys_cuda if codes.is_cuda else _swizzle_keys_plain
    return fn(codes, k, const)


class ShardedStreamingCounter:
    """Drop-in for ops/counting.py StreamingCounter (k <= 32) with the
    per-base work sharded over a mesh (a list of devices, or a GlobalMesh
    across processes; a power of two of shards) and the k-mers routed to
    their owners. `host_flushes` lists, for each flush that took the host
    route, the shards whose segments overflowed."""

    def __init__(self, k: int, mesh, batch_bases: int = 1 << 23, slack: float = 1.10):
        assert k <= 32, "sharded counter: k <= 32 (host counter covers larger spans)"
        self.k = k
        self.mesh = M.as_global(mesh)
        self.n_dev = self.mesh.size
        if self.n_dev & (self.n_dev - 1):
            raise ValueError(f"the sharded counter needs a power of two of shards, got {self.n_dev}")
        self.host_flushes: list[list[int]] = []
        self._swz_const = pick_swizzle_const(k)

        # per-shard chunk of C owned positions (+ k-1 halo bases)
        self._C = max(-(-int(batch_bases) // self.n_dev), 4 * k)
        self._B = self._C * self.n_dev
        assert self._B >= 2 * k
        self._cap = int(self._C / self.n_dev * slack) + 64
        self._buf = np.full(self._B + k - 1, 255, np.uint8)
        self._fill = 0
        # per-owner running runs: (swz sorted, canon, counts)
        self._runs = [
            (np.zeros(0, np.uint64), np.zeros(0, np.uint64), np.zeros(0, np.int64))
            for _ in range(self.n_dev)
        ]

    def add_codes(self, codes: np.ndarray):
        codes = np.asarray(codes, np.uint8)
        pos = 0
        n = codes.size
        B = self._B + self.k - 1
        while True:
            take = min(n - pos, B - self._fill)
            self._buf[self._fill : self._fill + take] = codes[pos : pos + take]
            self._fill += take
            pos += take
            if pos >= n:
                if self._fill < B:
                    self._buf[self._fill] = 255  # read boundary
                    self._fill += 1
                else:
                    self._flush()
                return
            # buffer full mid-read: flush, rewind k-1 so split windows count once
            self._flush()
            pos = max(pos - (self.k - 1), 0)

    def _route(self):
        """The flush on the mesh: (each owner's received (swz, canon), sorted
        by swz (swz biased, on the host), in global owner order; the global
        indices of the shards whose segments overflowed). Across processes
        the received runs are None when any shard overflowed: the exchange
        is skipped on every rank alike."""
        C, k, n, cap = self._C, self.k, self.n_dev, self._cap
        gm = self.mesh
        sends, overflows = [], []
        for j, d in enumerate(gm.local):
            i = gm.offset + j
            chunk = torch.from_numpy(self._buf[i * C : (i + 1) * C + k - 1]).to(d)
            swz, canon = swizzle_keys(chunk, k, self._swz_const)
            swz, order = torch.sort(swz)
            (s, c), overflow = M.owner_segments(swz, [(swz, M.BIASED_SENTINEL), (canon[order], -1)], n, cap)
            sends.append((s, c))
            overflows.append(overflow)
        if gm.size == len(gm.local):
            received = [self._sorted(rs, rc) for rs, rc in zip(M.exchange([s for s, _ in sends], gm.local),
                                                               M.exchange([c for _, c in sends], gm.local))]
            return received, [i for i, o in enumerate(overflows) if bool(o)]
        flags = D.allgather_tensor(torch.tensor([bool(o) for o in overflows], dtype=torch.uint8)).flatten()
        overflowed = torch.nonzero(flags).flatten().tolist()
        if overflowed:
            return None, overflowed
        # [local shard, swz|canon, owner, cap] -> [rank, local shard, swz|canon, its owner, cap]
        L, W = len(gm.local), n // len(gm.local)
        send = torch.stack([torch.stack(sc).cpu() for sc in sends]).view(L, 2, W, L, cap)
        recv = D.all_to_all(send.permute(2, 0, 1, 3, 4))
        mine = []
        for o, d in enumerate(gm.local):
            # owner o's rows of every shard's buffers, in global shard order
            rs, rc = recv[:, :, :, o, :].permute(2, 0, 1, 3).reshape(2, n * cap).to(d)
            mine.append(torch.stack(self._sorted(rs, rc)))
        everyone = D.allgather_tensor(torch.stack(mine)).flatten(0, 1)
        return [(a, b) for a, b in everyone], []

    @staticmethod
    def _sorted(rs: torch.Tensor, rc: torch.Tensor):
        """One owner's received (swz, canon), sorted by swz, on the host."""
        rs, order = torch.sort(rs)
        return rs.cpu(), rc[order].cpu()

    def _flush(self):
        if self._fill == 0:
            return
        self._buf[self._fill :] = 255
        received, overflowed = self._route()
        if overflowed:
            self.host_flushes.append(overflowed)
            self._flush_host_fallback()
        else:
            for d, (rs, rc) in enumerate(received):
                self._merge_owner(d, K.as_u64(rs ^ K.SIGN_BIT), K.as_u64(rc))
        self._fill = 0
        self._buf[:] = 255

    def _flush_host_fallback(self):
        """Exact host-side routing of one flush (only on capacity overflow)."""
        fwd, valid = K.kmers_from_codes(self._buf, self.k)
        canon = K.canonical_u64(fwd[valid], self.k)
        c = np.uint64(self._swz_const)
        swz = (canon ^ (canon >> np.uint64(33))) * c
        swz = swz ^ (swz >> np.uint64(29))
        order = np.argsort(swz)
        swz, canon = swz[order], canon[order]
        log_n = self.n_dev.bit_length() - 1
        owner = (swz >> np.uint64(64 - log_n)).astype(np.int64) if log_n else np.zeros(swz.size, np.int64)
        for d in range(self.n_dev):
            m = owner == d
            self._merge_owner(d, swz[m], canon[m])

    def _merge_owner(self, d: int, swz: np.ndarray, canon: np.ndarray):
        n_real = int(np.searchsorted(swz, _SENTINEL))
        swz, canon = swz[:n_real], canon[:n_real]
        if swz.size == 0:
            return
        newrun = np.empty(swz.size, bool)
        newrun[0] = True
        newrun[1:] = swz[1:] != swz[:-1]
        idx = np.flatnonzero(newrun)
        u_swz, u_canon = swz[idx], canon[idx]
        u_cnt = np.diff(idx, append=swz.size).astype(np.int64)

        a_swz, a_canon, a_cnt = self._runs[d]
        if a_swz.size == 0:
            self._runs[d] = (u_swz, u_canon, u_cnt)
            return
        m_swz = np.concatenate([a_swz, u_swz])
        m_canon = np.concatenate([a_canon, u_canon])
        m_cnt = np.concatenate([a_cnt, u_cnt])
        order = np.argsort(m_swz, kind="stable")
        m_swz, m_canon, m_cnt = m_swz[order], m_canon[order], m_cnt[order]
        uniq = np.empty(m_swz.size, bool)
        uniq[0] = True
        uniq[1:] = m_swz[1:] != m_swz[:-1]
        gid = np.cumsum(uniq) - 1
        out_cnt = np.zeros(int(gid[-1]) + 1, np.int64)
        np.add.at(out_cnt, gid, m_cnt)
        self._runs[d] = (m_swz[uniq], m_canon[uniq], out_cnt)

    def result(self):
        from ..ops.counting import HISTOGRAM_MAX, CountResult

        self._flush()
        hists = np.zeros((self.n_dev, HISTOGRAM_MAX + 1), np.int64)
        for d in range(self.n_dev):
            cnt = self._runs[d][2]
            np.add.at(hists[d], np.minimum(cnt, HISTOGRAM_MAX), 1)
        hist = hists.sum(axis=0)  # owners are disjoint key shards: the exact global histogram

        canon_all = np.concatenate([r[1] for r in self._runs])
        cnt_all = np.concatenate([r[2] for r in self._runs])
        order = np.argsort(canon_all)
        return CountResult(canon_all[order], cnt_all[order], hist, self.k)
