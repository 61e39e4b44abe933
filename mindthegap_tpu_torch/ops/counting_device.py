"""Device-side canonical k-mer counting (the DSK equivalent's hot half), on
int64 tensors; the counterpart of mindthegap_tpu/ops/counting_device.py.

Graph build is the reference's #1 hot loop (DSK counting over all reads).
The host counter (ops/counting.py StreamingCounter) extracts and sorts on
the CPU; this path moves the per-base work onto the device, batch by batch:

  2-bit packed codes + bad bits (reads joined by 255 separators)
    -> forward k-mers, canonical min(fwd, revcomp), invalid -> SENTINEL  [K3]
    -> sort                                                       [torch.sort]
    -> merge into the device-resident distinct accumulator, folding
       duplicates while merging                                          [K4]

Keys on the device are BIASED words: the u64 k-mer XOR 2^63 held in int64,
so that signed order (torch.sort, int64 compares) is unsigned k-mer order
and SENTINEL (all ones: an invalid window) becomes INT64_MAX and sorts
last. sort_batch writes them, merge_sorted keeps them, and result() and
count_batch remove the bias. Counts are int64.

On a CUDA tensor sort_batch runs the hand kernel K3 (csrc/count_kmers.cu)
and merge_sorted runs K4 (csrc/count_merge.cu, a single-pass tiled merge);
on a CPU tensor each runs its plain PyTorch version below.

k <= 32 (u64 words). Larger spans use the host counter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_kernel_tensor, launch
from ..find.scan_device import pack_codes_host, rolling_kmers, unpack_codes
from ..utils.phases import count, span
from . import kmers as K

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
SEP = 255  # read separator / invalid base code
BIASED_SENTINEL = (1 << 63) - 1  # SENTINEL ^ 2^63 as int64

_EXC_CAP = 1 << 15  # fixed exception capacity (count > 255 per distinct kmer)


def _unbias(keys: torch.Tensor) -> np.ndarray:
    """Biased device keys -> host u64 k-mers."""
    return K.as_u64(keys ^ K.SIGN_BIT)


class DeviceStreamingCounter:
    """Drop-in for ops/counting.py StreamingCounter (k <= 32): base codes
    are joined with separators into fixed-size staging buffers; each flush
    uploads its buffer 2-bit packed (+ bad bits: 0.375 B/base), sorts it on
    the device (sort_batch) and MERGES the raw sorted stream into a
    device-resident accumulator (merge_sorted). Nothing but one scalar per
    flush (the running distinct count: the capacity-overflow check) crosses
    back to the host until result().

    The upload is a pageable copy of arrays that pack_codes_host makes
    afresh for each flush, so it is synchronous and no kernel ever reads a
    staging buffer; the two buffers are kept, used alternately, and a
    buffer is refilled only after the flush that read it has been synced,
    as in the JAX counter."""

    def __init__(self, k: int, device, batch_bases: int = 1 << 23, init_cap: int = 1 << 20):
        if k > 32:
            raise ValueError("device counter: k <= 32 (the host counter covers larger spans)")
        self.k = k
        self.device = torch.device(device)
        self._batch = int(batch_bases) & ~7  # pack_codes_host needs n % 8 == 0
        # the mid-read flush rewinds k-1 bases; the per-iteration advance must
        # exceed the rewind or add_codes never progresses
        if self._batch < 2 * k:
            raise ValueError("batch_bases must be >= 2*k")
        self._bufs = [np.full(self._batch, SEP, np.uint8) for _ in range(2)]
        self._cur = 0
        self._fill = 0
        self._cap = int(init_cap)
        self._acc = None  # (biased keys[cap], counts[cap]) sorted distinct
        self._acc_n = 0
        self._pending = None  # (acc_prev, batch, merge result, cap)

    def add_codes(self, codes: np.ndarray):
        codes = np.asarray(codes, np.uint8)
        n = codes.size
        fill = self._fill
        if n + 1 <= self._batch - fill:  # whole read fits: no loop, no min()
            buf = self._bufs[self._cur]
            buf[fill : fill + n] = codes
            buf[fill + n] = SEP
            self._fill = fill + n + 1
            return
        pos = 0
        while True:
            take = min(n - pos, self._batch - self._fill)
            self._buf[self._fill : self._fill + take] = codes[pos : pos + take]
            self._fill += take
            pos += take
            if pos >= n:
                if self._fill < self._batch:
                    self._buf[self._fill] = SEP  # read boundary
                    self._fill += 1
                else:
                    self._flush()
                return
            # buffer full mid-read: flush, then rewind k-1 bases so the
            # windows spanning the split are counted exactly once
            self._flush()
            pos = max(pos - (self.k - 1), 0)

    @property
    def _buf(self):
        return self._bufs[self._cur]

    def _flush(self):
        if self._fill == 0:
            return
        buf = self._bufs[self._cur]
        buf[self._fill :] = SEP
        # the final flush (the only partial one) runs at the next power of
        # two of the fill, floor 2^17, instead of the full batch
        blen = self._batch
        if self._fill < self._batch:
            blen = min(max(1 << 17, 1 << (self._fill - 1).bit_length()), self._batch)
        with span("flush"):
            packed, bad = pack_codes_host(buf[:blen])
            b = sort_batch(torch.from_numpy(packed).to(self.device),
                           torch.from_numpy(bad).to(self.device), self.k)
            count("flushes", 1)
            count("bytes uploaded", packed.nbytes + bad.nbytes)
            # sync the PREVIOUS flush while the device starts on this batch
            prev, self._pending = self._pending, None
            if prev is not None:
                self._sync(prev)
            if self._acc is None:
                self._acc = (
                    torch.full((self._cap,), BIASED_SENTINEL, dtype=torch.int64, device=self.device),
                    torch.zeros(self._cap, dtype=torch.int64, device=self.device),
                )
            # merge only the occupied prefix of the accumulator, at a
            # power-of-two length (floor 2^17)
            alen = int(self._acc[0].shape[0])
            m_pad = min(1 << max(0, (max(self._acc_n, 1) - 1).bit_length(), 17), alen)
            m = merge_sorted(self._acc[0][:m_pad], self._acc[1][:m_pad], b, self._cap)
            self._pending = (self._acc, b, m, self._cap)
            self._acc = (m[0], m[1])
            self._cur ^= 1
            self._fill = 0
            self._bufs[self._cur][:] = SEP

    def _sync(self, prev):
        acc_prev, b, m, cap = prev
        with span("wait"):
            nd = int(m[2])
        if nd > cap:
            # capacity overflow: the truncated merge is wrong; grow and redo
            # from the kept inputs (both still alive on the device)
            count("merge regrowths", 1)
            while nd > self._cap:
                self._cap *= 2
            m = merge_sorted(acc_prev[0], acc_prev[1], b, self._cap)
            self._acc = (m[0], m[1])
            nd = int(m[2])
        self._acc_n = nd

    def result(self):
        from .counting import HISTOGRAM_MAX, CountResult

        self._flush()
        with span("readback"):
            if self._pending is not None:
                self._sync(self._pending)
                self._pending = None
            if self._acc is None:
                return CountResult(
                    np.zeros(0, np.uint64), np.zeros(0, np.int64),
                    np.zeros(HISTOGRAM_MAX + 1, np.int64), self.k,
                )
            n = self._acc_n
            # read back a 2^17-granular prefix
            gran = 1 << 17
            n_pad = min(-(-max(n, 1) // gran) * gran, int(self._acc[0].shape[0]))
            # counts come back as clamped u8 + a compacted exception list
            # (count > 255): 1 B per distinct k-mer instead of 8
            c8, eidx, evals, n_exc_d = pack_counts(self._acc[1][:n_pad], _EXC_CAP)
            keys = _unbias(self._acc[0][:n_pad])[:n]
            n_exc = int(n_exc_d)
            back = 8 * n_pad + n_exc_d.element_size()
            if n_exc <= _EXC_CAP:
                counts = c8.cpu().numpy()[:n].astype(np.int64)
                back += n_pad
                if n_exc:
                    m = min(1 << (n_exc - 1).bit_length(), _EXC_CAP)  # pow2 slice
                    ei = eidx[:m].cpu().numpy()[:n_exc]
                    counts[ei] = evals[:m].cpu().numpy()[:n_exc]
                    back += m * (eidx.element_size() + evals.element_size())
            else:  # more exceptions than the fixed cap: full-width readback
                counts = self._acc[1][:n_pad].cpu().numpy()[:n].astype(np.int64)
                back += 8 * n_pad
            count("distinct k-mers", n)
            count("bytes read back", back)
        hist = np.zeros(HISTOGRAM_MAX + 1, np.int64)
        np.add.at(hist, np.minimum(counts, HISTOGRAM_MAX), 1)
        return CountResult(keys, counts, hist, self.k)


def pack_counts(counts: torch.Tensor, exc_cap: int):
    """Pack int64 per-distinct counts for the device->host boundary: clamped
    u8 counts + a compacted (index, value) list of the entries over 255, in
    index order (the other entries follow, in index order). Returns (c8
    u8[n], exc_idx i32[exc_cap], exc_val i64[exc_cap], n_exc i32); n_exc >
    exc_cap means the list is truncated and the caller must read the counts
    at full width."""
    n = counts.shape[0]
    over = counts > 255
    n_exc = over.sum(dtype=torch.int32)
    c8 = counts.clamp(max=255).to(torch.uint8)
    order = torch.argsort((~over).to(torch.uint8), stable=True)
    idx_c = order.to(torch.int32)
    val_c = counts[order]
    pad = max(exc_cap - n, 0)
    if pad:
        idx_c = torch.cat([idx_c, idx_c.new_zeros(pad)])
        val_c = torch.cat([val_c, val_c.new_zeros(pad)])
    return c8, idx_c[:exc_cap], val_c[:exc_cap], n_exc


# ---------------------------------------------------------------------------
# K3: extract + canonicalize (the per-base part of sort_batch)

def _kmer_keys_plain(packed: torch.Tensor, bad: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K3: biased canonical k-mer of every window of the
    packed batch (BIASED_SENTINEL where a window holds a bad base); length
    blen - k + 1, as rolling_kmers."""
    fwd, valid = rolling_kmers(unpack_codes(packed, bad), k)
    return torch.where(valid, K.canonical_u64(fwd, k) ^ K.SIGN_BIT, BIASED_SENTINEL)


_KEYS_LIB = None


def _keys_lib():
    global _KEYS_LIB
    if _KEYS_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("count_kmers.cu", "libmtg_count_kmers.so")
        lib.kmer_keys_launch.restype = ctypes.c_int
        lib.kmer_keys_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _KEYS_LIB = lib
    return _KEYS_LIB


def kmer_keys_cuda(packed: torch.Tensor, bad: torch.Tensor, k: int) -> torch.Tensor:
    """K3 (csrc/count_kmers.cu): the same keys as _kmer_keys_plain, in
    tiles of 2,048 windows staged in shared memory, each window formed from
    two words by funnel shifts. Counts its launches in
    `kmer_keys_cuda.launches`."""
    check_kernel_tensor(packed, "packed", torch.uint8, 1)
    check_kernel_tensor(bad, "bad", torch.uint8, 1)
    w = packed.shape[0] * 4
    if bad.shape[0] * 8 != w:
        raise ValueError("bad must hold one bit per base of packed (batch % 8 == 0)")
    if not 1 <= k <= 32 or w < k:
        raise ValueError(f"k must be in [1, 32] and at most the batch, got k={k}, batch={w}")
    out = torch.empty(w - k + 1, dtype=torch.int64, device=packed.device)
    launch("kmer_keys", _keys_lib().kmer_keys_launch,
           packed.data_ptr(), bad.data_ptr(), w, k, out.data_ptr(),
           device=packed.device)
    kmer_keys_cuda.launches += 1
    return out


kmer_keys_cuda.launches = 0


def sort_batch(packed: torch.Tensor, bad: torch.Tensor, k: int) -> torch.Tensor:
    """Extract + canonicalize + sort one packed batch, no run-length pass:
    the raw sorted stream of biased keys (BIASED_SENTINEL for invalid
    windows, last) feeds merge_sorted, which folds the duplicates."""
    keys = (kmer_keys_cuda if packed.is_cuda else _kmer_keys_plain)(packed, bad, k)
    return torch.sort(keys).values


# ---------------------------------------------------------------------------
# K4: merge + fold (merge_sorted)

def _merge_sorted_plain(acc_keys, acc_counts, batch_sorted, out_cap: int):
    """Plain version of K4: sort the concatenation, flag run starts, sum each
    run by exclusive-prefix differences, compact the starts."""
    keys = torch.cat([acc_keys, batch_sorted])
    cnts = torch.cat([acc_counts, (batch_sorted != BIASED_SENTINEL).to(torch.int64)])
    keys, order = torch.sort(keys, stable=True)
    cnts = cnts[order]
    newrun = torch.ones_like(keys, dtype=torch.bool)
    newrun[1:] = keys[1:] != keys[:-1]
    newrun &= keys != BIASED_SENTINEL
    n_distinct = newrun.sum(dtype=torch.int32)
    s = torch.cumsum(cnts, 0)
    sprev = s - cnts  # exclusive prefix (sentinels contribute 0)
    starts = torch.nonzero(newrun).squeeze(1)
    sprev_c = sprev[starts]
    csum = torch.cat([sprev_c[1:], s[-1:]]) - sprev_c
    m = min(out_cap, starts.shape[0])
    keys_out = torch.full((out_cap,), BIASED_SENTINEL, dtype=torch.int64, device=keys.device)
    counts_out = torch.zeros(out_cap, dtype=torch.int64, device=keys.device)
    keys_out[:m] = keys[starts[:m]]
    counts_out[:m] = csum[:m]
    return keys_out, counts_out, n_distinct


_MERGE_LIB = None


def _merge_lib():
    global _MERGE_LIB
    if _MERGE_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("count_merge.cu", "libmtg_count_merge.so")
        lib.merge_tile_size.restype = ctypes.c_int
        lib.merge_tile_size.argtypes = []
        lib.merge_fold_launch.restype = ctypes.c_int
        lib.merge_fold_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _MERGE_LIB = lib
    return _MERGE_LIB


def merge_sorted_cuda(acc_keys, acc_counts, batch_sorted, out_cap: int):
    """K4 (csrc/count_merge.cu): the same (keys, counts, n_distinct) as
    _merge_sorted_plain, in one pass over the merged stream: tiles merged
    in shared memory, run starts and run totals joined across tiles by a
    decoupled look-back, outputs written once (around it, a small pass
    splits the merge path at the tile boundaries and one pads past
    n_distinct). Counts its launches in `merge_sorted_cuda.launches`."""
    check_kernel_tensor(acc_keys, "acc_keys", torch.int64, 1)
    check_kernel_tensor(acc_counts, "acc_counts", torch.int64, 1)
    check_kernel_tensor(batch_sorted, "batch_sorted", torch.int64, 1)
    na, nb = acc_keys.shape[0], batch_sorted.shape[0]
    if acc_counts.shape[0] != na:
        raise ValueError("acc_keys and acc_counts must have the same length")
    if na + nb == 0 or out_cap < 1:
        raise ValueError("merge_sorted needs at least one input element and out_cap >= 1")
    dev = acc_keys.device
    lib = _merge_lib()
    n_tiles = -(-(na + nb) // lib.merge_tile_size())
    # look-back values (4 int64 words per tile) and the tile boundaries'
    # splits, then an int32 flag per tile and the tile counter (zeroed by
    # the launch)
    scratch = torch.empty(5 * n_tiles + 1 + (n_tiles + 2) // 2, dtype=torch.int64, device=dev)
    keys_out = torch.empty(out_cap, dtype=torch.int64, device=dev)
    counts_out = torch.empty(out_cap, dtype=torch.int64, device=dev)
    n_distinct = torch.empty((), dtype=torch.int32, device=dev)
    launch("merge_fold", lib.merge_fold_launch,
           acc_keys.data_ptr(), acc_counts.data_ptr(), na,
           batch_sorted.data_ptr(), nb,
           keys_out.data_ptr(), counts_out.data_ptr(), n_distinct.data_ptr(), out_cap,
           scratch.data_ptr(),
           device=dev)
    merge_sorted_cuda.launches += 1
    return keys_out, counts_out, n_distinct


merge_sorted_cuda.launches = 0


def merge_sorted(acc_keys, acc_counts, batch_sorted, out_cap: int):
    """Merge the distinct accumulator (biased keys + int64 counts,
    BIASED_SENTINEL-padded) with a RAW sorted batch stream (duplicates
    allowed, each live key counts 1). Returns (keys[out_cap],
    counts[out_cap], n_distinct: 0-d int32 on the device): the first
    out_cap distinct keys in order with their summed counts, then
    BIASED_SENTINEL / 0. n_distinct > out_cap means truncated: the caller
    grows and re-runs from the kept inputs."""
    fn = merge_sorted_cuda if acc_keys.is_cuda else _merge_sorted_plain
    return fn(acc_keys, acc_counts, batch_sorted, out_cap)


def count_batch(codes: torch.Tensor, k: int):
    """One-shot count of a code array (u8, 255 = separator/invalid), plain
    PyTorch from the same pieces: extract + canonicalize + sort, then the
    merge's run fold into an empty accumulator. Returns (keys int64[P] u64
    words, distinct keys first then SENTINEL; counts i32[P]; n_distinct
    i32), P = len(codes) - k + 1."""
    fwd, valid = rolling_kmers(codes, k)
    keys = torch.sort(torch.where(valid, K.canonical_u64(fwd, k) ^ K.SIGN_BIT, BIASED_SENTINEL)).values
    empty = keys[:0]
    out, counts, n_distinct = _merge_sorted_plain(empty, empty, keys, keys.shape[0])
    return out ^ K.SIGN_BIT, counts.to(torch.int32), n_distinct
