"""Canonical k-mer counting (the DSK equivalent) and abundance auto-cutoff.

The reference delegates counting to GATB-core's SortingCountAlgorithm
(call site src/FindBreakpoints.hpp:965-979; configured in src/Finder.cpp:226-263
with solidity "sum" over multiple banks). Behavior replicated here:

- k-mers are canonical (min of forward / revcomp in the A=0,C=1,T=2,G=3 order);
- k-mers containing non-ACGT bases are skipped;
- counts from multiple input banks are summed ("sum" solidity);
- solid set = canonical k-mers with  abundance_min <= total count
  (abundance_max bound applied too);
- "-abundance-min auto" derives the threshold from the abundance histogram
  with a hard floor of 3 (STR_KMER_ABUNDANCE_MIN_THRESHOLD, Finder.cpp:255).

The counting core is a sort + segmented-reduce on the host; the device
counter (-count-engine device) is ops/counting_device.py.

Calibration note (gatb-core submodule is absent upstream): on the reference's
own data/ the semantics above reproduce the gold numbers exactly —
full_test reads at cutoff 7 -> 7419 solid kmers (test/full_test/gold_find.output),
contig reads at cutoff 3 -> 10194 (test/contig_test/gold.log); the auto-cutoff
below yields 7 on the full_test histogram as recorded in the gold output.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import kmers as K

HISTOGRAM_MAX = 10000  # STR_HISTOGRAM_MAX (Finder.cpp:254)
MIN_AUTO_THRESHOLD = 3  # STR_KMER_ABUNDANCE_MIN_THRESHOLD (Finder.cpp:255)


@dataclass
class CountResult:
    kmers: np.ndarray  # sorted unique canonical kmers, uint64 [N]
    counts: np.ndarray  # total counts, int64 [N]
    histogram: np.ndarray  # histogram[c] = #distinct kmers with count c, len HISTOGRAM_MAX+1
    k: int = 0


class StreamingCounter:
    """Accumulates canonical k-mer counts over batches of sequences.

    Keeps a sorted (keys, counts) pair merged batch by batch — the same
    merge structure a multi-chip build uses (per-chip sort + all-merge).
    For k <= 32 keys are uint64; for larger spans they are multi-word
    big-endian void keys (ops/span.py) with identical ordering semantics.
    """

    def __init__(self, k: int, batch_kmers: int = 1 << 24):
        self.k = k
        self.span = None
        if k > 32:
            from .span import Span

            self.span = Span(k)
            empty = self.span.keys(np.zeros((0, self.span.W), np.uint64))
        else:
            empty = np.zeros(0, np.uint64)
        self._sorted = empty
        self._counts = np.zeros(0, np.int64)
        self._pending: list[np.ndarray] = []
        self._pending_n = 0
        self._batch = batch_kmers

    def add_codes(self, codes: np.ndarray):
        if self.span is not None:
            arr, valid = self.span.from_codes(codes)
            if arr.shape[0] == 0:
                return
            canon = self.span.keys(self.span.canonical(arr[valid]))
        else:
            canon = K.canonical_compact(codes, self.k)
        if canon.size:
            self._pending.append(canon)
            self._pending_n += canon.size
            if self._pending_n >= self._batch:
                self._flush()

    def _flush(self):
        if not self._pending:
            return
        arr = np.concatenate(self._pending)
        self._pending = []
        self._pending_n = 0
        # sort + run-length encode (np.unique takes a much slower path on
        # u64 at this scale than np.sort)
        s = np.sort(arr)
        if s.size == 0:
            u, c = s, np.zeros(0, np.int64)
        else:
            newrun = np.empty(s.size, bool)
            newrun[0] = True
            newrun[1:] = s[1:] != s[:-1]
            idx = np.flatnonzero(newrun)
            u = s[idx]
            c = np.diff(idx, append=s.size)
        if self._sorted.size == 0:
            self._sorted, self._counts = u, c.astype(np.int64)
        else:
            merged = np.concatenate([self._sorted, u])
            mcounts = np.concatenate([self._counts, c.astype(np.int64)])
            order = np.argsort(merged, kind="stable")
            merged, mcounts = merged[order], mcounts[order]
            uniq_mask = np.empty(merged.size, bool)
            uniq_mask[0] = True
            uniq_mask[1:] = merged[1:] != merged[:-1]
            idx = np.cumsum(uniq_mask) - 1
            out_counts = np.zeros(int(idx[-1]) + 1, np.int64)
            np.add.at(out_counts, idx, mcounts)
            self._sorted = merged[uniq_mask]
            self._counts = out_counts

    def result(self) -> CountResult:
        self._flush()
        hist = np.zeros(HISTOGRAM_MAX + 1, np.int64)
        clipped = np.minimum(self._counts, HISTOGRAM_MAX)
        np.add.at(hist, clipped, 1)
        return CountResult(self._sorted, self._counts, hist, self.k)


def auto_cutoff(histogram: np.ndarray, min_auto_threshold: int = MIN_AUTO_THRESHOLD) -> int:
    """Abundance threshold from the k-mer histogram ("-abundance-min auto").

    Valley-finding calibrated against the reference gold run
    (test/full_test/gold_find.output: "abundance_min (auto inferred): 7"):

    1. smooth the histogram with a +-2 sliding mean (window truncated at the
       boundaries) to locate the end of the sequencing-error slope;
    2. the error slope ends at the first index where the smoothed histogram
       stops decreasing;
    3. the genomic coverage peak is the argmax of the smoothed histogram
       beyond that point;
    4. the cutoff is the argmin of the *raw* histogram in
       [valley_start, peak] (ties -> smaller abundance);
    5. floored by min_auto_threshold.
    """
    h = np.asarray(histogram, dtype=np.float64)
    n = h.shape[0]
    if n < 4 or h[1:].sum() == 0:
        return min_auto_threshold
    # smoothed[i] = mean of h[max(1,i-2) .. min(n-1,i+2)]
    s = np.zeros(n)
    for i in range(1, n):
        lo, hi = max(1, i - 2), min(n - 1, i + 2)
        s[i] = h[lo : hi + 1].mean()
    valley_start = None
    for i in range(2, n - 1):
        if s[i] < s[i + 1]:
            valley_start = i
            break
    if valley_start is None:
        return min_auto_threshold
    peak = valley_start + int(np.argmax(s[valley_start:]))
    if peak <= valley_start:
        return max(valley_start, min_auto_threshold)
    seg = h[valley_start : peak + 1]
    cutoff = valley_start + int(np.argmin(seg))
    return max(cutoff, min_auto_threshold)


class PartitionedCounter:
    """Disk-partitioned out-of-core counting honoring `-max-memory` — the
    DSK shape (reference src/Finder.cpp:103-105: max-memory 2000 MB,
    max-disk; SURVEY.md §2.2 SortingCount row). K-mers spill to partition
    files keyed by the TOP BITS of the canonical value, so each partition
    is a contiguous key range and the final (keys, counts) is the plain
    concatenation of per-partition sorted runs — bit-identical to the
    in-RAM StreamingCounter.

    Memory: only the spill buffer plus one partition's kmers are ever
    resident. A partition whose spill outgrows the budget is re-split by
    the next 2 key bits (recursively), so skewed inputs still respect the
    budget. k <= 32 (uint64 keys).
    """

    def __init__(self, k: int, memory_mb: int = 2000, disk_mb: int = 0,
                 tmp_dir: str | None = None, n_partitions: int | None = None,
                 expected_bases: int = 0, batch_kmers: int = 1 << 22):
        import tempfile

        assert k <= 32, "partitioned counter: k <= 32"
        self.k = k
        self._budget = max(int(memory_mb), 16) * (1 << 20)
        self._disk_budget = int(disk_mb) * (1 << 20)  # 0 = unbounded (auto)
        self._disk_used = 0
        # tmp_dir = parent directory for the spill area (-out-tmp); a fresh
        # subdirectory is always created and removed on completion
        self._dir = tempfile.mkdtemp(prefix="mtg_dsk_", dir=tmp_dir)
        self._own_dir = True
        if n_partitions is None:
            # spill files should sort within ~1/4 of the budget each
            est = max(int(expected_bases), 1) * 8
            n_partitions = max(4, min(1 << 12, 1 << max(0, (est * 4 // self._budget).bit_length())))
        p = max(2, int(n_partitions).bit_length() - 1)
        self._pbits = min(p, 2 * k - 1)
        self._shift = np.uint64(2 * k - self._pbits)
        self._npart = 1 << self._pbits
        self._files = [None] * self._npart
        self._pending: list[np.ndarray] = []
        self._pending_n = 0
        self._batch = batch_kmers

    def _fh(self, i):
        if self._files[i] is None:
            import os

            self._files[i] = open(os.path.join(self._dir, f"p{i:04d}.u64"), "wb")
        return self._files[i]

    def add_codes(self, codes: np.ndarray):
        canon = K.canonical_compact(codes, self.k)
        if canon.size:
            self._pending.append(canon)
            self._pending_n += canon.size
            if self._pending_n >= self._batch:
                self._spill()

    def _spill(self):
        if not self._pending:
            return
        arr = np.concatenate(self._pending)
        self._pending = []
        self._pending_n = 0
        part = (arr >> self._shift).astype(np.int64)
        order = np.argsort(part, kind="stable")
        arr, part = arr[order], part[order]
        bounds = np.searchsorted(part, np.arange(self._npart + 1))
        self._disk_used += arr.nbytes
        if self._disk_budget and self._disk_used > self._disk_budget:
            raise RuntimeError(
                "max-disk exceeded during partitioned counting "
                f"({self._disk_used >> 20} MB > {self._disk_budget >> 20} MB); "
                "raise -max-disk or -max-memory"
            )
        for i in range(self._npart):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                self._fh(i).write(arr[lo:hi].tobytes())

    def _sorted_runs(self):
        """Yield per-partition (sorted unique keys, counts), in key order."""
        import os

        self._spill()
        for f in self._files:
            if f is not None:
                f.close()
        names = sorted(os.listdir(self._dir))
        for name in names:
            path = os.path.join(self._dir, name)
            size = os.path.getsize(path)
            if size == 0:
                continue
            if size > self._budget // 2:
                yield from self._resplit(path)
                continue
            arr = np.fromfile(path, np.uint64)
            yield self._rle(arr)

    def _resplit(self, path: str, depth: int = 0):
        """Re-partition an oversized spill file by the next 2 key bits."""
        import os

        arr_size = os.path.getsize(path)
        if depth >= 8 or arr_size <= self._budget // 2:
            yield self._rle(np.fromfile(path, np.uint64))
            return
        subs = [open(path + f".{j}", "wb") for j in range(4)]
        shift = self._shift - np.uint64(2 * (depth + 1))
        with open(path, "rb") as f:
            while True:
                chunk = f.read(self._batch * 8)
                if not chunk:
                    break
                a = np.frombuffer(chunk, np.uint64)
                sub = ((a >> shift) & np.uint64(3)).astype(np.int64)
                for j in range(4):
                    m = sub == j
                    if m.any():
                        subs[j].write(a[m].tobytes())
        for s in subs:
            s.close()
        os.remove(path)
        for j in range(4):
            yield from self._resplit(path + f".{j}", depth + 1)

    @staticmethod
    def _rle(arr: np.ndarray):
        s = np.sort(arr)
        newrun = np.empty(s.size, bool)
        newrun[0] = True
        newrun[1:] = s[1:] != s[:-1]
        idx = np.flatnonzero(newrun)
        return s[idx], np.diff(idx, append=s.size).astype(np.int64)

    def n_partitions_used(self) -> int:
        import os

        return sum(1 for n in os.listdir(self._dir) if os.path.getsize(os.path.join(self._dir, n)))

    def finalize(self, cutoff_fn, abundance_max: int = 2147483647):
        """Two sub-passes: (a) count partitions -> per-partition result files
        + global histogram; (b) cutoff from the histogram (cutoff_fn(hist) ->
        int), then stream partitions again keeping only solid kmers.
        Returns (solid_keys, solid_counts, histogram, cutoff)."""
        import os

        hist = np.zeros(HISTOGRAM_MAX + 1, np.int64)
        part_paths = []
        for i, (u, c) in enumerate(self._sorted_runs()):
            np.add.at(hist, np.minimum(c, HISTOGRAM_MAX), 1)
            p = os.path.join(self._dir, f"res{i:05d}.npz")
            np.savez(p, u=u, c=c)
            part_paths.append(p)
        cutoff = cutoff_fn(hist)
        keys_parts, cnt_parts = [], []
        for p in part_paths:
            with np.load(p) as z:
                u, c = z["u"], z["c"]
            keep = (c >= cutoff) & (c <= abundance_max)
            keys_parts.append(u[keep])
            cnt_parts.append(c[keep])
            os.remove(p)
        self._cleanup()
        if keys_parts:
            return np.concatenate(keys_parts), np.concatenate(cnt_parts), hist, cutoff
        return np.zeros(0, np.uint64), np.zeros(0, np.int64), hist, cutoff

    def result(self) -> CountResult:
        """Full in-RAM result (tests / small inputs): identical contract to
        StreamingCounter.result()."""
        hist = np.zeros(HISTOGRAM_MAX + 1, np.int64)
        keys_parts, cnt_parts = [], []
        for u, c in self._sorted_runs():
            np.add.at(hist, np.minimum(c, HISTOGRAM_MAX), 1)
            keys_parts.append(u)
            cnt_parts.append(c)
        self._cleanup()
        if keys_parts:
            return CountResult(np.concatenate(keys_parts), np.concatenate(cnt_parts), hist, self.k)
        return CountResult(np.zeros(0, np.uint64), np.zeros(0, np.int64), hist, self.k)

    def _cleanup(self):
        import os
        import shutil

        if self._own_dir and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
