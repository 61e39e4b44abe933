"""De Bruijn graph facade over an exact solid-kmer set.

Replaces GATB-core's Bloom + cascading-debloom + MPHF graph
(call sites: Graph::create/load src/Finder.cpp:266-278, contains
src/FindBreakpoints.hpp:853, in/outdegree src/FindBreakpoints.hpp:707-713,
queryAbundance src/Filler.cpp:978). Membership is exact — a sorted canonical
k-mer key array + binary search — which is a strict superset of the
reference's bloom+cFP guarantee and hash-robust (SURVEY.md §7 hard-part 1).

K-mer spans: for k <= 32 keys are uint64; for 32 < k <= 256 keys are
multi-word big-endian void views (ops/span.py) with identical sort/search
semantics — mirroring the reference's KSIZE_LIST template spans
(reference README.md:172-180).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops import counting, kmers as K
from ..ops.span import Span, canonical_int, revcomp_int
from ..utils.phases import count, span


class SolidSet:
    """Sorted canonical k-mer set with optional abundance values.

    keys: sorted uint64 array (k <= 32) or sorted void array (k > 32)."""

    def __init__(self, keys: np.ndarray, k: int, counts: np.ndarray | None = None):
        self.k = k
        self.span = Span(k) if k > 32 else None
        if keys.dtype == np.uint64 or keys.dtype.kind == "V":
            self.keys = np.ascontiguousarray(keys)
        else:
            self.keys = np.ascontiguousarray(keys, dtype=np.uint64)
        self.counts = None if counts is None else np.ascontiguousarray(counts)

    # legacy name used by device paths (u64 only)
    @property
    def kmers(self):
        return self.keys

    def __len__(self):
        return int(self.keys.size)

    # -- vectorized (canonical keys in the native representation) ----------
    def contains_key(self, keys):
        if len(self.keys) == 0:
            return np.zeros(np.asarray(keys).shape, bool)
        idx = np.searchsorted(self.keys, keys)
        idx = np.minimum(idx, len(self.keys) - 1)
        return self.keys[idx] == keys

    def abundance_key(self, keys):
        if len(self.keys) == 0:
            return np.zeros(np.asarray(keys).shape, np.int64)
        idx = np.searchsorted(self.keys, keys)
        idx = np.minimum(idx, len(self.keys) - 1)
        hit = self.keys[idx] == keys
        return np.where(hit, self.counts[idx], 0)

    # -- u64 compatibility surface (k <= 32 device/host fast paths) --------
    def contains_canon(self, canon):
        if self.span is None:
            return self.contains_key(np.asarray(canon, dtype=np.uint64))
        return self.contains_key(canon)

    def abundance_canon(self, canon):
        if self.span is None:
            return self.abundance_key(np.asarray(canon, dtype=np.uint64))
        return self.abundance_key(canon)

    def contains_fwd(self, fwd):
        assert self.span is None, "u64 path only"
        return self.contains_key(K.canonical_u64(np.asarray(fwd, dtype=np.uint64), self.k))

    # -- python-int point queries (any k; observers / fill traversal) ------
    def contains_int(self, canon: int) -> bool:
        if len(self.keys) == 0:
            return False
        key = self.span.int_key(canon) if self.span is not None else np.uint64(canon)
        i = int(np.searchsorted(self.keys, key))
        return i < len(self.keys) and self.keys[i] == key

    def abundance_int(self, canon: int) -> int:
        if len(self.keys) == 0:
            return 0
        key = self.span.int_key(canon) if self.span is not None else np.uint64(canon)
        i = int(np.searchsorted(self.keys, key))
        if i < len(self.keys) and self.keys[i] == key:
            return int(self.counts[i])
        return 0

    def to_int_array(self):
        if self.span is None:
            return self.keys.tolist()
        return self.span.to_ints(self.span.from_keys(self.keys)).tolist()


class Graph:
    """The de Bruijn graph: solid set + abundance + metadata info tree."""

    def __init__(self, solid: SolidSet, info: dict | None = None):
        self.solid = solid
        self.k = solid.k
        self.info = info or {}

    # -- membership ---------------------------------------------------------
    def contains_fwd(self, fwd) -> np.ndarray:
        return self.solid.contains_fwd(fwd)

    def contains_canon(self, canon) -> np.ndarray:
        return self.solid.contains_canon(canon)

    def query_abundance_canon(self, canon):
        return self.solid.abundance_canon(canon)

    def contains_canon_int(self, canon: int) -> bool:
        return self.solid.contains_int(canon)

    def query_abundance_int(self, canon: int) -> int:
        return self.solid.abundance_int(canon)

    # -- degrees (python-int, any k) ----------------------------------------
    def outdegree_int(self, fwd: int) -> int:
        k = self.k
        mask = (1 << (2 * k)) - 1
        d = 0
        for x in range(4):
            n = ((fwd << 2) | x) & mask
            if self.solid.contains_int(canonical_int(n, k)):
                d += 1
        return d

    def indegree_int(self, fwd: int) -> int:
        k = self.k
        d = 0
        for x in range(4):
            n = (fwd >> 2) | (x << (2 * (k - 1)))
            if self.solid.contains_int(canonical_int(n, k)):
                d += 1
        return d

    # -- vectorized degrees (u64 fast path) ---------------------------------
    def out_neighbors_fwd(self, fwd):
        fwd = np.asarray(fwd, dtype=np.uint64)
        mask = K.kmer_mask(self.k)
        return np.stack(
            [((fwd << np.uint64(2)) | np.uint64(x)) & mask for x in range(4)], axis=-1
        )

    def in_neighbors_fwd(self, fwd):
        fwd = np.asarray(fwd, dtype=np.uint64)
        shift = np.uint64(2 * (self.k - 1))
        return np.stack(
            [(fwd >> np.uint64(2)) | (np.uint64(x) << shift) for x in range(4)], axis=-1
        )

    def outdegree_fwd(self, fwd):
        return self.solid.contains_fwd(self.out_neighbors_fwd(fwd)).sum(axis=-1)

    def indegree_fwd(self, fwd):
        return self.solid.contains_fwd(self.in_neighbors_fwd(fwd)).sum(axis=-1)

    def nb_branching(self) -> int:
        """Branching nodes: solid nodes with in-degree != 1 or out-degree != 1
        (GATB branching definition, "nb_branching" in getInfo())."""
        if len(self.solid) == 0:
            return 0
        if self.solid.span is None:
            km = self.solid.keys
            ind = self.indegree_fwd(km)
            outd = self.outdegree_fwd(km)
            return int(np.count_nonzero((ind != 1) | (outd != 1)))
        sp = self.solid.span
        arr = sp.from_keys(self.solid.keys)
        ind = np.zeros(arr.shape[0], np.int32)
        outd = np.zeros(arr.shape[0], np.int32)
        for x in range(4):
            outd += self.solid.contains_key(sp.keys(sp.canonical(sp.shift_left_insert(arr, x))))
            ind += self.solid.contains_key(sp.keys(sp.canonical(sp.shift_right_insert(arr, x))))
        return int(np.count_nonzero((ind != 1) | (outd != 1)))

    # -- persistence --------------------------------------------------------
    def save(self, path: str):
        """Serialize the graph artifact (the reference's .h5 checkpoint seam,
        src/Finder.cpp:274-279 / src/Filler.cpp:216-226). Format is our own
        (npz container); the file-name convention is kept."""
        if self.solid.span is None:
            kmers = self.solid.keys
            words = 1
        else:
            kmers = self.solid.span.from_keys(self.solid.keys)
            words = self.solid.span.W
        np.savez_compressed(
            path,
            magic=np.frombuffer(b"MTGTPU02", dtype=np.uint8),
            k=np.int64(self.k),
            words=np.int64(words),
            kmers=kmers,
            counts=self.solid.counts if self.solid.counts is not None else np.zeros(0, np.int64),
            info=np.frombuffer(json.dumps(self.info).encode(), dtype=np.uint8),
        )
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            os.replace(path + ".npz", path)

    def save_hdf5(self, path: str):
        """Export the graph as a REAL HDF5 container (h5dump/h5py
        inspectable — the reference ecosystem's interchange expectation,
        reference README.md:210-231). Schema (ours, documented here, not
        GATB's dbgh5 layout — the Bloom/cFP internals it would describe do
        not exist in this design):

          / attrs: format="mindthegap_tpu-dbg", version=1, kmer_size, words
          /solid/kmers  u64 [N] (k<=32) or [N, W] span rows
          /solid/counts i64 [N]
          / attrs: info = JSON metadata (thresholds, nb_branching, ...)

        Graph.load() reads both this and the native npz format, so an
        exported file is a drop-in `-graph` argument."""
        import h5py

        if self.solid.span is None:
            kmers = self.solid.keys
            words = 1
        else:
            kmers = self.solid.span.from_keys(self.solid.keys)
            words = self.solid.span.W
        with h5py.File(path, "w") as f:
            f.attrs["format"] = "mindthegap_tpu-dbg"
            f.attrs["version"] = 1
            f.attrs["kmer_size"] = self.k
            f.attrs["words"] = words
            f.attrs["info"] = json.dumps(self.info)
            grp = f.create_group("solid")
            grp.create_dataset("kmers", data=kmers, compression="gzip", shuffle=True)
            counts = self.solid.counts if self.solid.counts is not None else np.zeros(0, np.int64)
            grp.create_dataset("counts", data=counts, compression="gzip", shuffle=True)

    @staticmethod
    def load(path: str) -> "Graph":
        try:
            import h5py

            is_h5 = h5py.is_hdf5(path)
        except Exception:
            is_h5 = False
        if is_h5:
            with h5py.File(path, "r") as f:
                assert f.attrs.get("format") == "mindthegap_tpu-dbg", (
                    "not a mindthegap_tpu graph HDF5 (a GATB dbgh5 file must be "
                    "rebuilt from reads: the Bloom/cFP internals do not transfer)"
                )
                k = int(f.attrs["kmer_size"])
                info = json.loads(f.attrs["info"])
                kmers = f["solid/kmers"][...]
                counts = f["solid/counts"][...]
            if kmers.ndim == 2:
                kmers = Span(k).keys(kmers)
            return Graph(SolidSet(kmers, k, counts), info)
        with np.load(path, allow_pickle=False) as z:
            k = int(z["k"])
            info = json.loads(bytes(z["info"].tobytes()).decode())
            kmers = z["kmers"]
            if kmers.ndim == 2:
                kmers = Span(k).keys(kmers)
            solid = SolidSet(kmers, k, z["counts"])
        return Graph(solid, info)


def _estimate_bases(reads_uri: str) -> int:
    """Cheap upper-ish bound on total bases from file sizes (gz assumed 4x)."""
    from ..io.bank import _expand_uri

    total = 0
    for path in _expand_uri(reads_uri):
        try:
            sz = os.path.getsize(path)
        except OSError:
            continue
        total += sz * 4 if path.endswith(".gz") else sz
    return total


def build_graph(
    reads_uri: str,
    k: int,
    abundance_min: str | int = "auto",
    abundance_max: int = 2147483647,
    count_engine: str = "auto",
    max_memory_mb: int = 2000,
    max_disk_mb: int = 0,
    tmp_prefix: str | None = None,
    device=None,
) -> Graph:
    """Count reads and build the solid-kmer graph (Graph::create equivalent).

    count_engine: "host" (numpy/native sort+RLE), "device" (per-batch k-mer
    extraction, sort and merge on `device`, ops/counting_device.py; k <= 32,
    larger spans count on the host as in the JAX package), "partitioned",
    or "auto" (host; switches to the disk-partitioned out-of-core counter
    when the in-RAM counting footprint could exceed `max_memory_mb` — the
    reference's -max-memory contract, src/Finder.cpp:103-105), or
    "sharded" (k <= 32: the mesh of `device`'s run, parallel/mesh.py, or
    in a run across processes the global mesh, counting with the k-mers
    routed to owner shards, parallel/sharded_count.py). Whatever the
    engine, a given `device` also counts the branching nodes at k <= 32
    (_nb_branching)."""
    from ..io.bank import iter_codes

    auto = isinstance(abundance_min, str) and abundance_min == "auto"

    est_bases = _estimate_bases(reads_uri)
    budget_bytes = max(int(max_memory_mb), 16) << 20
    # StreamingCounter peak ~ 16B/distinct kmer x2 during merges; worst case
    # every base starts a distinct kmer
    needs_partition = k <= 32 and est_bases * 32 > budget_bytes

    if count_engine == "sharded" and k <= 32:
        from ..device import resolve_device
        from ..parallel import distributed as D
        from ..parallel import mesh as M
        from ..parallel.sharded_count import ShardedStreamingCounter

        # in a run across processes the rank's block of the global mesh
        counter = ShardedStreamingCounter(k, D.global_mesh(M.pow2_mesh(M.make_mesh(resolve_device(device)))))
    elif count_engine == "device" and k <= 32:
        from ..device import resolve_device
        from ..ops.counting_device import DeviceStreamingCounter

        counter = DeviceStreamingCounter(k, resolve_device(device))
    elif count_engine == "partitioned" or (count_engine == "auto" and needs_partition):
        counter = counting.PartitionedCounter(
            k, memory_mb=max_memory_mb, disk_mb=max_disk_mb,
            tmp_dir=tmp_prefix, expected_bases=est_bases,
        )
    else:
        counter = counting.StreamingCounter(k)
    for _hdr, codes in iter_codes(reads_uri):
        counter.add_codes(codes)

    if isinstance(counter, counting.PartitionedCounter):
        # two-pass finalize keeps only one partition resident at a time and
        # never materializes the non-solid kmers
        cutoff_fn = counting.auto_cutoff if auto else (lambda _hist: int(abundance_min))
        keys, counts, hist, cutoff = counter.finalize(cutoff_fn, abundance_max)
        solid = SolidSet(keys, k, counts)
        n_solid = int(keys.size)
    else:
        res = counter.result()
        with span("solid filter"):
            cutoff = counting.auto_cutoff(res.histogram) if auto else int(abundance_min)
            keep = (res.counts >= cutoff) & (res.counts <= abundance_max)
            solid = SolidSet(res.kmers[keep], k, res.counts[keep])
            n_solid = int(keep.sum())
            count("solid k-mers", n_solid)

    info = {
        "kmers_nb_solid": n_solid,
        "thresholds": cutoff,
        "abundance_max": abundance_max,
        "abundance_min_is_auto": bool(auto),
    }
    if auto:
        info["cutoffs_auto.values"] = f"{cutoff} "
    g = Graph(solid, info)
    with span("branching"):
        g.info["nb_branching"] = _nb_branching(g, device)
    return g


def _nb_branching(g: Graph, device) -> int:
    """Graph.nb_branching, on `device` where build_graph was given one, k <=
    32 and the set fits there (ops/branching_device.py: the keys uploaded
    once, K17 on a card, its plain version on the CPU); else the host
    function. The count "keys probed on device" is the keys counted there,
    0 on the host path."""
    if device is not None and g.k <= 32:
        import torch

        from ..ops import branching_device as BD

        dev = torch.device(device)
        n = len(g.solid)
        if BD.fits(n, dev):
            keys = torch.from_numpy(g.solid.keys.view(np.int64)).to(dev)
            count("keys probed on device", n)
            return BD.nb_branching(keys, g.k)
    count("keys probed on device", 0)
    return g.nb_branching()


def build_repeat_set(ref_uri: str, k_minus_1: int, min_occ: int) -> SolidSet:
    """Canonical (k-1)-mers occurring >= min_occ times in the reference —
    exact-set stand-in for the reference's repeat Bloom (fillRefBloom,
    src/FindBreakpoints.hpp:955-1009: DSK at kmerSize-1 with abundance-min =
    het_max_occ+1; our exact set removes its ~4e-5 FP rate)."""
    from ..io.bank import iter_codes

    counter = counting.StreamingCounter(k_minus_1)
    for _hdr, codes in iter_codes(ref_uri):
        counter.add_codes(codes)
    res = counter.result()
    keep = res.counts >= min_occ
    return SolidSet(res.kmers[keep], k_minus_1, res.counts[keep])
