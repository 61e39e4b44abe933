#!/usr/bin/env python3
"""Smoke run of mindthegap_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. print the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from the checkout, one nvcc per source, all
     started together, and time the build: K1 and K10 (csrc/scan_qp.cu),
     K2 (csrc/nw.cu), K3 (csrc/count_kmers.cu), K4 (csrc/count_merge.cu),
     K5 (csrc/walk.cu), K6 (csrc/scan_span.cu), K7 (csrc/walk_span.cu),
     K8, K9 and K15 (csrc/scan_planes.cu), K11 (csrc/sharded_count.cu),
     K12 and K13 (csrc/sharded_member.cu), K14 (csrc/scan_sorted.cu), the
     bucket index build of K13 and K14 (csrc/sorted_index.cu), K16
     (csrc/scan_planes_span.cu);
  3. hold each kernel against its plain PyTorch version on the card, exactly,
     at the main path's shapes, and time both sides: K1 (the whole
     scan_cls_qp, its exception compaction included) on a full 2^22-base
     window over the pair map of a bacterial-size solid set, and on its
     compaction edge cases; K8 (cuckoo map), K9 (bucket map), K10
     (the pair map's dense stream) and K15 (the pair map's planes, also
     held to K10 + planes_from_pay, the route it replaces) on the same
     window over the maps of the same set, and on their edge windows at k 2
     (K10 and K15: 3), 3, 31 and 32 (K8 and K9 at k 31 also into plane
     views at unaligned offsets, K15 also over maps with no repeat set),
     and K8 on its pipeline's cases at k 21, 31 and 32 (a window of over
     1,024 tiles, a half-full map, every key absent, a full unsorted
     stash), K10 and K15 on K10's pipeline cases at k 3, 21, 31 and 32 (a
     window of over 1,024 tiles, a map near its highest load factor, every
     pair absent, a full stash in descending order), and K15 on its tile
     edges (windows ending at and around a tile's end, each tile's halo
     pair in its second row, in the stash or absent);
     K2 on 256 seeded pairs of 50 to 10,000 bp
     (also against the native nw.cpp); K3 (+ the sort) on one default
     counting batch of 2^23 bases of the reads, and on its edge batches
     (k 1 to 32); K4 merging that batch into an accumulator of the donor's
     distinct k-mers, once at full capacity and once truncated, and on its
     tile edge cases; K5 on donor k-mers with a budget of 10,000 and 2,048
     steps at 4,096 lanes, 128 lanes (the fill's shape) and 1 lane (the
     chain latency), both layouts, and on its look-ahead edge cases at
     every depth; K6 on a full 2^21-base window at k = 45 over the span map
     of the donor's k-mers (made from the donor directly, without
     counting), and on its edge windows at k 33 to 256; K16 (the span
     map's planes) on that window, also held to K6 + planes_from_pay_span
     (the route it replaces), on K6's edge windows at k 33 to 256 with
     and without a repeat set and on its tile edges at k 45, 128, 129 and
     130; K7 on donor k-mers at k = 45 with a budget of
     10,000 and 2,048 steps at 4,096, 128 and 1 lanes (each at the
     look-ahead depth its rule picks), and on its edge cases at k 33 to 256
     at every depth; K11 on one 2^23-base flush of the reads, whole and
     cut in 4 logical shards' chunks (its edge chunks also as views at an
     odd byte offset); K12 and K13 (the route, the owner's
     probe, the scatter back) on the nine membership queries of 2^20
     reference positions over the solid set on 4 logical shards of the
     card, and once with the capacity forced to overflow (the host route),
     with K12's launches timed apart (torch.profiler) and its bitset loads
     counted, K13's probe through the owner's bucket index and through one
     its wrapper builds (the build timed apart), with the sectors it reads,
     and K13's scatter on its own edge cases, timed by the device time of
     its launches (torch.profiler: its wrapper takes longer on the host
     than its launches on the card) beside one PyTorch call of the same
     function (`index_put_`);
     K14 on a 2^22-base window over the sorted solid set and a repeat set
     (its two index builds timed apart, the sectors its lookups read), and
     at entry()'s shapes; the bucket index's build kernel on those sets,
     the shards and the edge sets (its own too), with the solid set's
     build and the first and the last (SENTINEL-tailed) shard's by launch,
     beside torch.searchsorted of the bucket numbers; the sharded counter on 4 logical shards with
     its capacity forced to overflow, against the host counter. The edge cases
     come from tests/torch_tables.py (scan_edge_windows, key_edge_batches,
     merge_edge_cases, edge_walk_case, span_edge_windows,
     edge_walk_span_case, plane_edge_windows, plane_pipeline_case,
     swizzle_edge_chunks, member_edge_cases, route_edge_cases,
     scatter_edge_cases, sorted_edge_windows, pair_pipeline_case,
     index_edge_sets, pair_tile_case, span_tile_case), the generators the CUDA tests use, so the smoke and
     tests/test_torch_cuda.py check the same inputs; the script needs the
     checkout's tests/ directory for them.
     Each kernel's bound is the
     larger of its bytes over 3.35 TB/s and its operations over the card's
     peak rate for them, counted from this run's inputs
     (mindthegap_tpu_torch/bounds.py);
  4. drive the main path at the size users run: a seeded genome of
     4,641,652 bp (the length of E. coli K-12 MG1655) with ~100 planted
     homozygous insertions of 20-500 bp plus SNPs and deletions, 30x of
     2x150 bp error-free reads from the donor; `find -in reads -ref ref`
     with default flags (in-process through the CLI entry point, so the
     kernel launch counters are readable), then `fill -bkpt` as a
     subprocess; `nwalign --device` on one filled insertion against its
     planted sequence, checked against the native engine (and K2 against
     its plain version at that pair's shape);
  5. drive the device-engine path on the same data, in-process: `find
     -count-engine device`, then `fill -fill-engine device` and
     `-fill-engine device-qb` (and the native fill, for its time); then the
     same device runs again under torch.profiler, for the device time of
     K3, K4, K5 and the sort without the profiler in the wall times;
  6. drive the plane path on the main path's graph (t.h5), in-process:
     `find -graph -scan-engine device` (K8) and `device-qb` (K9) over the
     whole reference; `-scan-engine host` and `-automaton host` (K10, then
     the Python automaton) over its first 1,000,000 bases, beside a
     default run there (the cut keeps the numpy oracle and the Python
     automaton within the time limit); K1's feed at exc_cap 0, every
     window re-dispatched dense through K10, into the native automaton;
     then the `auto` gate's timings (the host plane route against the
     default feed, at the graph's solid-set size and on a 1/16 cut);
  7. drive the device mesh of the process, in-process: on the card's
     one-device mesh `find -graph -scan-engine sharded` over the whole
     reference (K10) and `find -count-engine sharded` from the reads
     (K11); on 4 logical shards of the card `fill -fill-engine device`
     (the walker's lanes over the shards, K5), `find -graph -scan-engine
     sharded-mem` over the first 1,000,000 bases (K12, K13), and the
     graft entry points of mindthegap_tpu_torch/graft_entry.py: entry() (K14)
     and dryrun_multichip(4), whose asserts hold its outputs to one shard's
     and to plain computations;
  8. drive the run across processes on the card: this script re-invoked as
     2 ranks (`--rank R --world 2 --rendezvous FILE ...`, gloo through a
     rendezvous file), each with 2 logical shards of the card in a global
     mesh of 4, each running `find -in reads -scan-engine sharded
     -count-engine sharded -automaton host` (K11 on its count chunks, K10
     on its scan windows) and `fill -fill-engine device` (K5 on its jobs)
     through the CLI; a line gives each rank's walls and launches;
  9. drive `find -graph -profile-trace DIR` on the card, in-process: its
     torch.profiler trace must name K1's kernel;
  10. drive the k = 45 path on a case of its own (500,000 bp, 11
     insertions, 6 SNPs, 6 deletions, 30x: cut from the E. coli size
     because host span counting takes ~0.7 ms a read), in-process: `find
     -kmer-size 45` (the span scan, K6), the native fill, `fill
     -fill-engine device` and `device-qb` (the span walker, K7); then a
     `find -graph -device cpu` rerun; then `find -graph` (the span map's
     build and upload, K6) and the two device fills again under
     torch.profiler, for the device time of the k = 45 path; then `find
     -graph -scan-engine device-qb` and `-automaton host` (K6, then
     planes_from_pay_span), and `-scan-engine sharded` (K6 on the
     one-device mesh);
  11. drive the analysis script context_genome_wg on the outputs of the
     main path (t.h5, k = 31: K15) and of the k = 45 path (K16), on the
     card in-process, and the same command with `-device cpu` as a
     subprocess (at k = 31 started right after the main path, so that it
     runs behind phases 5-10); the two write the same bytes, and each
     kernel launches at least once a window of the reference; the phase's
     wall is printed;
  12. check the results: every kernel launched on its path; the find
     artifacts equal a `-device cpu` rerun on the same graph (at k = 31
     and k = 45); the device-count graph, breakpoints and VCF records
     equal the host-count run's; every plane-path run's records equal the
     default run's (at both k); the device fills' artifacts equal the
     native fill's (at both k, and over the walker's mesh); the
     sharded-count graph equals the host-count graph byte for byte; on
     every rank of the distributed phase the records equal the default
     run's, the graph the host-count graph byte for byte and the device
     fill the native fill, and rank 0 alone is the writer; the traced
     run's records equal the default run's; insertion recall >= 90% on
     every path.

The line before the last holds the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ECOLI_LEN = 4_641_652  # E. coli K-12 MG1655 chromosome length
NUC = np.frombuffer(b"ACTG", np.uint8)  # code -> letter (A=0 C=1 T=2 G=3)
LETTERS = np.full(256, ord("N"), np.uint8)  # codes with 255 (invalid) as N
LETTERS[:4] = NUC
CHROM = "ref"


# ---------------------------------------------------------------------------
# synthetic donor genome and reads (also used by tests/test_torch_main_path.py)

def make_case(genome_len: int, n_ins: int, n_snp: int, n_del: int, seed: int):
    """Random reference (codes) and a donor with planted variants, spaced
    evenly with jitter so every variant sits in unique sequence.

    Returns (ref codes, donor codes, insertions as [(ref_pos, seq codes)]):
    an insertion at ref_pos goes between ref[ref_pos-1] and ref[ref_pos]."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, genome_len, dtype=np.uint8)
    kinds = np.array(["ins"] * n_ins + ["snp"] * n_snp + ["del"] * n_del)
    kinds = kinds[rng.permutation(kinds.size)]
    gap = genome_len // (kinds.size + 1)
    sites = np.arange(1, kinds.size + 1) * gap + rng.integers(-gap // 4, gap // 4, kinds.size)
    pieces, insertions, prev = [], [], 0
    for kind, s in zip(kinds, sites):
        s = int(s)
        pieces.append(ref[prev:s])
        if kind == "ins":
            seq = rng.integers(0, 4, int(rng.integers(20, 501)), dtype=np.uint8)
            pieces.append(seq)
            insertions.append((s, seq))
            prev = s
        elif kind == "snp":
            pieces.append(np.array([(ref[s] + rng.integers(1, 4)) % 4], np.uint8))
            prev = s + 1
        else:
            prev = s + int(rng.integers(1, 41))
    pieces.append(ref[prev:])
    return ref, np.concatenate(pieces), insertions


def write_fasta(path: str, name: str, codes: np.ndarray, mode: str = "wb"):
    with open(path, mode) as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(LETTERS[codes].tobytes())
        f.write(b"\n")


def write_reads(prefix: str, donor: np.ndarray, coverage: float, seed: int,
                read_len: int = 150, chunk: int = 100_000) -> str:
    """Error-free 2x150 paired reads (fragments of 300-500 bp) at `coverage`;
    returns the `-in` argument (two FASTA files)."""
    rng = np.random.default_rng(seed)
    n_frag = int(coverage * donor.size / (2 * read_len))
    paths = (f"{prefix}_1.fa", f"{prefix}_2.fa")
    cols = np.arange(read_len)
    with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2:
        for lo in range(0, n_frag, chunk):
            nb = min(chunk, n_frag - lo)
            flen = rng.integers(300, 501, nb)
            start = (rng.random(nb) * (donor.size - flen + 1)).astype(np.int64)
            r1 = donor[start[:, None] + cols]
            r2 = donor[(start + flen - 1)[:, None] - cols] ^ 2  # reverse complement
            for f, r in ((f1, r1), (f2, r2)):
                rec = np.empty((nb, read_len + 4), np.uint8)
                rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
                rec[:, 3:-1] = NUC[r]
                rec[:, -1] = ord("\n")
                f.write(rec.tobytes())
    return ",".join(paths)


_INS_HEADER = re.compile(r"^>bkpt\d+_(\S+?)_pos_(\d+)_fuzzy_\d+_(?:HOM|HET)_len_(\d+)_")


def filled_insertions(fasta_path: str):
    """(chrom, pos, seq) of each record of a fill .insertions.fasta."""
    out = []
    with open(fasta_path) as f:
        lines = f.read().splitlines()
    for head, seq in zip(lines[0::2], lines[1::2]):
        m = _INS_HEADER.match(head)
        if m:
            out.append((m.group(1), int(m.group(2)), seq))
    return out


def insertion_recall(insertions, filled, slack: int = 20) -> float:
    """Share of planted insertions with a filled record of the planted length
    within `slack` bp of the planted site."""
    hits = 0
    for pos, seq in insertions:
        if any(abs(p - pos) <= slack and len(s) == seq.size for _c, p, s in filled):
            hits += 1
    return hits / max(len(insertions), 1)


# ---------------------------------------------------------------------------
# the run on the card

def _cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    from mindthegap_tpu_torch.device import cuda_ms

    return cuda_ms(fn, iters, warmup)


def _max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over (kernel, plain) integer tensor pairs of
    equal shapes (an empty pair counts 0)."""
    errs = [0]
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"kernel output of shape {tuple(a.shape)}, plain {tuple(b.shape)}")
        if a.numel():
            errs.append(int((a.long() - b.long()).abs().max()))
    return max(errs)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bytes_bound_ms(n_bytes: float) -> dict:
    from mindthegap_tpu_torch.bounds import bytes_ms

    return {"bound_ms": bytes_ms(n_bytes), "bound_by": "bytes", "library_ms": None}


def check_scan_kernel(ref: np.ndarray, solid: np.ndarray, k: int, seed: int):
    """K1, the whole scan_cls_qp (classes and the exception compaction),
    against its plain version on one full 2^22-base window of the reference
    at the feed's default exception cap, over the pair map of the donor's
    solid set; then on its compaction edges. Returns (the kernel record,
    the host pair map, so that K10's check reuses it)."""
    import torch

    from mindthegap_tpu_torch.bounds import SECTOR_BYTES, bytes_ms, scan_probe_sectors
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import extmap as X
    from mindthegap_tpu_torch.ops import kmers as K
    from torch_tables import scan_edge_windows

    rfwd, _ = K.kmers_from_codes(ref, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::50], k - 1))  # exercise the REP class
    qp = X.build_fused_pair(solid, k, repeat)
    t = qp.to("cuda")
    window = 1 << 22
    packed, bad = _smoke_window(ref, window, seed)
    cap = (window - k + 2 + 3) // 4 * 4 // 8
    args = (packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, t.log_size, k, cap)
    keys = ("cls2", "exc16", "n_exc")
    got = S.scan_cls_qp_cuda(*args)
    want = S._scan_cls_qp_plain(*args)
    torch.cuda.synchronize()
    errs = [_max_abs_err((got[key], want[key]) for key in keys)]
    ms = _cuda_ms(lambda: S.scan_cls_qp_cuda(*args), iters=20, warmup=2)
    plain_ms = _cuda_ms(lambda: S._scan_cls_qp_plain(*args), iters=3)
    # the row sectors this window's lookups need (one lookup per two
    # positions: its first-choice row, and its second where the key is not
    # in the first), the inputs read once and the outputs written once
    io_bytes = _nbytes(packed, bad, *(got[key] for key in keys))
    sectors = scan_probe_sectors(packed, bad, t, k)
    bound = _bytes_bound_ms(sectors * SECTOR_BYTES + io_bytes)
    # the bound as the earlier kernel's records counted it, two sectors for every pair
    two_sector_ms = bytes_ms(window * SECTOR_BYTES + io_bytes)
    print(f"K1 scan_cls_qp (whole: classes and exception compaction): window {window}, k {k}, "
          f"solid {solid.size}, table {qp.nbytes >> 20} MB, stash {int(qp.stash_keys.size)}, "
          f"{int(want['n_exc'])} EXC of cap {cap}, max_abs_err {errs[0]} (tolerance 0: exact), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms (bytes: "
          f"{sectors} row sectors for {(window - k + 3) // 2} pairs; two sectors a pair: {two_sector_ms:.4f} ms)")
    edge_qp, cases = scan_edge_windows(k)
    te = edge_qp.to("cuda")
    for name, (ecodes, ecap) in cases.items():
        ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(ecodes))
        eargs = (ep, eb, te.slots, te.stash_keys, te.stash_l, te.stash_r, te.log_size, k, ecap)
        g, w = S.scan_cls_qp_cuda(*eargs), S._scan_cls_qp_plain(*eargs)
        torch.cuda.synchronize()
        errs.append(_max_abs_err((g[key], w[key]) for key in keys))
        print(f"K1 edge case {name}: window {ecodes.size}, cap {ecap}, n_exc {int(w['n_exc'])}, "
              f"max_abs_err {errs[-1]}")
    return ({"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, **bound,
             "row_sectors": sectors, "bound_ms_two_sector": two_sector_ms,
             "ms_covers": "the whole scan_cls_qp: classes and exception compaction "
                          "(records of the earlier kernel timed its core alone)"}, qp)


def _smoke_window(ref: np.ndarray, window: int, seed: int):
    """The first `window` bases of the reference with an N run and 64
    isolated Ns, 2-bit packed on the card (K1's, K8's, K9's and K10's
    window)."""
    import torch

    from mindthegap_tpu_torch.find import scan_device as S

    rng = np.random.default_rng(seed)
    codes = ref[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    return tuple(torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))


def _plane_tables(host, layout: str):
    """(the host map on the card, (its tables...) and its log as the plane kernels take them)."""
    t = host.to("cuda")
    if layout == "pair":
        return t, (t.slots, t.stash_keys, t.stash_l, t.stash_r), host.log_size
    return t, (t.slots, t.stash_keys, t.stash_payload), host.log_nb if layout == "bucket" else host.log_size


def check_plane_kernels(ref: np.ndarray, solid: np.ndarray, qp, k: int, seed: int) -> dict:
    """K8 (scan_planes_q, over the cuckoo map), K9 (scan_planes_qb, over the
    bucket map), K10 (scan_pay_qp, over K1's pair map `qp`) and K15
    (scan_planes_qp, over the same map) against their plain versions on
    K1's full 2^22-base window of the reference, over the maps of the
    donor's solid set with K1's repeat set, K15 also against the route it
    replaces (K10, then planes_from_pay on the host); then on their edge
    windows (tests/torch_tables.py plane_edge_windows) at k 2, 3, 31 and
    32 (K10 and K15 from 3; K15 also over maps with no repeat set), K10
    and K15 on K10's pipeline cases, and K15 on its tile edges
    (pair_tile_case). Returns {name: kernel record}."""
    import torch

    from mindthegap_tpu_torch.bounds import (PLANE_BYTES_PER_POSITION, SECTOR_BYTES, plane_scan_sectors,
                                             scan_probe_sectors)
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.kernel_bench import planes_equal_route
    from mindthegap_tpu_torch.ops import extmap as X
    from mindthegap_tpu_torch.ops import kmers as K
    from torch_tables import (HALO_STATES, PAIR_PIPELINE_NAMES, PLANE_PIPELINE_NAMES, pair_pipeline_case,
                              pair_tile_case, plane_edge_windows, plane_pipeline_case)

    window = 1 << 22
    rfwd, _ = K.kmers_from_codes(ref, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::50], k - 1))  # K1's repeat set
    packed, bad = _smoke_window(ref, window, seed)
    n_pos = window - k + 1
    kernels = {"scan_planes_q": ("K8", "cuckoo", S.scan_planes_q_cuda, S._scan_planes_q_plain),
               "scan_planes_qb": ("K9", "bucket", S.scan_planes_qb_cuda, S._scan_planes_qb_plain),
               "scan_pay_qp": ("K10", "pair", S.scan_pay_qp_cuda, S._scan_pay_qp_plain),
               "scan_planes_qp": ("K15", "pair", S.scan_planes_qp_cuda, S._scan_planes_qp_plain)}
    window_codes = S.unpack_codes(packed, bad).cpu().numpy()
    out = {}
    for name, (label, layout, kernel, plain) in kernels.items():
        t0 = time.perf_counter()
        host = {"cuckoo": lambda: X.build_fused(solid, k, repeat), "bucket": lambda: X.build_fused_bucket(solid, k, repeat),
                "pair": lambda: qp}[layout]()
        build_s = time.perf_counter() - t0
        t, tables, log = _plane_tables(host, layout)
        args = (packed, bad, *tables, log, k)
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        errs = [_max_abs_err((got[key], want[key]) for key in want)]
        ms = _cuda_ms(lambda: kernel(*args), iters=20, warmup=2)
        plain_ms = _cuda_ms(lambda: plain(*args), iters=3)
        io_bytes = _nbytes(packed, bad, *got.values())
        if layout == "pair":
            sectors, what = scan_probe_sectors(packed, bad, t, k), f"row sectors for {(window - k + 3) // 2} pairs"
        else:
            sectors, what = plane_scan_sectors(packed, bad, t, k), f"sectors for {n_pos + 1} probes"
        bound = _bytes_bound_ms(sectors * SECTOR_BYTES + io_bytes)
        route = {}
        if label == "K15":  # the route it replaces on the card: K10, then planes_from_pay on the host
            def k10_route():
                r = S.scan_pay_qp_cuda(*args)
                return S.planes_from_pay(r["pay8"].cpu().numpy(), r["rep8"].cpu().numpy(), window_codes, k)

            t0 = time.perf_counter()
            if not planes_equal_route(got, k10_route()):
                raise AssertionError("K15's planes differ from K10 + planes_from_pay on the smoke's window")
            route = {"replaced_route": "K10 + planes_from_pay", "replaced_route_ms": (time.perf_counter() - t0) * 1e3,
                     "ms_with_copy": _cuda_ms(lambda: {key: v.cpu() for key, v in kernel(*args).items()}, iters=5)}
        print(f"{label} {name} ({layout} map): window {window}, k {k}, table {host.nbytes >> 20} MB "
              f"(built in {build_s:.1f} s), stash {int(np.asarray(host.stash_keys).size)}, max_abs_err {errs[0]} "
              f"(tolerance 0: exact), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"(bytes: {sectors} {what}, {io_bytes} bytes in and out), share {bound['bound_ms'] / ms:.4f}"
              + (f"; equal to K10 + planes_from_pay, which took {route['replaced_route_ms']:.1f} ms to host planes (one call, "
                 f"the comparison with it included; K15 and the copy of its planes to the host "
                 f"{route['ms_with_copy']:.4f} ms)" if route else ""))
        del t, tables, args, got, want
        for kk in (2, 3, 31, 32):
            if layout == "pair" and kk < 3:
                continue  # the pair map needs k >= 3
            eq, cases = plane_edge_windows(kk, layout)
            _, etables, elog = _plane_tables(eq, layout)
            kerrs = []
            cases = {key: (codes, etables, elog) for key, codes in cases.items()}
            if label == "K15":  # the empty repeat set of context_genome_wg's map
                nq, ncases = plane_edge_windows(kk, layout, repeats=False)
                _, ntables, nlog = _plane_tables(nq, layout)
                cases.update({f"{key} (no repeat set)": (codes, ntables, nlog) for key, codes in ncases.items()})
            for codes, etables, elog in cases.values():
                ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
                g, w = kernel(ep, eb, *etables, elog, kk), plain(ep, eb, *etables, elog, kk)
                kerrs.append(_max_abs_err((g[key], w[key]) for key in w))
                if layout != "pair" and kk == 31:  # the planes as views at unaligned offsets
                    views = {key: torch.zeros(v.numel() + 1, dtype=v.dtype, device="cuda")[1:] for key, v in w.items()}
                    S._scan_planes_into(ep, eb, *etables, elog, kk, layout == "bucket", views)
                    kerrs.append(_max_abs_err((views[key], w[key]) for key in w))
            torch.cuda.synchronize()
            errs += kerrs
            also = "; also into plane views at unaligned offsets" if layout != "pair" and kk == 31 else ""
            print(f"{label} edge cases (k {kk}: {', '.join(cases)}{also}): max_abs_err {max(kerrs)}")
        if layout == "cuckoo":  # K8's pipeline: blocks taking several tiles, full miss queues, a full unsorted stash
            kerrs = []
            for kk in (21, 31, 32):
                for case in PLANE_PIPELINE_NAMES:
                    eq, codes = plane_pipeline_case(kk, case)
                    _, etables, elog = _plane_tables(eq, layout)
                    ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
                    g, w = kernel(ep, eb, *etables, elog, kk), plain(ep, eb, *etables, elog, kk)
                    kerrs.append(_max_abs_err((g[key], w[key]) for key in w))
            torch.cuda.synchronize()
            errs += kerrs
            print(f"{label} pipeline cases (k 21, 31, 32: {', '.join(PLANE_PIPELINE_NAMES)}): max_abs_err {max(kerrs)}")
        if layout == "pair":  # K10's pipeline cases: 1,025 tiles, a map near full, every pair absent, a full stash
            kerrs = []
            for kk in (3, 21, 31, 32):
                for case in PAIR_PIPELINE_NAMES:
                    eq, codes = pair_pipeline_case(kk, case)
                    _, etables, elog = _plane_tables(eq, layout)
                    ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
                    g, w = kernel(ep, eb, *etables, elog, kk), plain(ep, eb, *etables, elog, kk)
                    kerrs.append(_max_abs_err((g[key], w[key]) for key in w))
            torch.cuda.synchronize()
            errs += kerrs
            print(f"{label} pipeline cases (k 3, 21, 31, 32: {', '.join(PAIR_PIPELINE_NAMES)}): max_abs_err {max(kerrs)}")
        if label == "K15":  # its tile edges: P at, one before and one after a tile's end, every halo in each state
            kerrs = []
            for kk in (24, 25, 28, 31):
                for state in HALO_STATES:
                    eq, codes = pair_tile_case(kk, state)
                    _, etables, elog = _plane_tables(eq, layout)
                    ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
                    g, w = kernel(ep, eb, *etables, elog, kk), plain(ep, eb, *etables, elog, kk)
                    kerrs.append(_max_abs_err((g[key], w[key]) for key in w))
            torch.cuda.synchronize()
            errs += kerrs
            print(f"{label} tile edges (k 24, 25, 28, 31: {', '.join(HALO_STATES)}): max_abs_err {max(kerrs)}")
        out[name] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, **bound, "sectors": sectors,
                     "map_build_s": build_s, **route,
                     "plane_bytes": n_pos * PLANE_BYTES_PER_POSITION if name != "scan_pay_qp" else None}
    return out


def make_pairs(n_pairs: int, lo: int, hi: int, seed: int):
    """Seeded NW pairs: half a mutated copy of a, half an unrelated b."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_pairs):
        a = rng.integers(0, 4, int(rng.integers(lo, hi + 1)), dtype=np.uint8)
        if rng.random() < 0.5:
            b = a.copy()
            idx = rng.integers(0, a.size, max(1, a.size // 50))
            b[idx] = rng.integers(0, 4, idx.size, dtype=np.uint8)
            b = np.delete(b, rng.integers(0, b.size, max(1, b.size // 200)))
        else:
            b = rng.integers(0, 4, int(rng.integers(lo, hi + 1)), dtype=np.uint8)
        pairs.append((NUC[a].tobytes().decode(), NUC[b].tobytes().decode()))
    return pairs


def check_nw_kernel(seed: int) -> dict:
    """K2 against its plain version and the native nw.cpp on 256 pairs of
    50 to 10,000 bp, in one launch per call."""
    import torch

    from mindthegap_tpu_torch.bounds import NW_OPS_PER_CELL, NW_OPS_PER_CELL_12, bytes_ms, nw_bound_ms
    from mindthegap_tpu_torch.ops import nw as N
    from mindthegap_tpu_torch.ops import nw_device as ND

    pairs = make_pairs(256, 50, 10_000, seed)
    seq, off = ND.pack_pairs(pairs)
    seq, off = seq.cuda(), off.cuda()
    before = ND.nw_matches_cuda.launches
    got = ND.nw_matches_cuda(seq, off)
    if ND.nw_matches_cuda.launches != before + 1:
        raise AssertionError(f"K2 took {ND.nw_matches_cuda.launches - before} launches for one call")
    t0 = time.perf_counter()
    want = ND._nw_matches_plain(seq, off)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_abs_err([(got, want)])
    lens = np.array([(len(a), len(b)) for a, b in pairs], np.float64)
    ident = got.cpu().numpy() / np.maximum(lens[:, 0], lens[:, 1])
    native = np.array([N.nw_identity(a, b) for a, b in pairs])
    if not np.array_equal(ident, native):
        raise AssertionError(f"K2 disagrees with native nw.cpp on {int((ident != native).sum())} pairs")
    ms = _cuda_ms(lambda: ND.nw_matches_cuda(seq, off), iters=10)
    cells = float((lens[:, 0] * lens[:, 1]).sum())
    io_ms = bytes_ms(_nbytes(seq, off, got))
    bound_ms = max(nw_bound_ms(cells), io_ms)
    # the bound as the earlier kernel's records counted it
    bound_12op = max(nw_bound_ms(cells, NW_OPS_PER_CELL_12), io_ms)
    print(f"K2 nw_matches: 256 pairs, {cells / 1e9:.3f} Gcells, max_abs_err {err} (tolerance 0: exact), "
          "equal to native nw.cpp, one launch a call, "
          f"kernel {ms:.4f} ms (the wrapper's call), plain {plain_ms:.4f} ms (one call), bound {bound_ms:.4f} ms "
          f"({NW_OPS_PER_CELL} int32 operations per cell), share {bound_ms / ms:.4f}; at "
          f"{NW_OPS_PER_CELL_12} a cell {bound_12op:.4f} ms, share {bound_12op / ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None, "bound_ms_12op": bound_12op}


def check_count_kernels(reads: str, solid: np.ndarray, k: int, seed: int) -> tuple[dict, dict]:
    """K3 (+ the sort) on one default counting batch of 2^23 bases of the
    reads, joined by separators as the device counter joins them; K4
    merging the sorted batch into an accumulator of the donor's distinct
    k-mers at the counter's power-of-two capacity, and once truncated."""
    import torch

    from mindthegap_tpu_torch.find.scan_device import pack_codes_host
    from mindthegap_tpu_torch.io.bank import iter_codes
    from mindthegap_tpu_torch.ops import counting_device as C
    from mindthegap_tpu_torch.ops import kmers as K
    from torch_tables import key_edge_batches, merge_edge_cases

    batch = 1 << 23
    buf = np.full(batch, C.SEP, np.uint8)
    fill = 0
    for _h, codes in iter_codes(reads):
        if fill + codes.size + 1 > batch:
            break
        buf[fill:fill + codes.size] = codes
        fill += codes.size + 1
    packed, bad = (torch.from_numpy(a).cuda() for a in pack_codes_host(buf))
    got = C.kmer_keys_cuda(packed, bad, k)
    want = C._kmer_keys_plain(packed, bad, k)
    torch.cuda.synchronize()
    errs3 = [_max_abs_err([(got, want)])]
    ms3 = _cuda_ms(lambda: C.kmer_keys_cuda(packed, bad, k), iters=20, warmup=2)
    plain3 = _cuda_ms(lambda: C._kmer_keys_plain(packed, bad, k), iters=3)
    sort_ms = _cuda_ms(lambda: C.sort_batch(packed, bad, k), iters=10)
    bound3 = _bytes_bound_ms(_nbytes(packed, bad, got))
    print(f"K3 kmer_keys: batch {batch} bases ({fill} filled), k {k}, max_abs_err {errs3[0]} "
          f"(tolerance 0: exact), kernel {ms3:.4f} ms, plain {plain3:.4f} ms; "
          f"sort_batch (K3 + torch.sort) {sort_ms:.4f} ms; bound {bound3['bound_ms']:.4f} ms (bytes)")
    for name, (ecodes, ek) in key_edge_batches().items():
        ep, eb = (torch.from_numpy(a).cuda() for a in pack_codes_host(ecodes))
        errs3.append(_max_abs_err([(C.kmer_keys_cuda(ep, eb, ek), C._kmer_keys_plain(ep, eb, ek))]))
    print(f"K3 edge cases ({len(errs3) - 1} batches, k 1 to 32): max_abs_err {max(errs3[1:])}")

    b = C.sort_batch(packed, bad, k)
    rng = np.random.default_rng(seed)
    cap = 1 << (solid.size - 1).bit_length()
    acc_k = torch.full((cap,), C.BIASED_SENTINEL, dtype=torch.int64)
    acc_k[: solid.size] = torch.from_numpy(K.as_i64(solid) ^ K.SIGN_BIT)
    acc_c = torch.zeros(cap, dtype=torch.int64)
    acc_c[: solid.size] = torch.from_numpy(rng.integers(1, 60, solid.size))
    acc_k, acc_c = acc_k.cuda(), acc_c.cuda()
    errs = []
    for out_cap in (cap, cap // 2):
        got = C.merge_sorted_cuda(acc_k, acc_c, b, out_cap)
        want = C._merge_sorted_plain(acc_k, acc_c, b, out_cap)
        torch.cuda.synchronize()
        errs.append(_max_abs_err(zip(got, want)))
        nd = int(want[2])
    if nd <= cap // 2:
        raise AssertionError(f"the truncated merge did not truncate: {nd} distinct, out_cap {cap // 2}")
    for name, (ek, ec, eb, e_cap) in merge_edge_cases().items():
        args = (torch.from_numpy(K.as_i64(ek) ^ K.SIGN_BIT).cuda(), torch.from_numpy(ec).cuda(),
                torch.from_numpy(K.as_i64(eb) ^ K.SIGN_BIT).cuda())
        got = C.merge_sorted_cuda(*args, e_cap)
        want = C._merge_sorted_plain(*args, e_cap)
        torch.cuda.synchronize()
        errs.append(_max_abs_err(zip(got, want)))
        print(f"K4 edge case {name}: accumulator {ek.size}, batch {eb.size}, out_cap {e_cap}, "
              f"{int(want[2])} distinct, max_abs_err {errs[-1]}")
    err4 = max(errs)
    ms4 = _cuda_ms(lambda: C.merge_sorted_cuda(acc_k, acc_c, b, cap), iters=10, warmup=2)
    plain4 = _cuda_ms(lambda: C._merge_sorted_plain(acc_k, acc_c, b, cap), iters=3)
    # inputs read once, outputs written once
    bound4 = _bytes_bound_ms(_nbytes(acc_k, acc_c, b) + cap * 16 + 4)
    print(f"K4 merge_sorted: accumulator {solid.size} distinct of {cap}, batch {b.numel()}, "
          f"out_cap {cap} and {cap // 2} (truncated, {nd} distinct), max_abs_err {err4} "
          f"(tolerance 0: exact), kernel {ms4:.4f} ms, plain {plain4:.4f} ms, "
          f"bound {bound4['bound_ms']:.4f} ms (bytes)")
    return ({"max_abs_err": max(errs3), "ms": ms3, "plain_ms": plain3, **bound3, "sort_batch_ms": sort_ms},
            {"max_abs_err": err4, "ms": ms4, "plain_ms": plain4, **bound4})


def check_walk_kernel(donor: np.ndarray, solid: np.ndarray, k: int, seed: int) -> dict:
    """K5 on donor k-mers with a budget of 10,000 (fill's default
    -max-length) for the walker's largest step count, over the graph map of
    the donor's solid set, both layouts: at 4,096 lanes (the record's
    `ms`, `plain_ms`, `bound_ms`, `bucket_ms` and `bucket_plain_ms`, as
    before the look-ahead), 128 lanes (the fill's ~100 breakpoints, padded)
    and 1 lane (the chain latency), each exact against the plain version
    and listed under "shapes" with its us per step; then the look-ahead's
    edge cases at every depth."""
    import torch

    from mindthegap_tpu_torch.fill import walk_device as W
    from mindthegap_tpu_torch.bounds import walk_bound_ms
    from mindthegap_tpu_torch.ops import extmap as X
    from mindthegap_tpu_torch.ops import kmers as K
    from torch_tables import edge_walk_case

    rng = np.random.default_rng(seed)
    fwd, _ = K.kmers_from_codes(donor, k)
    picks = fwd[rng.integers(0, fwd.size, 4096)]
    steps = 2048
    shapes, errs = {}, []
    for layout, build in (("cuckoo", X.build_fused), ("bucket", X.build_fused_bucket)):
        host = build(solid, k, np.zeros(0, np.uint64))
        t = host.to("cuda")
        log = host.log_nb if layout == "bucket" else host.log_size
        for lanes in (4096, 128, 1):
            nodes = torch.from_numpy(K.as_i64(picks[:lanes])).cuda()
            budgets = torch.full((lanes,), 10_000, dtype=torch.int32).cuda()
            args = (nodes, budgets, t.slots, t.stash_keys, t.stash_payload, log, k, steps, layout)
            got = W.walk_batch_cuda(*args)
            t0 = time.perf_counter()
            want = W._walk_batch_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            errs.append(_max_abs_err(zip(got, want)))
            ms = _cuda_ms(lambda: W.walk_batch_cuda(*args), iters=10 if lanes < 4096 else 5)
            walked = int(got[1].max())
            row = {"layout": layout, "lanes": lanes, "depth": W.lookahead_depth(lanes, layout),
                   "ms": ms, "plain_ms": plain_ms, "us_per_step": ms * 1e3 / walked,
                   "bound_ms": walk_bound_ms(got[1], got[3], lanes, steps, layout)}
            shapes[layout, lanes] = row
            print(f"K5 walk_batch ({layout}): {lanes} lanes, {steps} steps, D = {row['depth']}, "
                  f"{int(got[1].sum())} bases appended, table {host.nbytes >> 20} MB, "
                  f"max_abs_err {errs[-1]} (tolerance 0: exact), kernel {ms:.4f} ms "
                  f"({row['us_per_step']:.4f} us per step), plain {plain_ms:.1f} ms (one call), "
                  f"bound {row['bound_ms']:.4f} ms (bytes)")
    for layout in ("cuckoo", "bucket"):
        for kk, lanes in ((9, 8), (31, 37), (32, 100)):
            _qm, args = edge_walk_case(layout, kk, lanes, "cuda")
            want = W._walk_batch_plain(*args)
            for depth in W.DEPTHS:
                got = W.walk_batch_cuda(*args, depth=depth)
                errs.append(_max_abs_err(zip(got, want)))
            print(f"K5 edge cases ({layout}, k {kk}, {lanes} lanes, depths {W.DEPTHS}): "
                  f"max_abs_err {max(errs[-len(W.DEPTHS):])}")
    cuckoo, bucket = shapes["cuckoo", 4096], shapes["bucket", 4096]
    return {"max_abs_err": max(errs), "ms": cuckoo["ms"], "plain_ms": cuckoo["plain_ms"],
            "bound_ms": cuckoo["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "bucket_ms": bucket["ms"], "bucket_plain_ms": bucket["plain_ms"],
            "bucket_bound_ms": bucket["bound_ms"], "shapes": list(shapes.values())}


SPAN_K = 45  # the span phase's k (a (k-1)-mer of two words, a k-mer of two)


def span_solid(donor: np.ndarray, k: int):
    """(forward k-mer rows of the donor, its canonical k-mer rows sorted
    and unique): the solid set that error-free reads give at k > 32, made
    directly from the donor's k-mers, without counting."""
    from mindthegap_tpu_torch.ops.span import Span

    sp = Span(k)
    fwd, _ = sp.from_codes(donor)
    return fwd, sp.from_keys(np.unique(sp.keys(sp.canonical(fwd))))


def check_span_scan_kernel(ref: np.ndarray, solid: np.ndarray, k: int, seed: int):
    """K6 against its plain version on one full 2^21-base window of the
    reference (the span feed's window), over the span map of the donor's
    k-mers with a repeat set of every 50th (k-1)-mer of the window; then on
    its edge windows at k 33 to 256. Returns (the kernel record, the host
    map, so that K7's check reuses it)."""
    import torch

    from mindthegap_tpu_torch.bounds import SECTOR_BYTES, span_scan_sectors
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import extmap as X
    from mindthegap_tpu_torch.ops.span import Span
    from torch_tables import span_edge_windows

    window = 1 << 21
    spm1 = Span(k - 1)
    q, _ = spm1.from_codes(ref[:window])
    repeat = spm1.from_keys(np.unique(spm1.keys(spm1.canonical(q[::50]))))
    t0 = time.perf_counter()
    qms = X.build_fused_span(solid, k, repeat)
    build_s = time.perf_counter() - t0
    t = qms.to("cuda")
    codes = _span_window(ref, window, seed)
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    args = (packed, bad, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k)
    keys = ("pay8", "rep8", "str8")
    got = S.scan_pay_q_span_cuda(*args)
    want = S._scan_pay_q_span_plain(*args)
    torch.cuda.synchronize()
    errs = [_max_abs_err((got[key], want[key]) for key in keys)]
    ms = _cuda_ms(lambda: S.scan_pay_q_span_cuda(*args), iters=20, warmup=2)
    plain_ms = _cuda_ms(lambda: S._scan_pay_q_span_plain(*args), iters=3)
    # the sectors this window's probes need, the inputs read once and the
    # outputs written once
    sectors = span_scan_sectors(packed, bad, t, k)
    bound = _bytes_bound_ms(sectors * SECTOR_BYTES + _nbytes(packed, bad, *(got[key] for key in keys)))
    n_pay = window - k + 2
    print(f"K6 scan_pay_q_span: window {window}, k {k}, solid {solid.shape[0]}, table "
          f"{qms.nbytes >> 20} MB (built in {build_s:.1f} s on the host), stash {int(qms.stash_key64.size)}, "
          f"{int((want['pay8'] != 0).sum())} of {n_pay} payloads non-zero, max_abs_err {errs[0]} (tolerance 0: "
          f"exact), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms (bytes: "
          f"{sectors} sectors needed for {n_pay} probes, and loaded by the kernel)")
    for kk in (33, 45, 64, 65, 96, 128, 256):
        eq, cases = span_edge_windows(kk)
        te = eq.to("cuda")
        for name, ecodes in cases.items():
            ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(ecodes))
            eargs = (ep, eb, te.slots, te.sat, te.stash_key64, te.stash_sat, te.stash_payload, eq.salt,
                     eq.log_size, kk)
            g, w = S.scan_pay_q_span_cuda(*eargs), S._scan_pay_q_span_plain(*eargs)
            torch.cuda.synchronize()
            errs.append(_max_abs_err((g[key], w[key]) for key in keys))
        print(f"K6 edge cases (k {kk}: {', '.join(cases)}): max_abs_err {max(errs[-len(cases):])}")
    return ({"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, **bound, "sectors": sectors,
             "map_build_s": build_s}, qms)


def _span_window(ref: np.ndarray, window: int, seed: int) -> np.ndarray:
    """K6's and K16's window: the first `window` bases of the reference
    with an N run and 64 isolated Ns."""
    rng = np.random.default_rng(seed)
    codes = ref[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    return codes


def check_span_plane_kernel(ref: np.ndarray, qms, k: int, seed: int) -> dict:
    """K16 (scan_planes_q_span) against its plain version and against the
    route it replaces on the card (K6, then planes_from_pay_span on the
    host) on K6's 2^21-base window over K6's span map; then on K6's edge
    windows at k 33 to 256, over maps with and without a repeat set, and
    on its tile edges (tests/torch_tables.py span_tile_case)."""
    import torch

    from mindthegap_tpu_torch.bounds import plane_pass_bound_ms
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.kernel_bench import planes_equal_route
    from torch_tables import HALO_STATES, SPAN_TILE_CASES, span_edge_windows, span_tile_case

    window = 1 << 21
    codes = _span_window(ref, window, seed)
    t = qms.to("cuda")
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    args = (packed, bad, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k)
    got, want = S.scan_planes_q_span_cuda(*args), S._scan_planes_q_span_plain(*args)
    torch.cuda.synchronize()
    errs = [_max_abs_err((got[key], want[key]) for key in want)]

    def k6_route():
        r = S.scan_pay_q_span_cuda(*args)
        return S.planes_from_pay_span(*(r[key].cpu().numpy() for key in ("pay8", "rep8", "str8")), codes, k)

    t0 = time.perf_counter()
    if not planes_equal_route(got, k6_route()):
        raise AssertionError("K16's planes differ from K6 + planes_from_pay_span on the smoke's window")
    route_ms = (time.perf_counter() - t0) * 1e3
    ms = _cuda_ms(lambda: S.scan_planes_q_span_cuda(*args), iters=20, warmup=2)
    plain_ms = _cuda_ms(lambda: S._scan_planes_q_span_plain(*args), iters=3)
    copy_ms = _cuda_ms(lambda: {key: v.cpu() for key, v in S.scan_planes_q_span_cuda(*args).items()}, iters=5)
    bound_ms, sectors = plane_pass_bound_ms(packed, bad, t, k)
    print(f"K16 scan_planes_q_span: window {window}, k {k}, max_abs_err {errs[0]} (tolerance 0: exact), equal to K6 + "
          f"planes_from_pay_span; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the route K6 + planes_from_pay_span "
          f"{route_ms:.1f} ms to host planes (one call, the comparison with it included; K16 and the copy of its "
          f"planes to the host {copy_ms:.4f} ms), bound "
          f"{bound_ms:.4f} ms (bytes: {sectors} sectors and the planes), share {bound_ms / ms:.4f}")
    for kk in (33, 45, 64, 65, 96, 128, 129, 256):
        kerrs = []
        for repeats in (True, False):
            eq, cases = span_edge_windows(kk, repeats=repeats)
            te = eq.to("cuda")
            for ecodes in cases.values():
                ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(ecodes))
                eargs = (ep, eb, te.slots, te.sat, te.stash_key64, te.stash_sat, te.stash_payload, eq.salt,
                         eq.log_size, kk)
                g, w = S.scan_planes_q_span_cuda(*eargs), S._scan_planes_q_span_plain(*eargs)
                kerrs.append(_max_abs_err((g[key], w[key]) for key in w))
        torch.cuda.synchronize()
        errs += kerrs
        print(f"K16 edge cases (k {kk}: {', '.join(cases)}, with and without a repeat set): max_abs_err {max(kerrs)}")
    kerrs = []
    for kk, side in SPAN_TILE_CASES:  # its tile edges: P at and around a tile's end, every halo in each state
        for state in HALO_STATES:
            eq, ecodes = span_tile_case(kk, side, state)
            te = eq.to("cuda")
            ep, eb = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(ecodes))
            eargs = (ep, eb, te.slots, te.sat, te.stash_key64, te.stash_sat, te.stash_payload, eq.salt, eq.log_size, kk)
            g, w = S.scan_planes_q_span_cuda(*eargs), S._scan_planes_q_span_plain(*eargs)
            kerrs.append(_max_abs_err((g[key], w[key]) for key in w))
    torch.cuda.synchronize()
    errs += kerrs
    print(f"K16 tile edges (k, side: {SPAN_TILE_CASES}; {', '.join(HALO_STATES)}): max_abs_err {max(kerrs)}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "sectors": sectors, "replaced_route": "K6 + planes_from_pay_span",
            "replaced_route_ms": route_ms, "ms_with_copy": copy_ms}


def check_span_walk_kernel(fwd: np.ndarray, qms, k: int, seed: int) -> dict:
    """K7 on donor k-mers with a budget of 10,000 for the walker's largest
    step count, over the span map of K6's check, at 4,096 lanes (the
    record's `ms`, `plain_ms` and `bound_ms`), 128 lanes (the fill's shape)
    and 1 lane (the chain latency), each at the look-ahead depth its rule
    picks, exact against the plain version and listed under "shapes"; then
    on its edge cases at k 33 to 256 at every depth."""
    import torch

    from mindthegap_tpu_torch.bounds import walk_span_bound_ms
    from mindthegap_tpu_torch.fill import walk_device as W
    from mindthegap_tpu_torch.ops import kmers as K
    from mindthegap_tpu_torch.ops.span_device import span_width
    from torch_tables import edge_walk_span_case

    rng = np.random.default_rng(seed)
    picks = fwd[rng.integers(0, fwd.shape[0], 4096)]
    t = qms.to("cuda")
    steps = 2048
    shapes, errs = [], []
    for lanes in (4096, 128, 1):
        nodes = torch.from_numpy(K.as_i64(picks[:lanes])).cuda()
        budgets = torch.full((lanes,), 10_000, dtype=torch.int32).cuda()
        args = (nodes, budgets, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt,
                qms.log_size, k, steps)
        got = W.walk_batch_span_cuda(*args)
        t0 = time.perf_counter()
        want = W._walk_batch_span_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs.append(_max_abs_err(zip(got, want)))
        ms = _cuda_ms(lambda: W.walk_batch_span_cuda(*args), iters=10 if lanes < 4096 else 5)
        walked = int(got[1].max())
        row = {"lanes": lanes, "depth": W.lookahead_depth(lanes, "span", span_width(k - 1)), "ms": ms,
               "plain_ms": plain_ms, "us_per_step": ms * 1e3 / max(walked, 1),
               "bound_ms": walk_span_bound_ms(got[1], got[3], lanes, steps, k)}
        shapes.append(row)
        print(f"K7 walk_batch_span: {lanes} lanes, {steps} steps, k {k}, D = {row['depth']}, "
              f"{int(got[1].sum())} bases appended, "
              f"max_abs_err {errs[-1]} (tolerance 0: exact), kernel {ms:.4f} ms ({row['us_per_step']:.4f} us "
              f"per step), plain {plain_ms:.1f} ms (one call), bound {row['bound_ms']:.4f} ms (bytes)")
    for kk, lanes in ((33, 48), (45, 37), (64, 8), (65, 100), (96, 64), (128, 40), (256, 33)):
        _q, eargs = edge_walk_span_case(kk, lanes, "cuda")
        w = W._walk_batch_span_plain(*eargs)
        for depth in W.DEPTHS:
            g = W.walk_batch_span_cuda(*eargs, depth=depth)
            torch.cuda.synchronize()
            errs.append(_max_abs_err(zip(g, w)))
        print(f"K7 edge case (k {kk}, {lanes} lanes, depths {W.DEPTHS}, rule "
              f"{W.lookahead_depth(lanes, 'span', span_width(kk - 1))}): max_abs_err {max(errs[-len(W.DEPTHS):])}")
    big = shapes[0]
    return {"max_abs_err": max(errs), "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shapes": shapes}


def _run(cmd: list[str], cwd: str) -> float:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {r.returncode}\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return time.perf_counter() - t0


def _records(path: str):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def _same(a: str, b: str) -> bool:
    with open(a) as fa, open(b) as fb:
        return fa.read() == fb.read()


# kernels by name in a device trace: (label, substrings of the kernel names)
_TRACED = (("K3", ("kmer_keys",)), ("K4", ("partition_kernel", "merge_fold_kernel", "pad_kernel")),
           ("K5", ("walk_kernel",)), ("K6", ("scan_span_kernel",)), ("K7", ("walk_span_kernel",)),
           ("sort", ("radix", "Sort")))


def _device_ms(fn):
    """Run fn under torch.profiler: (its result, {label: device ms} for the
    kernels of _TRACED and "all" for every device event)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    times = {label: 0.0 for label, _ in _TRACED}
    times["all"] = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        times["all"] += us / 1e3
        for label, parts in _TRACED:
            if any(p in evt.key for p in parts):
                times[label] += us / 1e3
    return out, times


def _cli(args: list[str]) -> tuple[float, str]:
    """One in-process CLI run (so that the launch counters are readable):
    (wall seconds, the report it printed)."""
    from mindthegap_tpu_torch import cli

    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"{' '.join(args[:1])} exited {rc}: {report.getvalue()[-4000:]}")
    return time.perf_counter() - t0, report.getvalue()


def _phase(report: str, name: str) -> float:
    """Seconds of one -profile phase in a report."""
    return float(re.search(rf"^\s*{re.escape(name)}\s*:\s*([\d.]+) s", report, re.M).group(1))


def _reset_launches():
    """Set every kernel's launch count to 0; returns a reader of the counts."""
    from mindthegap_tpu_torch.fill import walk_device as W
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import counting_device as C
    from mindthegap_tpu_torch.ops import nw_device as ND
    from mindthegap_tpu_torch.ops import sorted_index as SI
    from mindthegap_tpu_torch.parallel import sharded_count as SC
    from mindthegap_tpu_torch.parallel import sharded_membership as SM

    wrappers = {"scan_cls_qp": S.scan_cls_qp_cuda, "nw_matches": ND.nw_matches_cuda,
                "kmer_keys": C.kmer_keys_cuda, "merge_sorted": C.merge_sorted_cuda,
                "walk_batch": W.walk_batch_cuda, "scan_pay_q_span": S.scan_pay_q_span_cuda,
                "walk_batch_span": W.walk_batch_span_cuda, "scan_planes_q": S.scan_planes_q_cuda,
                "scan_planes_qb": S.scan_planes_qb_cuda, "scan_pay_qp": S.scan_pay_qp_cuda,
                "swizzle_keys": SC.swizzle_keys_cuda, "member_route": SM.member_route_cuda,
                "member_probe": SM.member_probe_cuda, "member_scatter": SM.member_scatter_cuda,
                "scan_planes_sorted": S.scan_planes_sorted_cuda, "sorted_index": SI.build_cuda,
                "scan_planes_qp": S.scan_planes_qp_cuda, "scan_planes_q_span": S.scan_planes_q_span_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in wrappers.items()}


def main_path(work: str, insertions, reads: str) -> dict:
    """find -> fill -> nwalign --device on the E. coli-size case (ref.fa and
    the reads are in `work`); returns the kernel launch counts of the run
    and its times."""
    import torch

    from mindthegap_tpu_torch import nwalign
    from mindthegap_tpu_torch.ops import nw as N
    from mindthegap_tpu_torch.ops import nw_device as ND

    launches = _reset_launches()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        find_s, report = _cli(["find", "-in", reads, "-ref", "ref.fa", "-out", "t", "-profile"])
        fill_s = _run([sys.executable, "-m", "mindthegap_tpu_torch", "fill", "-graph", "t.h5",
                       "-bkpt", "t.breakpoints", "-out", "tf"], work)
        filled = filled_insertions("tf.insertions.fasta")
        pos, planted = next((p, s) for p, s in insertions
                            if any(abs(q - p) <= 20 and len(f) == s.size for _c, q, f in filled))
        got = next(f for _c, q, f in filled if abs(q - pos) <= 20 and len(f) == planted.size)
        planted_s = NUC[planted].tobytes().decode()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            nwalign.main(["--device"], stdin=io.StringIO(f"{got}\n{planted_s}\n"))
        nw_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = launches()

    nw_dev = float(out.getvalue().strip())
    nw_nat = N.nw_identity(got, planted_s)
    if nw_dev != nw_nat:
        raise AssertionError(f"nwalign --device {nw_dev} != native {nw_nat}")
    # K2 against its plain version at the shape nwalign gave it (one pair)
    seq, off = ND.pack_pairs([(got, planted_s)])
    k2, plain = ND.nw_matches_cuda(seq.cuda(), off.cuda()), ND._nw_matches_plain(seq.cuda(), off.cuda())
    if not torch.equal(k2, plain):
        raise AssertionError(f"K2 {k2.tolist()} != plain {plain.tolist()} on the nwalign pair")
    for name in ("scan_cls_qp", "nw_matches"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    cpu_s = _run([sys.executable, "-m", "mindthegap_tpu_torch", "find", "-graph", "t.h5",
                  "-ref", "ref.fa", "-out", "c", "-device", "cpu"], work)
    if not _same(os.path.join(work, "t.breakpoints"), os.path.join(work, "c.breakpoints")):
        raise AssertionError("find -device cpu wrote other .breakpoints than the CUDA run")
    if _records(os.path.join(work, "t.othervariants.vcf")) != _records(os.path.join(work, "c.othervariants.vcf")):
        raise AssertionError("find -device cpu wrote other VCF records than the CUDA run")
    recall = insertion_recall(insertions, filled)
    n_bkpt = sum(1 for line in open(os.path.join(work, "t.breakpoints")) if line.startswith(">")) // 2
    print(f"find (CUDA, graph built from reads, host counting): {find_s:.1f} s "
          f"(graph build {_phase(report, 'graph build'):.2f} s), {n_bkpt} breakpoints; "
          f"fill (native, subprocess): {fill_s:.1f} s, {len(filled)} insertions; "
          f"find -device cpu -graph: {cpu_s:.1f} s")
    print(f"nwalign --device: identity {nw_dev} (native {nw_nat}; K2 equals its plain version on this "
          f"{len(got)} x {len(planted_s)} pair), {nw_s:.2f} s")
    print(f"CUDA and CPU find outputs identical; insertion recall {recall:.4f} "
          f"({round(recall * len(insertions))}/{len(insertions)})")
    print(f"kernel launches on the main path: {counts}")
    if recall < 0.9:
        raise AssertionError(f"insertion recall {recall:.4f} is below 0.9")
    return {"launches": counts}


def device_path(work: str, insertions, reads: str) -> dict:
    """find -count-engine device, then fill -fill-engine device and
    device-qb (and the native fill, in-process for a comparable time), on
    the main path's data; held against the main path's host-count and
    native artifacts. Returns the kernel launch counts of the run."""
    from mindthegap_tpu_torch.graph.dbg import Graph

    def find(out):
        return _cli(["find", "-in", reads, "-ref", "ref.fa", "-count-engine", "device", "-out", out,
                     "-profile", "-verbose", "0"])

    def fill(out, engine):
        return _cli(["fill", "-graph", "d.h5", "-bkpt", "d.breakpoints", "-fill-engine", engine, "-out", out,
                     "-profile", "-verbose", "0"])

    launches = _reset_launches()
    cwd = os.getcwd()
    os.chdir(work)
    times, dev = {}, {}
    try:
        times["find"] = find("d")
        for out, engine in (("df", "device"), ("dq", "device-qb"), ("dn", "native")):
            times[out] = fill(out, engine)
        counts = launches()
        # the device-time breakdown in a second pass, so that the wall times
        # above are taken without the profiler
        _, dev["find"] = _device_ms(lambda: find("p"))
        for out, engine in (("df", "device"), ("dq", "device-qb")):
            _, dev[out] = _device_ms(lambda: fill("p" + out, engine))
    finally:
        os.chdir(cwd)

    def path(name):
        return os.path.join(work, name)

    host_g, dev_g = Graph.load(path("t.h5")), Graph.load(path("d.h5"))
    if not (np.array_equal(host_g.solid.keys, dev_g.solid.keys)
            and np.array_equal(host_g.solid.counts, dev_g.solid.counts) and host_g.info == dev_g.info):
        raise AssertionError("the device-count graph differs from the host-count graph")
    if not _same(path("t.breakpoints"), path("d.breakpoints")):
        raise AssertionError("find -count-engine device wrote other .breakpoints than host counting")
    if _records(path("t.othervariants.vcf")) != _records(path("d.othervariants.vcf")):
        raise AssertionError("find -count-engine device wrote other VCF records than host counting")
    for out in ("df", "dq", "dn"):
        for ext in ("insertions.fasta", "info.txt"):
            if not _same(path(f"tf.{ext}"), path(f"{out}.{ext}")):
                raise AssertionError(f"{out}.{ext} differs from the native fill's tf.{ext}")
        if _records(path("tf.insertions.vcf")) != _records(path(f"{out}.insertions.vcf")):
            raise AssertionError(f"{out}.insertions.vcf records differ from the native fill's")
    for name in ("kmer_keys", "merge_sorted", "walk_batch"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the device-engine path")
    recall = insertion_recall(insertions, filled_insertions(path("df.insertions.fasta")))
    find_s, report = times["find"]
    print(f"find -count-engine device: {find_s:.1f} s (graph build {_phase(report, 'graph build'):.2f} s); "
          "graph, breakpoints and VCF records equal the host-count run's")
    print("fill -graph d.h5 (in-process): " + ", ".join(
        f"{engine} {times[out][0]:.1f} s (fill jobs {_phase(times[out][1], 'fill jobs'):.2f} s)"
        for out, engine in (("dn", "native"), ("df", "device"), ("dq", "device-qb"))))
    print(f"device and device-qb fill artifacts equal the native fill's; insertion recall {recall:.4f}")
    print("device time (torch.profiler, a second pass, ms): " + "; ".join(
        f"{name} " + ", ".join(f"{label} {ms:.3f}" for label, ms in dev[key].items())
        for key, name in (("find", "find -count-engine device"), ("df", "fill device"),
                          ("dq", "fill device-qb"))))
    print(f"kernel launches on the device-engine path: {counts}")
    if recall < 0.9:
        raise AssertionError(f"insertion recall {recall:.4f} is below 0.9 on the device-engine path")
    return {"launches": counts}


SPAN_GENOME = 500_000  # the span phase's genome, cut for host span counting (~0.7 ms a read)


def span_path(work: str, seed: int) -> dict:
    """The CLI at k = 45 on its own case (a seeded genome of SPAN_GENOME bp
    with 11 insertions, 6 SNPs and 6 deletions, 30x): `find -kmer-size
    45` (K6 on CUDA), the native fill, `fill -fill-engine device` and
    `device-qb` (K7), all in-process; a `find -graph -device cpu` rerun as
    a subprocess; then `find -graph` and the two device fills again under
    torch.profiler (the device time of the path; its walls are the first
    run's). Returns the kernel launch counts of the first run."""
    sub = os.path.join(work, "span")
    os.makedirs(sub)
    ref, donor, insertions = make_case(SPAN_GENOME, n_ins=11, n_snp=6, n_del=6, seed=seed + 7)
    write_fasta(os.path.join(sub, "ref.fa"), CHROM, ref)
    reads = write_reads(os.path.join(sub, "reads"), donor, 30.0, seed + 8)
    k = str(SPAN_K)

    def fill(out, engine):
        return _cli(["fill", "-graph", "s.h5", "-bkpt", "s.breakpoints", "-fill-engine", engine, "-out", out,
                     "-profile", "-verbose", "0"])

    launches = _reset_launches()
    cwd = os.getcwd()
    os.chdir(sub)
    try:
        find_s, report = _cli(["find", "-in", reads, "-ref", "ref.fa", "-kmer-size", k, "-out", "s", "-profile",
                               "-verbose", "0"])
        times = {out: fill(out, engine) for out, engine in (("sn", "native"), ("sd", "device"), ("sq", "device-qb"))}
        counts = launches()
        # the device time of the path: the graph is built, so find -graph
        # redoes all of find's device work (the span map's upload and K6)
        dev = {"find": _device_ms(lambda: _cli(["find", "-graph", "s.h5", "-ref", "ref.fa", "-out", "ps",
                                                "-verbose", "0"]))[1]}
        for out, engine in (("sd", "device"), ("sq", "device-qb")):
            dev[out] = _device_ms(lambda: fill("p" + out, engine))[1]
        # the plane path at k = 45: K6, then planes_from_pay_span, into the
        # native automaton (device-qb) and the Python one (-automaton host)
        plane_launches = _reset_launches()
        planes = {out: _find_graph(out, *extra, graph="s.h5") for out, extra in (
            ("sqb", ("-scan-engine", "device-qb")), ("sah", ("-automaton", "host")),
            ("ssh", ("-scan-engine", "sharded")))}
        plane_counts = plane_launches()
    finally:
        os.chdir(cwd)
    cpu_s = _run([sys.executable, "-m", "mindthegap_tpu_torch", "find", "-graph", "s.h5", "-ref", "ref.fa",
                  "-out", "sc", "-device", "cpu", "-verbose", "0"], sub)

    def path(name):
        return os.path.join(sub, name)

    if not _same(path("s.breakpoints"), path("sc.breakpoints")):
        raise AssertionError("find -kmer-size 45 -device cpu wrote other .breakpoints than the CUDA run")
    if _records(path("s.othervariants.vcf")) != _records(path("sc.othervariants.vcf")):
        raise AssertionError("find -kmer-size 45 -device cpu wrote other VCF records than the CUDA run")
    for out in ("sd", "sq"):
        for ext in ("insertions.fasta", "info.txt"):
            if not _same(path(f"sn.{ext}"), path(f"{out}.{ext}")):
                raise AssertionError(f"{out}.{ext} differs from the native fill's sn.{ext} at k = 45")
        if _records(path("sn.insertions.vcf")) != _records(path(f"{out}.insertions.vcf")):
            raise AssertionError(f"{out}.insertions.vcf records differ from the native fill's at k = 45")
    for name in ("scan_pay_q_span", "walk_batch_span"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the k = 45 path")
    for out in planes:
        if not _equal_records(sub, "s", out):
            raise AssertionError(f"find -kmer-size 45 ({out}) wrote other records than the default run")
    if plane_counts["scan_pay_q_span"] <= 0:
        raise AssertionError("kernel scan_pay_q_span was not launched on the k = 45 plane path")
    filled = filled_insertions(path("sd.insertions.fasta"))
    recall = insertion_recall(insertions, filled)
    n_bkpt = sum(1 for line in open(path("s.breakpoints")) if line.startswith(">")) // 2
    print(f"k = {k} path: genome {ref.size} bp, {len(insertions)} insertions, 30x reads; find (CUDA) "
          f"{find_s:.1f} s (graph build, host span counting, {_phase(report, 'graph build'):.2f} s; scan engine "
          f"setup {_phase(report, 'scan engine setup'):.2f} s; scan+replay {_phase(report, 'scan+replay (fused)'):.2f} s), "
          f"{n_bkpt} breakpoints; find -graph -device cpu {cpu_s:.1f} s, equal")
    print("fill -graph s.h5 (in-process): " + ", ".join(
        f"{engine} {times[out][0]:.1f} s (fill jobs {_phase(times[out][1], 'fill jobs'):.2f} s)"
        for out, engine in (("sn", "native"), ("sd", "device"), ("sq", "device-qb"))))
    print(f"device and device-qb fill artifacts equal the native fill's at k = {k}; insertion recall "
          f"{recall:.4f} ({round(recall * len(insertions))}/{len(insertions)})")
    print(f"device time of the k = {k} path (torch.profiler, a second pass, ms): " + "; ".join(
        f"{name} " + ", ".join(f"{label} {ms:.3f}" for label, ms in dev[key].items() if ms or label == "all")
        for key, name in (("find", "find -graph"), ("sd", "fill device"), ("sq", "fill device-qb"))))
    print(f"kernel launches on the k = {k} path: {counts}")
    print(f"k = {k} plane path (find -graph, equal to the default run's records): "
          + ", ".join(f"{name} {planes[out][0]:.1f} s (setup + scan + replay {_scan_s(planes[out][1])[1]:.2f} s)"
                      for out, name in (("sqb", "-scan-engine device-qb"), ("sah", "-automaton host"),
                                        ("ssh", "-scan-engine sharded (the one-device mesh)")))
          + f"; kernel launches {plane_counts}")
    if recall < 0.9:
        raise AssertionError(f"insertion recall {recall:.4f} is below 0.9 on the k = {k} path")
    return {"launches": counts}


def _script_args(prefix: str) -> list[str]:
    return ["-g", f"{prefix}.h5", "-p", "ref.fa", "-b", f"{prefix}.breakpoints"]


def start_script_cpu(sub: str, prefix: str) -> subprocess.Popen:
    """context_genome_wg with `-device cpu` (the host plane pass) on the
    find outputs `prefix`.* in `sub`, started as a subprocess that writes
    ctx_cpu.breakpoints there."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-m", "mindthegap_tpu_torch.scripts.context_genome_wg",
                             *_script_args(prefix), "-o", "ctx_cpu.breakpoints", "-device", "cpu"],
                            cwd=sub, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def script_path(work: str, cpu31: subprocess.Popen) -> dict:
    """context_genome_wg (mindthegap_tpu_torch/scripts) on the outputs of
    the main path (t.h5, ref.fa and t.breakpoints, k = 31: K15 over the
    pair map) and of the k = 45 path (span/s.h5 ...: K16 over the span
    map): on the card in-process, beside the same command with `-device
    cpu` (the host plane pass) as a subprocess: at k = 31 `cpu31`, which
    main() started after the main path (it takes about a minute over the
    E. coli-size reference, hidden behind the phases between), at k = 45
    one started here. The two must write the same bytes and print the same
    line, and each kernel must launch at least once a window of the
    reference. Returns the launch counts of the card's runs and the
    phase's times."""
    from mindthegap_tpu_torch.io.bank import Bank
    from mindthegap_tpu_torch.scripts import context_genome_wg as C

    t_phase = time.perf_counter()
    counts, times = {}, {}
    for k, sub, prefix, kernel, window in ((31, work, "t", "scan_planes_qp", 1 << 22),
                                           (SPAN_K, os.path.join(work, "span"), "s", "scan_planes_q_span", 1 << 21)):
        args = _script_args(prefix)
        t0 = time.perf_counter()
        cpu = cpu31 if k == 31 else start_script_cpu(sub, prefix)
        try:
            launches = _reset_launches()
            cwd = os.getcwd()
            os.chdir(sub)
            report = io.StringIO()
            try:
                with contextlib.redirect_stdout(report):
                    rc = C.main(args + ["-o", "ctx_gpu.breakpoints"])
            finally:
                os.chdir(cwd)
            gpu_s = time.perf_counter() - t0
            counts[k] = launches()
        finally:
            cpu_out, cpu_err = cpu.communicate()
        cpu_s = time.perf_counter() - t0
        if rc != 0 or cpu.returncode != 0:
            raise RuntimeError(f"context_genome_wg exited {rc} on the card, {cpu.returncode} with -device cpu: "
                               f"{report.getvalue()[-2000:]}{cpu_err[-2000:]}")
        line = report.getvalue().strip()
        if line != cpu_out.strip() or not _same(os.path.join(sub, "ctx_gpu.breakpoints"),
                                                os.path.join(sub, "ctx_cpu.breakpoints")):
            raise AssertionError(f"context_genome_wg at k = {k} wrote other bytes on the card than with -device cpu "
                                 f"({line!r} against {cpu_out.strip()!r})")
        windows = sum(-(-(len(rec.seq) - k + 1) // (window - k + 1)) for rec in Bank.open(os.path.join(sub, "ref.fa")))
        if counts[k][kernel] < windows:
            raise AssertionError(f"{kernel} launched {counts[k][kernel]} times over the {windows} windows at k = {k}")
        times[k] = {"gpu_s": gpu_s, "cpu_s": cpu_s if k != 31 else None, "windows": windows,
                    "launches": counts[k][kernel], "line": line}
        cpu_note = ("started after the main path, waited for" if k == 31 else "a subprocess beside it") + f" {cpu_s:.1f} s"
        print(f"context_genome_wg at k = {k} on {prefix}.h5 ({line}): on the card {gpu_s:.1f} s ({kernel} launched "
              f"{counts[k][kernel]} times over {windows} windows), -device cpu {cpu_note}; the same bytes")
    wall = time.perf_counter() - t_phase
    print(f"script phase: {wall:.1f} s")
    return {"launches": {"scan_planes_qp": counts[31]["scan_planes_qp"],
                         "scan_planes_q_span": counts[SPAN_K]["scan_planes_q_span"]},
            "times": times, "wall_s": wall}


# the reference bases that `-scan-engine host` and `-automaton host` scan
# (the numpy oracle takes ~12 us a position over 4.67 M keys, the Python
# automaton ~4 us): a cut of the main path's 4.64 Mbp, over its whole graph
PLANE_CUT = 1_000_000
GATE_CUT = 16  # the auto gate's cut of the genome and its solid set: 1/16


def _find_graph(out: str, *extra: str, ref: str = "ref.fa", graph: str = "t.h5"):
    return _cli(["find", "-graph", graph, "-ref", ref, "-out", out, "-profile", "-verbose", "0", *extra])


def _scan_s(report: str) -> tuple[float, float]:
    """(seconds of the scan engine's setup, seconds from the end of the
    graph load to the records: the setup, the scan and the replay, fused
    or not)."""
    names = ("scan engine setup", "scan+replay (fused)", "scan planes", "automaton replay")
    total = sum(_phase(report, n) for n in names if re.search(rf"^\s*{re.escape(n)}\s*:", report, re.M))
    return _phase(report, "scan engine setup"), total


def _equal_records(work: str, a: str, b: str) -> bool:
    return (_same(os.path.join(work, a + ".breakpoints"), os.path.join(work, b + ".breakpoints"))
            and _records(os.path.join(work, a + ".othervariants.vcf"))
            == _records(os.path.join(work, b + ".othervariants.vcf")))


def _gate_case(ref: np.ndarray, donor: np.ndarray, k: int, cut: int):
    """(graph, repeat set, codes) of the first len/cut bases: the donor's
    k-mers there as the solid set (what error-free reads give)."""
    from mindthegap_tpu_torch.graph import dbg
    from mindthegap_tpu_torch.ops import kmers as K

    n = ref.size // cut
    fwd, _ = K.kmers_from_codes(donor[:n], k)
    graph = dbg.Graph(dbg.SolidSet(np.unique(K.canonical_u64(fwd, k)), k))
    q, _ = K.kmers_from_codes(ref[:n], k - 1)
    keys, counts = np.unique(K.canonical_u64(q, k - 1), return_counts=True)
    return graph, dbg.SolidSet(keys[counts >= 2], k - 1), ref[:n]


def _scan_route(graph, repeat_set, codes, k: int, route: str) -> tuple[float, str]:
    """One sequence through the scan engine's setup, the scan and the
    native automaton, as run_find drives them: route "host" (the host
    plane oracle, compute_planes) or "device" (the default feed: the pair
    map and K1). (Seconds, the breakpoint text.)"""
    import torch

    from mindthegap_tpu_torch.device import resolve_device
    from mindthegap_tpu_torch.find import native_scan
    from mindthegap_tpu_torch.find import runner as R

    device = resolve_device(None)
    seq = LETTERS[codes].tobytes().decode()
    t0 = time.perf_counter()
    sc = native_scan.NativeScanner(graph, repeat_set, k, max_repeat=5, snp_min_val=5, branching_threshold=15,
                                   homo_only=False, snp=True, deletion=True, small_homo=True, homo_insert=True,
                                   backup=False, hete_insert=True)
    if route == "host":
        sc.scan_sequence(CHROM, seq, R._make_plane_fn("host", graph, repeat_set, k, device, [device])(codes))
    else:
        sc.scan_sequence_pay(CHROM, seq, R._make_pay_feed_fn(graph, repeat_set, k, device)(codes))
    torch.cuda.synchronize()
    bkpt = sc.results()[0]
    sc.close()
    return time.perf_counter() - t0, bkpt


def plane_path(work: str, ref: np.ndarray, donor: np.ndarray) -> dict:
    """The plane path of find on the main path's graph (t.h5, so nothing is
    counted again), in-process: `-scan-engine device` (K8) and `device-qb`
    (K9) over the whole reference, each held to the main path's records
    (t.breakpoints, the VCF records); `-scan-engine host` (the host oracle)
    and `-automaton host` (K10's dense stream, planes_from_pay, the Python
    automaton) over its first PLANE_CUT bases, held to a default run (K1)
    there; K1's feed at exc_cap 0 (every window re-dispatched through
    K10) into the native automaton over the whole reference; then the
    `auto` gate: the host plane route against the default feed, at the
    graph's solid-set size (the runs on the cut) and on a 1/GATE_CUT cut
    of the genome and its solid set. Returns the kernel launch counts of
    the run and the gate's times."""
    from mindthegap_tpu_torch.device import resolve_device
    from mindthegap_tpu_torch.find import native_scan
    from mindthegap_tpu_torch.find import runner as R
    from mindthegap_tpu_torch.graph import dbg
    from mindthegap_tpu_torch.io.bank import Bank
    from mindthegap_tpu_torch.utils import dna

    write_fasta(os.path.join(work, "ref_cut.fa"), CHROM, ref[:PLANE_CUT])
    launches = _reset_launches()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        times = {out: _find_graph(out, *extra) for out, extra in (
            ("pd", ("-scan-engine", "device")), ("pq", ("-scan-engine", "device-qb")))}
        for out, extra in (("pcut", ()), ("ph", ("-scan-engine", "host")), ("pa", ("-automaton", "host"))):
            times[out] = _find_graph(out, *extra, ref="ref_cut.fa")
        t0 = time.perf_counter()
        graph = dbg.Graph.load("t.h5")
        k = graph.k
        repeat_set = dbg.build_repeat_set("ref.fa", k - 1, 2)
        feed = R._make_pay_feed_fn(graph, repeat_set, k, resolve_device(None), exc_cap=0)
        sc = native_scan.NativeScanner(graph, repeat_set, k, max_repeat=5, snp_min_val=5, branching_threshold=15,
                                       homo_only=False, snp=True, deletion=True, small_homo=True, homo_insert=True,
                                       backup=False, hete_insert=True)
        for rec in Bank.open("ref.fa"):
            sc.scan_sequence_pay(rec.comment_short, rec.seq, feed(dna.seq_to_codes(rec.seq)))
        dense_bkpt, dense_vcf, _ = sc.results()
        sc.close()
        dense_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = launches()
    n_solid = len(graph.solid)
    del graph, repeat_set, feed

    for out in ("pd", "pq"):
        if not _equal_records(work, "t", out):
            raise AssertionError(f"find -graph ({out}) wrote other records than the main path's find")
    for out in ("ph", "pa"):
        if not _equal_records(work, "pcut", out):
            raise AssertionError(f"find -graph ({out}) wrote other records than the default find on the cut")
    with open(os.path.join(work, "t.breakpoints")) as f:
        if dense_bkpt != f.read():
            raise AssertionError("K1's feed at exc_cap 0 (K10 dense) wrote other .breakpoints than the main path")
    if dense_vcf.splitlines(keepends=True) != _records(os.path.join(work, "t.othervariants.vcf")):
        raise AssertionError("K1's feed at exc_cap 0 (K10 dense) wrote other VCF records than the main path")
    for name in ("scan_planes_q", "scan_planes_qb", "scan_pay_qp"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the plane path")

    def wall(out):
        setup, scan = _scan_s(times[out][1])
        return f"{times[out][0]:.1f} s (scan engine setup {setup:.2f} s, setup + scan + replay {scan:.2f} s)"

    n_pa = sum(1 for line in open(os.path.join(work, "pa.breakpoints")) if line.startswith(">")) // 2
    print("plane path on the main path's graph (find -graph, in-process), equal to the main path's records: "
          f"-scan-engine device (K8) {wall('pd')}, -scan-engine device-qb (K9) {wall('pq')}")
    print(f"on the first {PLANE_CUT} bases, equal to the default run there ({wall('pcut')}): -scan-engine host "
          f"{wall('ph')}; -automaton host (K10, planes_from_pay, the Python automaton) {wall('pa')}, of which the "
          f"Python automaton {_phase(times['pa'][1], 'automaton replay'):.2f} s, {n_pa} breakpoints")
    print(f"K1's feed at exc_cap 0 (every window dense through K10), whole reference: {dense_s:.1f} s, equal to the "
          "main path's records")
    print(f"kernel launches on the plane path: {counts}")

    gate = {"graph": {"solid": n_solid, "bases": min(PLANE_CUT, ref.size), "host_s": _scan_s(times["ph"][1])[1],
                      "device_s": _scan_s(times["pcut"][1])[1]}}
    graph, repeat_set, codes = _gate_case(ref, donor, k, GATE_CUT)
    host_s, host_bkpt = _scan_route(graph, repeat_set, codes, k, "host")
    dev_s, dev_bkpt = _scan_route(graph, repeat_set, codes, k, "device")
    if host_bkpt != dev_bkpt:
        raise AssertionError(f"the host and device scan routes disagree on the 1/{GATE_CUT} cut")
    gate[f"1/{GATE_CUT}"] = {"solid": len(graph.solid), "bases": int(codes.size), "host_s": host_s, "device_s": dev_s}
    print("auto gate, host plane route against the default feed (setup + scan + native replay, s): " + "; ".join(
        f"{name}: {g['bases']} bases, solid {g['solid']}, host {g['host_s']:.2f}, device {g['device_s']:.2f}"
        for name, g in gate.items()))
    return {"launches": counts, "gate": gate}


MESH_SHARDS = 4  # the logical shards of the card in the mesh phase
MEMBER_POSITIONS = 1 << 20  # K12/K13: the nine queries a position of this many reference positions


def _flush_buffer(reads: str, n: int) -> np.ndarray:
    """The first n bases of the reads as a counter's buffer holds them:
    reads joined by an invalid base, the tail invalid."""
    from mindthegap_tpu_torch.io.bank import iter_codes

    buf = np.full(n, 255, np.uint8)
    fill = 0
    for _h, codes in iter_codes(reads):
        if fill + codes.size + 1 > n:
            break
        buf[fill:fill + codes.size] = codes
        fill += codes.size + 1
    return buf


def _member_stages(sm, rows: np.ndarray, cap: int) -> tuple[int, list]:
    """K12 on each shard, K13's probe on each owner (through the owner's
    bucket index, and through one its wrapper builds) and its scatter on
    each source, each against its plain version on the same inputs: (the
    largest difference, the inputs of shard 0's route, owner 0's probe and
    shard 0's scatter, for the timings)."""
    from mindthegap_tpu_torch.parallel import mesh as M
    from mindthegap_tpu_torch.parallel import sharded_membership as SM

    n = sm.n_dev
    errs, routed = [], []
    for j in range(n):
        args = sm.route_args(j, rows, cap)
        got = SM.member_route_cuda(*args)
        errs.append(_max_abs_err(zip(got, SM._route_plain(*args))))
        routed.append(got)
    recv = M.exchange([r[0].reshape(n, cap) for r in routed], sm.mesh)
    found = []
    for o in range(n):
        got = SM.member_probe_cuda(recv[o], sm.shard_keys[o], sm.shard_index[o])
        want = SM._probe_plain(recv[o], sm.shard_keys[o])
        errs.append(_max_abs_err([(got, want), (SM.member_probe_cuda(recv[o], sm.shard_keys[o]), want)]))
        found.append(got.reshape(n, cap))
    back = M.exchange(found, sm.mesh)
    for d in range(n):
        got = SM.member_scatter_cuda(back[d], routed[d][1], rows.shape[1])
        errs.append(_max_abs_err([(got, SM._scatter_plain(back[d], routed[d][1], rows.shape[1]))]))
    return max(errs), [sm.route_args(0, rows, cap), (recv[0], sm.shard_keys[0], sm.shard_index[0]),
                       (back[0], routed[0][1], rows.shape[1]), int(routed[0][2].item())]


def check_mesh_kernels(ref: np.ndarray, solid: np.ndarray, reads: str, k: int, seed: int) -> dict:
    """K11 (swizzle_keys) on one 2^23-base flush of the reads, on 1 and
    MESH_SHARDS logical shards; K12 (member_route) and K13 (member_probe,
    member_scatter) on the nine queries a position of MEMBER_POSITIONS
    reference positions over the solid set on MESH_SHARDS logical shards,
    and once with the capacity forced to overflow (cap_factor 0: the host
    route); K14 (scan_planes_sorted) on a 2^22-base window of the reference
    over the sorted solid set and a repeat set, and at entry()'s shapes;
    then each kernel's edge cases (tests/torch_tables.py), and the sharded
    counter on MESH_SHARDS logical shards with its capacity forced to
    overflow, against the host counter. Returns {name: record}."""
    import torch

    from mindthegap_tpu_torch import graft_entry as G
    from mindthegap_tpu_torch.bounds import bloom_probe_loads, scatter_bytes, scan_sorted_sectors, sorted_lookup_sectors
    from mindthegap_tpu_torch.device import stage_ms
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import counting as CNT
    from mindthegap_tpu_torch.ops import kmers as K
    from mindthegap_tpu_torch.ops import sorted_index as SI
    from mindthegap_tpu_torch.parallel import sharded_count as SC
    from mindthegap_tpu_torch.parallel import sharded_membership as SM
    from torch_tables import (index_edge_sets, member_edge_cases, route_edge_cases, scatter_edge_cases,
                              sorted_edge_windows, swizzle_edge_chunks)

    cuda = torch.device("cuda")
    out = {}

    # K11: one flush of 2^23 bases (and its k - 1 halo), whole and cut in MESH_SHARDS chunks
    flush = 1 << 23
    buf = _flush_buffer(reads, flush + k - 1)
    const = SC.pick_swizzle_const(k)
    errs = []
    for n in (1, MESH_SHARDS):
        c = flush // n
        for i in range(n):
            chunk = torch.from_numpy(buf[i * c : (i + 1) * c + k - 1]).to(cuda)
            errs.append(_max_abs_err(zip(SC.swizzle_keys_cuda(chunk, k, const),
                                         SC._swizzle_keys_plain(chunk, k, const))))
        times = (_cuda_ms(lambda: SC.swizzle_keys_cuda(chunk, k, const), iters=20, warmup=2),
                 _cuda_ms(lambda: SC._swizzle_keys_plain(chunk, k, const), iters=3))
        if n == 1:
            ms, plain_ms = times
            bound = _bytes_bound_ms(chunk.numel() + 16 * c)
        print(f"K11 swizzle_keys: {n} shard(s) of {c} windows, kernel {times[0]:.4f} ms, "
              f"plain {times[1]:.4f} ms a chunk")
    for ek in (1, 2, 3, 31, 32):
        ec = SC.pick_swizzle_const(ek)
        for name, codes in swizzle_edge_chunks(ek).items():
            t = torch.from_numpy(codes).to(cuda)
            odd = torch.empty(t.numel() + 1, dtype=torch.uint8, device=cuda)
            odd[1:] = t  # a view at an odd byte offset: every unit staged byte by byte
            want = SC._swizzle_keys_plain(t, ek, ec)
            for view in (t, odd[1:]):
                errs.append(_max_abs_err(zip(SC.swizzle_keys_cuda(view, ek, ec), want)))
    torch.cuda.synchronize()
    out["swizzle_keys"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, **bound}
    print(f"K11: a 2^23-base flush, k {k}, max_abs_err {max(errs)} over it, its {MESH_SHARDS} chunks and the edge "
          f"chunks at k 1, 2, 3, 31, 32, each also at an odd byte offset (tolerance 0: exact); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms (bytes)")

    # K12 / K13: the nine membership queries of MEMBER_POSITIONS positions, as sharded-mem sends them
    fwd, _ = K.kmers_from_codes(ref[: MEMBER_POSITIONS + k - 1], k)
    mask, shift_hi = K.kmer_mask(k), np.uint64(2 * (k - 1))
    q = np.concatenate([K.canonical_u64(fwd, k)]
                       + [K.canonical_u64(((fwd << np.uint64(2)) | np.uint64(x)) & mask, k) for x in range(4)]
                       + [K.canonical_u64((fwd >> np.uint64(2)) | (np.uint64(x) << shift_hi), k) for x in range(4)])
    mesh = [cuda] * MESH_SHARDS
    sm = SM.ShardedMembership(mesh, solid)
    rows, cap = sm.batch(q)
    err, (route_args, probe_args, scatter_args, overflow) = _member_stages(sm, rows, cap)
    got = sm.contains(q)
    idx = np.minimum(np.searchsorted(solid, q), solid.size - 1)
    if overflow or not np.array_equal(got, solid[idx] == q):
        raise AssertionError(f"sharded membership: overflow {overflow}, or its verdicts differ from the host search")
    recv, keys, index = probe_args
    lanes, m, per = rows.shape[1], recv.numel(), keys.numel()
    records = {
        "member_route": (SM.member_route_cuda, SM._route_plain, route_args,
                         8 * lanes + sm._replicated[0][0].numel() * 4 + 8 * MESH_SHARDS + 12 * MESH_SHARDS * cap),
        "member_probe": (SM.member_probe_cuda, lambda recv, keys, _index: SM._probe_plain(recv, keys), probe_args,
                         8 * m + 8 * per + m),
        "member_scatter": (SM.member_scatter_cuda, SM._scatter_plain, scatter_args,
                           scatter_bytes(scatter_args[1], lanes, scatter_args[0].data_ptr())),
    }
    # the library yardstick of the probe: torch.searchsorted, the gather and the compare (the
    # shard's keys lie below 2^63, so signed order is their order)
    lib_found = keys[torch.searchsorted(keys, recv).clamp_(max=per - 1)] == recv
    if not torch.equal(lib_found, SM.member_probe_cuda(recv, keys) != 0):
        raise AssertionError("torch.searchsorted's verdicts differ from K13's")
    library = {"member_probe": _cuda_ms(lambda: keys[torch.searchsorted(keys, recv).clamp_(max=per - 1)] == recv,
                                        iters=10, warmup=2)}
    for name, (kern, plain, args, nbytes) in records.items():
        out[name] = {"max_abs_err": err, "ms": _cuda_ms(lambda: kern(*args), iters=10, warmup=2),
                     "plain_ms": _cuda_ms(lambda: plain(*args), iters=3), **_bytes_bound_ms(nbytes)}
        out[name]["library_ms"] = library.get(name)
    over = SM.ShardedMembership(mesh, solid, cap_factor=0.0)
    orows, ocap = over.batch(q[: 1 << 18])
    over_err, (*_, over_flag) = _member_stages(over, orows, ocap)
    if not over_flag or not np.array_equal(over.contains(q[: 1 << 18]), np.isin(q[: 1 << 18], solid)):
        raise AssertionError("the forced overflow of sharded membership did not overflow, or its host route erred")
    edge_errs = [over_err]
    for name, (ekeys, eq, en, ecf) in {**member_edge_cases(), **route_edge_cases()}.items():
        esm = SM.ShardedMembership([cuda] * en, ekeys, cap_factor=ecf)
        erows, ecap = esm.batch(eq)
        edge_errs.append(_member_stages(esm, erows, ecap)[0])
        if not np.array_equal(esm.contains(eq), np.isin(eq, ekeys)):
            raise AssertionError(f"sharded membership edge case {name} differs from np.isin")
    # K13's scatter on its own edge cases
    for eb, el, elanes in scatter_edge_cases().values():
        eb, el = torch.from_numpy(eb).to(cuda), torch.from_numpy(el).to(cuda)
        edge_errs.append(_max_abs_err([(SM.member_scatter_cuda(eb, el, elanes), SM._scatter_plain(eb, el, elanes))]))
    for name in records:
        out[name]["max_abs_err"] = max(err, *edge_errs)
    # K13's scatter is shorter on the card than its wrapper on the host: CUDA events around the wrapper time the
    # host's launch rate, so its time (and the library call's) is the device time of its launches (torch.profiler);
    # the library call, index_put_ on zeroed lanes, has its real slots picked outside the timing
    s_back, s_lane, s_lanes = scatter_args
    s_real = s_lane >= 0
    lane_real, verdict_real = s_lane[s_real].long(), s_back[s_real] != 0

    def lib_scatter():
        return torch.zeros(s_lanes, dtype=torch.bool, device=cuda).index_put_((lane_real,), verdict_real)

    if not torch.equal(lib_scatter(), SM.member_scatter_cuda(*scatter_args)):
        raise AssertionError("index_put_'s lanes differ from K13's scatter")
    scatter_stages = stage_ms(lambda: SM.member_scatter_cuda(*scatter_args), iters=20)
    lib_stages = stage_ms(lib_scatter, iters=20)
    rec = out["member_scatter"]
    rec.update(events_ms=rec["ms"], ms=sum(scatter_stages.values()), library_ms=sum(lib_stages.values()),
               library_events_ms=_cuda_ms(lib_scatter, iters=10, warmup=2),
               ms_covers="device time by launch (torch.profiler): the memset and the kernel; library_ms likewise "
                         "(the zeros and index_put_); events_ms: CUDA events around the wrapper")
    print(f"K13 member_scatter on shard 0: {int(s_real.sum())} of {s_lane.numel()} slots real, {s_lanes} lanes; "
          "device time by launch (torch.profiler, ms a call) "
          + ", ".join(f"{name} {t:.4f}" for name, t in scatter_stages.items())
          + f" = {rec['ms']:.4f} ms (CUDA events around the wrapper {rec['events_ms']:.4f}); index_put_ "
          + ", ".join(f"{name} {t:.4f}" for name, t in lib_stages.items())
          + f" = {rec['library_ms']:.4f} ms (events {rec['library_events_ms']:.4f}); the edge cases max_abs_err "
          f"{max(edge_errs)}")
    # K13's probe with the index its wrapper builds, the build apart (torch.profiler), and its sectors
    probe_stages = stage_ms(lambda: SM.member_probe_cuda(recv, keys), iters=10)
    sectors = sorted_lookup_sectors(keys, index, recv)
    out["member_probe"]["unindexed_ms"] = _cuda_ms(lambda: SM.member_probe_cuda(recv, keys), iters=10, warmup=2)
    print(f"K13 member_probe on owner 0: {int((recv != -1).sum())} of {m} slots real (the rest SENTINEL padding, "
          f"answered without a lookup), {sectors} sectors read, {sectors / out['member_probe']['ms'] / 1e6:.1f} G "
          f"sectors/s; with the index built in the wrapper {out['member_probe']['unindexed_ms']:.4f} ms, by launch "
          "(torch.profiler, device ms a call): " + ", ".join(f"{name} {t:.4f}" for name, t in probe_stages.items()))
    print(f"K12/K13: {q.size} queries ({MEMBER_POSITIONS} positions x 9) on {MESH_SHARDS} logical shards of "
          f"{per} keys, {lanes} lanes and {cap} slots an owner; max_abs_err {err}, edge cases and the forced overflow "
          f"(cap 64: the host route, exact) {max(edge_errs)}; " + "; ".join(
              f"{name} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
              for name, r in out.items() if name.startswith("member_"))
          + f"; torch.searchsorted + gather + compare {library['member_probe']:.4f} ms")
    queries, bits, log_bits, n_hash = route_args[:4]
    loads = bloom_probe_loads(bits, log_bits, n_hash, queries)
    stages = stage_ms(lambda: SM.member_route_cuda(*route_args), iters=10)
    print("K12 by launch (torch.profiler, device ms a call): "
          + ", ".join(f"{name} {t:.4f}" for name, t in stages.items())
          + f"; {loads} bitset loads, {loads / out['member_route']['ms'] / 1e6:.1f} G sectors/s")

    # K14: a 2^22-base window over the sorted sets, and entry()'s shapes
    rfwd, _ = K.kmers_from_codes(ref, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::50], k - 1))
    window = 1 << 22
    codes = ref[:window].copy()
    codes[1000:1100] = 255
    codes[np.random.default_rng(seed).integers(0, window, 64)] = 255
    args = (torch.from_numpy(codes).to(cuda), torch.from_numpy(K.as_i64(solid)).to(cuda),
            torch.from_numpy(K.as_i64(repeat)).to(cuda), k)
    indexes = S.set_indexes(*args[1:3])
    want = S._scan_planes_sorted_plain(*args)
    errs = [_max_abs_err((got[key], want[key]) for key in S.PLANE_KEYS)
            for got in (S.scan_planes_sorted_cuda(*args, indexes), S.scan_planes_sorted_cuda(*args))]
    ms = _cuda_ms(lambda: S.scan_planes_sorted_cuda(*args, indexes), iters=5, warmup=1)
    built_ms = _cuda_ms(lambda: S.scan_planes_sorted_cuda(*args), iters=5, warmup=1)
    plain_ms = _cuda_ms(lambda: S._scan_planes_sorted_plain(*args), iters=2)
    bound = _bytes_bound_ms(window + 8 * (solid.size + repeat.size) + 20 * (window - k + 1))
    fn, eargs = G.entry()
    errs.append(_max_abs_err(zip(fn(*eargs).values(), S._scan_planes_sorted_plain(*eargs, 31).values())))
    entry_ms = _cuda_ms(lambda: fn(*eargs), iters=20, warmup=2)
    for ek in (2, 3, 31, 32):
        for name, (ecodes, es, er) in sorted_edge_windows(ek).items():
            eargs = (torch.from_numpy(ecodes).to(cuda), torch.from_numpy(K.as_i64(es)).to(cuda),
                     torch.from_numpy(K.as_i64(er)).to(cuda), ek)
            errs.append(_max_abs_err(zip(S.scan_planes_sorted_cuda(*eargs).values(),
                                         S._scan_planes_sorted_plain(*eargs).values())))
    torch.cuda.synchronize()
    contained = int(want["contains"].sum())
    stages = stage_ms(lambda: S.scan_planes_sorted_cuda(*args), iters=5)
    sectors = scan_sorted_sectors(*args)
    out["scan_planes_sorted"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, **bound,
                                 "built_ms": built_ms, "entry_ms": entry_ms}
    print(f"K14 scan_planes_sorted: window {window}, k {k}, solid {solid.size}, repeat {repeat.size}, "
          f"{contained} positions contained, max_abs_err {max(errs)} (with entry()'s shapes and the edge windows at "
          f"k 2, 3, 31, 32; tolerance 0: exact), kernel {ms:.4f} ms with the sets' indexes passed in, "
          f"{built_ms:.4f} ms with the two index builds in the wrapper, plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms (bytes: each input read once, 20 B of planes a position); entry()'s "
          f"2^14-base window over 2^16 keys {entry_ms:.4f} ms (its indexes built once by entry())")
    print("K14 with the index builds, by launch (torch.profiler, device ms a call): "
          + ", ".join(f"{name} {t:.4f}" for name, t in stages.items())
          + f"; {sectors} sectors read by the lookups, {sectors / ms / 1e6:.1f} G sectors/s")

    # the bucket index's build kernel on K14's and K13's sets, and on the edge sets of both
    errs = []
    for keys_ in (args[1], args[2], *sm.shard_keys):
        for halve in (0, 1, 2):  # about 1, 2 and 4 keys a bucket
            log_b = max(1, SI.log_buckets(keys_.shape[0]) - halve)
            errs.append(_max_abs_err(zip(SI.build_cuda(keys_, log_b), SI._build_plain(keys_, log_b))))
    for ek in (2, 3, 31, 32):
        for _ecodes, es, er in sorted_edge_windows(ek).values():
            for eset in (es, er):
                et = torch.from_numpy(K.as_i64(eset)).to(cuda)
                log_b = SI.log_buckets(et.shape[0])
                errs.append(_max_abs_err(zip(SI.build_cuda(et, log_b), SI._build_plain(et, log_b))))
    for ekeys, _eq, en, ecf in member_edge_cases().values():
        for et in SM.ShardedMembership([cuda] * en, ekeys, cap_factor=ecf).shard_keys:
            log_b = SI.log_buckets(et.shape[0])
            errs.append(_max_abs_err(zip(SI.build_cuda(et, log_b), SI._build_plain(et, log_b))))
    for eset in index_edge_sets().values():
        et = torch.from_numpy(K.as_i64(eset)).to(cuda)
        for log_b in {SI.log_buckets(et.shape[0]), max(1, SI.log_buckets(et.shape[0]) - 2), 1}:
            errs.append(_max_abs_err(zip(SI.build_cuda(et, log_b), SI._build_plain(et, log_b))))
    torch.cuda.synchronize()

    def by_launch(keys_):  # device ms a call of the build, and of torch.searchsorted of its bucket numbers 0..B
        lb = SI.log_buckets(keys_.shape[0])
        lo, _hi, shift, real = (int(v) for v in SI._build_plain(keys_, lb).head.tolist())
        buckets, numbers = K.shr(keys_[:real] - lo, shift), torch.arange((1 << lb) + 1, device=cuda)
        return (sum(stage_ms(lambda: SI.build_cuda(keys_, lb), iters=20).values()),
                sum(stage_ms(lambda: torch.searchsorted(buckets, numbers), iters=20).values()))

    log_b = SI.log_buckets(args[1].shape[0])
    launch_ms, library_ms = by_launch(args[1])
    shard_ms = {j: by_launch(sm.shard_keys[j])[0] for j in (0, MESH_SHARDS - 1)}
    out["sorted_index"] = {"max_abs_err": max(errs),
                           "ms": _cuda_ms(lambda: SI.build_cuda(args[1], log_b), iters=20, warmup=2),
                           "plain_ms": _cuda_ms(lambda: SI._build_plain(args[1], log_b), iters=3),
                           **_bytes_bound_ms(8 * args[1].numel() + 4 * ((1 << log_b) + 1) + 32),
                           "library_ms": library_ms, "launch_ms": launch_ms, "shard_launch_ms": shard_ms,
                           "ms_covers": "CUDA events around the wrapper, 20 calls; launch_ms and shard_launch_ms "
                                        "(shard 0 and the SENTINEL-tailed last) device time by launch "
                                        "(torch.profiler); library_ms torch.searchsorted of the bucket numbers "
                                        "0..B into the keys' (precomputed), by launch"}
    tail = int(sm.shard_keys[-1].numel() - int((sm.shard_keys[-1] != -1).sum()))
    print(f"bucket index build: {args[1].numel()} keys in 2^{log_b} buckets, max_abs_err {max(errs)} (with the "
          f"repeat set and the {MESH_SHARDS} shards at 1, 2 and 4 keys a bucket, the edge sets of K13 and K14 and "
          f"its own, tests/torch_tables.py index_edge_sets; tolerance 0: exact), kernel "
          f"{out['sorted_index']['ms']:.4f} ms ({launch_ms:.4f} by launch), plain "
          f"{out['sorted_index']['plain_ms']:.4f} ms, bound {out['sorted_index']['bound_ms']:.4f} ms (bytes), "
          f"torch.searchsorted of the bucket numbers {library_ms:.4f} ms by launch; by launch, shard 0's "
          f"{sm.shard_keys[0].numel()} keys {shard_ms[0]:.4f} ms, the last shard's ({tail} SENTINEL tail) "
          f"{shard_ms[MESH_SHARDS - 1]:.4f} ms")

    # the sharded counter on MESH_SHARDS logical shards, its capacity forced to overflow (the host route)
    part = _flush_buffer(reads, 1 << 22)
    host = CNT.StreamingCounter(k)
    host.add_codes(part)
    sc = SC.ShardedStreamingCounter(k, mesh, batch_bases=1 << 20, slack=0.0)
    route = sc._route
    flags = []
    sc._route = lambda: (lambda r: flags.append(r[1]) or r)(route())
    sc.add_codes(part)
    got, want = sc.result(), host.result()
    if not (flags and all(flags)) or not all(np.array_equal(getattr(got, f), getattr(want, f))
                                             for f in ("kmers", "counts", "histogram")):
        raise AssertionError("the sharded counter's forced overflow did not overflow, or differs from the host counter")
    print(f"sharded counter on {MESH_SHARDS} logical shards, capacity 64 an owner: {len(flags)} flushes overflowed, "
          f"the host route's {got.kmers.size} k-mers equal the host counter's")
    return out


def mesh_path(work: str, reads: str) -> dict:
    """The device mesh of the process, in-process: on the card's one-device
    mesh `find -graph -scan-engine sharded` over the whole reference (K10
    on the shard) and `find -count-engine sharded` from the reads (K11),
    held to the main path's records and graph bytes; on MESH_SHARDS
    logical shards of the card `fill -fill-engine device` with the walker's
    lanes over the shards (K5), held to the native fill's artifacts,
    `-scan-engine sharded-mem` over the first PLANE_CUT bases (K12, K13),
    held to the default run there, and the graft entry points, entry() (K14)
    and dryrun_multichip. Returns the kernel launch counts of the run."""
    import torch

    from mindthegap_tpu_torch import graft_entry as G
    from mindthegap_tpu_torch.parallel import mesh as M

    launches = _reset_launches()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        times = {"ms": _find_graph("ms", "-scan-engine", "sharded"),
                 "mc": _cli(["find", "-in", reads, "-ref", "ref.fa", "-count-engine", "sharded", "-out", "mc",
                             "-profile", "-verbose", "0"])}
        with M.logical_devices([torch.device("cuda")] * MESH_SHARDS):
            times["mf"] = _cli(["fill", "-graph", "t.h5", "-bkpt", "t.breakpoints", "-fill-engine", "device",
                                "-out", "mf", "-profile", "-verbose", "0"])
            times["mm"] = _find_graph("mm", "-scan-engine", "sharded-mem", ref="ref_cut.fa")
            t0 = time.perf_counter()
            fn, args = G.entry()
            planes = fn(*args)
            G.dryrun_multichip(MESH_SHARDS)
            torch.cuda.synchronize()
            entry_s = time.perf_counter() - t0
        counts = launches()
    finally:
        os.chdir(cwd)

    def path(name):
        return os.path.join(work, name)

    if not _equal_records(work, "t", "ms"):
        raise AssertionError("find -scan-engine sharded wrote other records than the main path's find")
    with open(path("t.h5"), "rb") as a, open(path("mc.h5"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("find -count-engine sharded wrote another graph than host counting")
    if not _equal_records(work, "t", "mc"):
        raise AssertionError("find -count-engine sharded wrote other records than host counting")
    for ext in ("insertions.fasta", "info.txt"):
        if not _same(path(f"tf.{ext}"), path(f"mf.{ext}")):
            raise AssertionError(f"the fill over the walker's mesh wrote another {ext} than the native fill")
    if _records(path("tf.insertions.vcf")) != _records(path("mf.insertions.vcf")):
        raise AssertionError("the fill over the walker's mesh wrote other VCF records than the native fill")
    if not _equal_records(work, "pcut", "mm"):
        raise AssertionError("find -scan-engine sharded-mem wrote other records than the default run on the cut")
    if tuple(planes["fwd"].shape) != (args[0].numel() - 30,):
        raise AssertionError("entry() gave planes of another shape")
    for name in ("scan_pay_qp", "swizzle_keys", "walk_batch", "member_route", "member_probe", "member_scatter",
                 "scan_planes_sorted", "sorted_index"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the mesh path")
    print("mesh path (in-process): find -graph -scan-engine sharded (one-device mesh) " + _wall(times["ms"])
          + f"; find -count-engine sharded {times['mc'][0]:.1f} s (graph build "
          f"{_phase(times['mc'][1], 'graph build'):.2f} s), its graph byte-equal to the host count's; fill -fill-engine device over {MESH_SHARDS} logical "
          f"shards {times['mf'][0]:.1f} s (fill jobs {_phase(times['mf'][1], 'fill jobs'):.2f} s), equal to the native "
          f"fill; -scan-engine sharded-mem on {MESH_SHARDS} logical shards over the first {PLANE_CUT} bases "
          + _wall(times["mm"]) + f", equal to the default run there; entry() and dryrun_multichip({MESH_SHARDS}) "
          f"{entry_s:.1f} s, their value checks passed")
    print(f"kernel launches on the mesh path: {counts}")
    return {"launches": counts}


DIST_RANKS = 2  # ranks of the distributed phase, all on the one card
DIST_SHARDS = 2  # logical shards of the card a rank: a global mesh of 4
DIST_TIMEOUT_S = 900  # the ranks' deadline, and their collectives' timeout


def rank_main(argv: list[str]) -> int:
    """One rank of the distributed phase (the script re-invoked as
    `chip_smoke.py --rank R --world W --rendezvous FILE --work DIR --reads
    READS`): join the gloo group, lay DIST_SHARDS logical shards of the card
    in the global mesh, run `find -scan-engine sharded -count-engine sharded
    -automaton host` (K11 on the rank's count chunks, K10 on its scan
    windows) and `fill -fill-engine device` (K5 on the rank's jobs) through
    the CLI, and print one JSON line: the walls and the launches of the
    rank's run."""
    import torch

    from mindthegap_tpu_torch.parallel import distributed as D
    from mindthegap_tpu_torch.parallel import mesh as M

    args = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(args["--rank"]), int(args["--world"])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    D.init_distributed(f"file://{args['--rendezvous']}", world, rank, timeout_s=DIST_TIMEOUT_S)
    os.chdir(args["--work"])
    launches = _reset_launches()
    prefix = "d" if rank == 0 else f"d.rank{rank}"  # the CLI's -out of a rank other than the writer
    with M.logical_devices([torch.device("cuda")] * DIST_SHARDS):
        find_s, report = _cli(["find", "-in", args["--reads"], "-ref", "ref.fa", "-scan-engine", "sharded",
                               "-count-engine", "sharded", "-automaton", "host", "-out", "d", "-profile",
                               "-verbose", "0"])
        fill_s, fill_report = _cli(["fill", "-graph", f"{prefix}.h5", "-bkpt", f"{prefix}.breakpoints",
                                    "-fill-engine", "device", "-out", "df", "-profile", "-verbose", "0"])
    torch.cuda.synchronize()
    counts = launches()
    print(json.dumps({"rank": rank, "writer": D.is_writer(), "prefix": prefix, "find_s": find_s,
                      "graph_build_s": _phase(report, "graph build"), "scan_s": _scan_s(report)[1],
                      "fill_s": fill_s, "fill_jobs_s": _phase(fill_report, "fill jobs"),
                      "launches": {name: counts[name] for name in ("scan_pay_qp", "swizzle_keys", "walk_batch")}}))
    torch.distributed.destroy_process_group()
    return 0


def distributed_path(work: str, reads: str) -> dict:
    """The run across processes on the card: this script as DIST_RANKS ranks
    (rank_main), each with DIST_SHARDS logical shards; every rank's find
    records must equal the main path's default run's, its graph the
    host-count graph byte for byte, its fill the native fill's; every rank
    must have launched K10, K11 and K5. A rank that fails, or passes the
    deadline, fails the phase, and the others are killed."""
    import torch

    torch.cuda.empty_cache()  # the ranks' own contexts share the card with this process
    rendezvous = os.path.join(work, "rendezvous")
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(DIST_RANKS),
                               "--rendezvous", rendezvous, "--work", work, "--reads", reads],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(DIST_RANKS)]
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > DIST_TIMEOUT_S or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode} after {wall:.1f} s\n{text[-4000:]}")
        ranks.append(json.loads(next(line for line in reversed(text.splitlines()) if line.startswith('{"rank"'))))

    def path(name):
        return os.path.join(work, name)

    if [rec["writer"] for rec in ranks] != [r == 0 for r in range(DIST_RANKS)]:
        raise AssertionError(f"rank 0 alone must be the writer: {ranks}")
    for rec in ranks:
        d = rec["prefix"]
        df = "df" if rec["rank"] == 0 else f"df.rank{rec['rank']}"
        if not _equal_records(work, "t", d):
            raise AssertionError(f"rank {rec['rank']}'s find wrote other records than the main path's find")
        with open(path("t.h5"), "rb") as a, open(path(f"{d}.h5"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"rank {rec['rank']}'s -count-engine sharded graph differs from host counting")
        for ext in ("insertions.fasta", "info.txt"):
            if not _same(path(f"tf.{ext}"), path(f"{df}.{ext}")):
                raise AssertionError(f"rank {rec['rank']}'s fill wrote another {ext} than the native fill")
        if _records(path("tf.insertions.vcf")) != _records(path(f"{df}.insertions.vcf")):
            raise AssertionError(f"rank {rec['rank']}'s fill wrote other VCF records than the native fill")
        for name, n in rec["launches"].items():
            if n <= 0:
                raise AssertionError(f"rank {rec['rank']} did not launch {name}")
    print(f"distributed path ({DIST_RANKS} gloo ranks on the card, {DIST_SHARDS} logical shards each): wall "
          f"{wall:.1f} s; records, graph bytes and fills equal the main path's on every rank; "
          + "; ".join(f"rank {rec['rank']}: find {rec['find_s']:.1f} s (graph build {rec['graph_build_s']:.2f} s, "
                      f"setup + scan + replay {rec['scan_s']:.2f} s), fill -fill-engine device {rec['fill_s']:.1f} s "
                      f"(fill jobs {rec['fill_jobs_s']:.2f} s), launches {rec['launches']}" for rec in ranks))
    return {"wall_s": wall, "ranks": ranks}


TRACE_KERNEL = "scan_cls_qp_kernel"  # K1's kernel, as the trace names it


def trace_path(work: str) -> dict:
    """`find -graph t.h5 -profile-trace DIR` on the card, in-process: the
    trace must name K1's kernel (device activity was captured), and the run
    must write the main path's records."""
    launches = _reset_launches()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        wall, _ = _find_graph("tr", "-profile-trace", "trace_dir")
    finally:
        os.chdir(cwd)
    counts = launches()
    trace = os.path.join(work, "trace_dir", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if TRACE_KERNEL in str(e.get("name", "")) and e.get("ph") == "X"]
    if not k1:
        raise AssertionError(f"the -profile-trace trace does not name {TRACE_KERNEL}")
    if counts["scan_cls_qp"] <= 0:
        raise AssertionError("find -profile-trace did not launch K1")
    if not _equal_records(work, "t", "tr"):
        raise AssertionError("find -profile-trace wrote other records than the run without it")
    k1_ms = sum(float(e.get("dur", 0)) for e in k1) / 1e3
    print(f"find -graph -profile-trace: {wall:.1f} s, trace {os.path.getsize(trace)} bytes, "
          f"{len(events)} events, {len(k1)} of {TRACE_KERNEL} ({k1_ms:.4f} ms on the card); "
          f"K1 launches {counts['scan_cls_qp']}; records equal the run without the option")
    return {"wall_s": wall, "k1_events": len(k1), "k1_ms": k1_ms, "launches": counts["scan_cls_qp"]}


def _wall(t) -> str:
    setup, scan = _scan_s(t[1])
    return f"{t[0]:.1f} s (scan engine setup {setup:.2f} s, setup + scan + replay {scan:.2f} s)"


def build_kernels():
    """Build every kernel library at once: one nvcc per source, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from mindthegap_tpu_torch.fill import walk_device as W
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import counting_device as C
    from mindthegap_tpu_torch.ops import nw_device as ND
    from mindthegap_tpu_torch.ops import sorted_index as SI
    from mindthegap_tpu_torch.parallel import sharded_count as SC
    from mindthegap_tpu_torch.parallel import sharded_membership as SM

    loaders = (S._cls_lib, ND._nw_lib, C._keys_lib, C._merge_lib, W._walk_lib, S._span_scan_lib, W._walk_span_lib,
               S._planes_lib, SC._lib, SM._lib, S._sorted_lib, SI._lib, S._planes_span_lib)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for f in [pool.submit(fn) for fn in loaders]:
            f.result()
    return len(loaders)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the port must sit beside this script; without it, fail before printing anything
    import mindthegap_tpu_torch  # noqa: F401
    sys.path.insert(0, os.path.join(REPO, "tests"))  # torch_tables: the kernels' edge cases
    from mindthegap_tpu_torch.ops import kmers as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t_start = time.perf_counter()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    n_sources = build_kernels()
    print(f"kernel build (nvcc, sm_90a, {n_sources} sources in parallel): {time.perf_counter() - t0:.1f} s")

    seed = 20261016
    k = 31
    case = make_case(ECOLI_LEN, n_ins=100, n_snp=50, n_del=50, seed=seed)
    ref, donor, insertions = case
    fwd, _ = K.kmers_from_codes(donor, k)
    solid = np.unique(K.canonical_u64(fwd, k))  # error-free reads: the donor's k-mers
    k1, qp = check_scan_kernel(ref, solid, k, seed)
    planes = check_plane_kernels(ref, solid, qp, k, seed)
    del qp
    k2 = check_nw_kernel(seed)

    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cpu31 = None
    try:
        t0 = time.perf_counter()
        write_fasta(os.path.join(work, "ref.fa"), CHROM, ref)
        reads = write_reads(os.path.join(work, "reads"), donor, 30.0, seed + 1)
        print(f"data: genome {ref.size} bp, {len(insertions)} insertions, 30x 2x150 reads "
              f"({time.perf_counter() - t0:.1f} s to write)")
        k3, k4 = check_count_kernels(reads, solid, k, seed)
        k5 = check_walk_kernel(donor, solid, k, seed)
        t0 = time.perf_counter()
        span_fwd, span_rows = span_solid(donor, SPAN_K)
        print(f"k = {SPAN_K} solid set from the donor's k-mers: {span_rows.shape[0]} rows "
              f"({time.perf_counter() - t0:.1f} s)")
        k6, qms = check_span_scan_kernel(ref, span_rows, SPAN_K, seed)
        k16 = check_span_plane_kernel(ref, qms, SPAN_K, seed)
        k7 = check_span_walk_kernel(span_fwd, qms, SPAN_K, seed)
        del span_fwd, span_rows, qms
        mesh = check_mesh_kernels(ref, solid, reads, k, seed)
        for name, r in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4), ("K5", k5), ("K6", k6), ("K7", k7),
                        ("K8", planes["scan_planes_q"]), ("K9", planes["scan_planes_qb"]),
                        ("K10", planes["scan_pay_qp"]), ("K11", mesh["swizzle_keys"]),
                        ("K12", mesh["member_route"]), ("K13", mesh["member_probe"]),
                        ("K13", mesh["member_scatter"]), ("K14", mesh["scan_planes_sorted"]),
                        ("the bucket index build", mesh["sorted_index"]), ("K15", planes["scan_planes_qp"]),
                        ("K16", k16)):
            if r["max_abs_err"]:
                raise AssertionError(f"{name} disagrees with its plain version: {r}")
        run = main_path(work, insertions, reads)
        cpu31 = start_script_cpu(work, "t")  # the script phase's -device cpu run, behind the phases between
        run2 = device_path(work, insertions, reads)
        run4 = plane_path(work, ref, donor)
        run5 = mesh_path(work, reads)
        distributed_path(work, reads)
        trace_path(work)
        run3 = span_path(work, seed)
        run6 = script_path(work, cpu31)
    finally:
        if cpu31 is not None and cpu31.poll() is None:
            cpu31.kill()
            cpu31.wait()
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        {"name": "scan_cls_qp", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_qp.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:451",
         "launches": run["launches"]["scan_cls_qp"], **k1},
        {"name": "nw_matches", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/nw.cu",
         "replaces": "mindthegap_tpu/ops/nw_device.py:39",
         "launches": run["launches"]["nw_matches"], **k2},
        {"name": "kmer_keys", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/count_kmers.cu",
         "replaces": "mindthegap_tpu/ops/counting_device.py:225",
         "launches": run2["launches"]["kmer_keys"], **k3},
        {"name": "merge_sorted", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/count_merge.cu",
         "replaces": "mindthegap_tpu/ops/counting_device.py:238",
         "launches": run2["launches"]["merge_sorted"], **k4},
        {"name": "walk_batch", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/walk.cu",
         "replaces": "mindthegap_tpu/fill/walk_device.py:58",
         "launches": run2["launches"]["walk_batch"], **k5},
        {"name": "scan_pay_q_span", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_span.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:240",
         "launches": run3["launches"]["scan_pay_q_span"], **k6},
        {"name": "walk_batch_span", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/walk_span.cu",
         "replaces": "mindthegap_tpu/fill/walk_device.py:157",
         "launches": run3["launches"]["walk_batch_span"], **k7},
        {"name": "scan_planes_q", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_planes.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:125",
         "launches": run4["launches"]["scan_planes_q"], **planes["scan_planes_q"]},
        {"name": "scan_planes_qb", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_planes.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:163",
         "launches": run4["launches"]["scan_planes_qb"], **planes["scan_planes_qb"]},
        {"name": "scan_pay_qp", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_qp.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:427",
         "launches": run4["launches"]["scan_pay_qp"], **planes["scan_pay_qp"]},
        {"name": "swizzle_keys", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/sharded_count.cu",
         "replaces": "mindthegap_tpu/parallel/sharded_count.py:125",
         "launches": run5["launches"]["swizzle_keys"], **mesh["swizzle_keys"]},
        {"name": "member_route", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/sharded_member.cu",
         "replaces": "mindthegap_tpu/parallel/sharded_membership.py:76",
         "launches": run5["launches"]["member_route"], **mesh["member_route"]},
        {"name": "member_probe", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/sharded_member.cu",
         "replaces": "mindthegap_tpu/parallel/sharded_membership.py:76",
         "launches": run5["launches"]["member_probe"], **mesh["member_probe"]},
        {"name": "member_scatter", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/sharded_member.cu",
         "replaces": "mindthegap_tpu/parallel/sharded_membership.py:76",
         "launches": run5["launches"]["member_scatter"], **mesh["member_scatter"]},
        {"name": "scan_planes_sorted", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_sorted.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:88",
         "launches": run5["launches"]["scan_planes_sorted"], **mesh["scan_planes_sorted"]},
        {"name": "sorted_index", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/sorted_index.cu",
         "replaces": None,
         "launches": run5["launches"]["sorted_index"], **mesh["sorted_index"]},
        {"name": "scan_planes_qp", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_planes.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:392",
         "launches": run6["launches"]["scan_planes_qp"], **planes["scan_planes_qp"]},
        {"name": "scan_planes_q_span", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_planes_span.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:201",
         "launches": run6["launches"]["scan_planes_q_span"], **k16},
    ]
    for rec in kernels:  # the records that time otherwise say how
        rec.setdefault("ms_covers", "CUDA events around the wrapper, the mean of its calls")
        if rec["route"] not in ("cuda", "triton") or rec["launches"] <= 0:
            raise AssertionError(f"kernel record {rec['name']}: route {rec['route']!r}, {rec['launches']} launches")
    print(f"auto gate record: {json.dumps(run4['gate'])}")
    print(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if "--rank" in sys.argv else main())
