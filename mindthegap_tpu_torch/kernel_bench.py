"""Times the port's kernels on one GPU against another checkout of this
repository, in one process on the same card and inputs: K1 (the whole
scan_cls_qp), K2 (the NW match counts), K3 (k-mer keys, and sort_batch
around it), K4 (the counting merge), K5 (the fill walker, with a sweep
of its look-ahead depth), K6 (the span scan) and K7 (the
span walker, with a sweep of its look-ahead depth); then K8 and K9 (the
plane path's kernels over the cuckoo and bucket maps) in turns with the
earlier checkout's and beside K1 and K10, with the card's random-sector
yardstick; then K11 (sharded counting's key routing) and K12 (sharded
membership's route, its launches apart); then K14 and K13 (the owner's
probe and the scatter back).

    python -m mindthegap_tpu_torch.kernel_bench --prev DIR [--json FILE] [--only STAGES]

DIR holds an earlier checkout's `mindthegap_tpu_torch/` and `native/` (for
example `git archive <commit> mindthegap_tpu_torch native | tar -x -C DIR`
into the gitignored `mindthegap_tpu_torch/_build/`). That package is
imported under another name, builds its kernels into its own `_build/`, and
is called through its own entry points, `scan_cls_qp`, `nw_matches_cuda`,
`kmer_keys_cuda`, `sort_batch`, `merge_sorted_cuda`, `walk_batch_cuda`,
`scan_pay_q_span_cuda` and `walk_batch_span_cuda`, whose signatures this
checkout keeps (`depth` is a keyword added since). Each pair of
versions is timed in turns (earlier, current, current, earlier) by CUDA
events, and their outputs must be equal.

The inputs: a seeded random genome of 4,641,652 bp (the length of E. coli
K-12 MG1655), k = 31, its canonical k-mers as the solid set. K1 scans a
2^22-base window of the genome, with N runs and isolated Ns, over the pair
map of that set (the default exception cap). K3 extracts the keys of a
2^23-base batch of 150-base reads sampled from the genome, joined by
separators, and sort_batch sorts them. K5 walks from random genome k-mers
over the cuckoo and the bucket map of the set, 2,048 steps with a budget
of 10,000, at 1 to 65,536 lanes, and on two mostly dead rounds (lanes with
a budget of 0 issue no probe), at every look-ahead depth the kernel takes
and at the depth `lookahead_depth` picks. K4 merges 2^23 sorted k-mers
sampled from both strands into an accumulator of the solid set in 2^23
slots. K2 aligns 256 seeded pairs of 50 to 10,000 bp, made as
chip_smoke.py's K2 check makes them. K6 and K7 run over the span map of
the genome's k = 45 k-mers (built as chip_smoke.py builds the donor's,
with a repeat set of every 50th (k-1)-mer of the scanned window) and of a
2,200,000 bp genome's k = 128 k-mers: K6 scans a 2^21-base window with N
runs and isolated Ns, K7 walks from the genome's k-mers with a budget of
10,000 and 2,048 steps at every look-ahead depth (k = 45: 1 to 16,384
lanes; k = 128: 1 to 4,096), each against the earlier kernel in turns. The registers and spills of every K6 and K7 instantiation come
first (nvcc -Xptxas -v). The planes stage prints the registers and spills
of scan_planes.cu's kernels, then K8 (cuckoo map), K9 (bucket map) and
K10 (pair map) scan K1's 2^22-base window of the genome over the maps of
its k = 31 set (K1's repeat set), each held to its plain version once (K8
and K9 also the earlier checkout's `scan_planes_q_cuda` and
`scan_planes_qb_cuda`), then all of them and K1 are timed in turns, twice
(each in order, then back), with K8's and K9's launches by torch.profiler;
last the random-sector yardstick: torch.index_select of 2^22 random rows
of a 128 MB int64 table, and of as many rows as K8's probes read sectors,
in sectors a second, and the time K8's probes alone take at that rate
(plane_trials.py also times a hand gather, which reads faster).
The mesh stage prints the registers and spills of K11-K13 (nvcc -Xptxas
-v), then times K11 on a 2^23-base flush of the same kind of reads and K12
on shard 0 of the nine membership queries of 2^20 genome positions over
the k = 31 set on 4 logical shards (2^22 lanes, chip_smoke.py's shape),
each in turns with the earlier checkout's `swizzle_keys_cuda` and
`member_route_cuda`; K12 also with the device time of each launch of
both versions (torch.profiler) and the bitset loads it issues. The sorted
stage prints the registers of the bucket index's build kernel, K13 and
K14, then times K14 (`scan_planes_sorted_cuda`) on chip_smoke.py's
2^22-base window over the k = 31 set and at entry()'s shapes (through
entry()'s own function), and K13's probe (`member_probe_cuda`) on owner 0
of the K12 shape above (5.24 M slots), each in turns with the earlier
checkout's, with the sets' bucket indexes passed in and built inside the
wrapper, with the index builds' device time apart (torch.profiler) and
the sectors the lookups read (bounds.py); then K13's scatter
(`member_scatter_cuda`) of shard 0's verdicts back into its 2^22 lanes, in
turns with the earlier checkout's and with one PyTorch call of the same
function (`index_put_` on zeroed lanes, the real slots picked outside the
timing), by CUDA events (the host's launch rate, where a call's host side
is the longer) and by each launch's device time (torch.profiler, in
turns); then the bucket index build (`SI.build_cuda`) on the solid set,
on the first and the last (SENTINEL-tailed) key shard of 4 logical
shards, on entry()'s two sets and on a shard of the dryrun's size, in
turns with the earlier checkout's, by CUDA events and by each launch's
device time, beside
torch.searchsorted of the bucket numbers 0..B (the plain build's core)
by launch. The planes stage also times the earlier checkout's K10 in
turns. `--only` names the stages to run
(comma-separated keys of the JSON record: span_scan, span_walk, nw, scan,
keys, walk, merge, planes, mesh, sorted, plane_passes, branching; default
all). The branching stage times K17 (`branching_cuda`, no earlier version)
on the k = 31 set, with its index at about 1, 2 and 4 keys a bucket, beside
its plain version, a torch.searchsorted route and the host function it
replaces in build_graph, and the whole device path from the numpy keys
(bench_branching). The
plane_passes stage times K15 and K16 (scan_planes_qp_cuda on the planes
stage's window, scan_planes_q_span_cuda on K6's k = 45 window) in turns
with the earlier checkout's, with their plain versions and with the
two-step routes they replace on the card (K10 and planes_from_pay, K6
and planes_from_pay_span), and both versions' launches by torch.profiler
in turns. Prints the card,
one line per shape and, last, one JSON object of every time. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ._build import ptxas_usage
from .bounds import (NW_OPS_PER_CELL, NW_OPS_PER_CELL_12, PLANE_BYTES_PER_POSITION, SECTOR_BYTES, bloom_probe_loads,
                     branching_bytes, bytes_ms, nw_bound_ms, plane_pass_bound_ms, plane_scan_sectors,
                     scan_probe_sectors, scan_sorted_sectors, scatter_bytes, sorted_lookup_sectors, span_scan_sectors,
                     walk_bound_ms, walk_span_bound_ms)
from .device import cuda_ms, launch_means, stage_ms
from .fill import walk_device as W
from .find import scan_device as S
from .ops import branching_device as BR
from .ops import counting_device as C
from .ops import extmap as X
from .ops import kmers as K
from .ops import nw_device as ND
from .ops import sorted_index as SI
from .ops.span import Span
from .ops.span_device import span_width
from .parallel import sharded_count as SC
from .parallel import sharded_membership as SM

GENOME_LEN = 4_641_652
STEPS = 2048
BUDGET = 10_000
# (lanes, live lanes): all live from one lane to 65,536, then two rounds
# whose other lanes are done
WALK_SHAPES = tuple((n, n) for n in (1, 128, 512, 1024, 1536, 2048, 4096, 6144, 8192, 10240, 12288, 16384, 65536)) \
    + ((4096, 128), (65536, 2048))
SPAN_WALK_LANES = {45: (1, 128, 512, 768, 1024, 2048, 4096, 6144, 8192, 16384),
                   128: (1, 128, 256, 512, 1024, 2048, 4096)}
SPAN_GENOME_128 = 2_200_000  # a smaller genome than E. coli, above one 2^21-base window
MESH_SHARDS = 4  # chip_smoke.py's logical shards


def load_checkout(root: str, alias: str = "prev_mindthegap_tpu_torch"):
    """(walk_device, counting_device, scan_device, nw_device) of the
    `mindthegap_tpu_torch` under `root`, imported as `alias`."""
    pkg = os.path.join(root, "mindthegap_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    sys.modules[alias] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[alias])
    return tuple(importlib.import_module(f"{alias}.{m}")
                 for m in ("fill.walk_device", "ops.counting_device", "find.scan_device", "ops.nw_device"))


def _in_turns(old, new, iters: int) -> tuple[list[float], list[float]]:
    turns = [cuda_ms(f, iters) for f in (old, new, new, old)]
    return [turns[0], turns[3]], [turns[1], turns[2]]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[key], b[key]) for key in a)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _nw_pairs(seed: int, n_pairs: int = 256, lo: int = 50, hi: int = 10_000):
    """chip_smoke.py's K2 pairs: half a mutated copy of a, half an unrelated b."""
    rng = np.random.default_rng(seed)
    nuc = np.frombuffer(b"ACTG", np.uint8)
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
        pairs.append((nuc[a].tobytes().decode(), nuc[b].tobytes().decode()))
    return pairs


def bench_nw(seed, prev_nd):
    pairs = _nw_pairs(seed)
    seq, off = (t.cuda() for t in ND.pack_pairs(pairs))
    if not torch.equal(ND.nw_matches_cuda(seq, off), prev_nd.nw_matches_cuda(seq, off)):
        raise AssertionError("K2 differs from the earlier nw_matches_cuda")
    lens = np.array([(len(a), len(b)) for a, b in pairs], np.float64)
    cells = float((lens[:, 0] * lens[:, 1]).sum())
    row = {"pairs": len(pairs), "cells": cells, "bound_ms": nw_bound_ms(cells),
           "bound_ms_12op": nw_bound_ms(cells, NW_OPS_PER_CELL_12)}
    row["prev_ms"], row["new_ms"] = _in_turns(lambda: prev_nd.nw_matches_cuda(seq, off),
                                              lambda: ND.nw_matches_cuda(seq, off), 2)
    print(f"K2 nw_matches, 256 pairs of 50-10,000 bp ({cells / 1e9:.3f} Gcells): in turns, earlier "
          f"{row['prev_ms']} ms, current {row['new_ms']} ms; bound {row['bound_ms']:.4f} ms "
          f"({NW_OPS_PER_CELL} int32 operations per cell; {row['bound_ms_12op']:.4f} ms at "
          f"{NW_OPS_PER_CELL_12})")
    return row


def bench_scan(rng, genome, solid, k, prev_s):
    window = 1 << 22
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    qp = X.build_fused_pair(solid, k, np.unique(K.canonical_u64(rfwd[::50], k - 1)))
    t = qp.to("cuda")
    codes = genome[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    cap = (window - k + 2 + 3) // 4 * 4 // 8
    args = (packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, t.log_size, k, cap)
    want = prev_s.scan_cls_qp(*args)
    if not _equal(S.scan_cls_qp(*args), want):
        raise AssertionError("K1 differs from the earlier scan_cls_qp")
    n_pairs = (window - k + 3) // 2
    sectors = scan_probe_sectors(packed, bad, t, k)
    row = {"window": window, "n_exc": int(want["n_exc"]), "exc_cap": cap, "table_mb": qp.nbytes >> 20,
           "pairs": n_pairs, "sectors": sectors, "first_row_share": 2 - sectors / n_pairs,
           "sector_bound_ms": bytes_ms(sectors * 32)}
    row["prev_ms"], row["new_ms"] = _in_turns(lambda: prev_s.scan_cls_qp(*args), lambda: S.scan_cls_qp(*args), 20)
    print(f"K1 scan_cls_qp, 2^22-base window ({row['n_exc']} EXC, cap {cap}), table {row['table_mb']} MB: "
          f"{sectors} row sectors needed for {n_pairs} pairs ({row['first_row_share']:.4f} of the keys in their "
          f"first row, {row['sector_bound_ms']:.4f} ms at the memory rate); in turns, earlier (core + PyTorch "
          f"compaction) {row['prev_ms']} ms, current {row['new_ms']} ms")
    return row


def bench_keys(rng, genome, k, prev_c):
    batch = 1 << 23
    n_reads = batch // 151
    starts = rng.integers(0, genome.size - 150, n_reads)
    buf = np.full((n_reads, 151), C.SEP, np.uint8)
    buf[:, :150] = genome[starts[:, None] + np.arange(150)]
    codes = np.full(batch, C.SEP, np.uint8)
    codes[: buf.size] = buf.ravel()
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    if not torch.equal(C.kmer_keys_cuda(packed, bad, k), prev_c.kmer_keys_cuda(packed, bad, k)):
        raise AssertionError("K3 differs from the earlier kernel")
    row = {"batch": batch}
    row["prev_ms"], row["new_ms"] = _in_turns(lambda: prev_c.kmer_keys_cuda(packed, bad, k),
                                              lambda: C.kmer_keys_cuda(packed, bad, k), 20)
    if not torch.equal(C.sort_batch(packed, bad, k), prev_c.sort_batch(packed, bad, k)):
        raise AssertionError("sort_batch differs from the earlier one")
    row["prev_sort_batch_ms"], row["sort_batch_ms"] = _in_turns(lambda: prev_c.sort_batch(packed, bad, k),
                                                                lambda: C.sort_batch(packed, bad, k), 10)
    print(f"K3 kmer_keys, 2^23-base batch: in turns, earlier {row['prev_ms']} ms, current {row['new_ms']} ms; "
          f"sort_batch in turns, earlier {row['prev_sort_batch_ms']} ms, current {row['sort_batch_ms']} ms")
    return row


def bench_walk(rng, fwd, solid, k, prev_w):
    out = {}
    picks = fwd[rng.integers(0, fwd.size, max(lanes for lanes, _ in WALK_SHAPES))]
    for layout, build in (("cuckoo", X.build_fused), ("bucket", X.build_fused_bucket)):
        host = build(solid, k, np.zeros(0, np.uint64))
        t = host.to("cuda")
        log = host.log_nb if layout == "bucket" else host.log_size
        for lanes, live in WALK_SHAPES:
            nodes = torch.from_numpy(K.as_i64(picks[:lanes])).cuda()
            budgets = torch.zeros(lanes, dtype=torch.int32, device="cuda")
            budgets[:live] = BUDGET
            args = (nodes, budgets, t.slots, t.stash_keys, t.stash_payload, log, k, STEPS, layout)
            want = prev_w.walk_batch_cuda(*args)
            walked = int(want[1].max())
            iters = 20 if lanes <= 128 else 5
            row = {"lanes": lanes, "live": live, "steps_walked": walked,
                   "rule_depth": W.lookahead_depth(live, layout),
                   "bound_ms": walk_bound_ms(want[1], want[3], lanes, STEPS, layout)}
            for depth in W.DEPTHS:
                if not _equal(W.walk_batch_cuda(*args, depth=depth), want):
                    raise AssertionError(f"K5 at D = {depth} differs from the earlier kernel ({layout}, {lanes} lanes)")
                row[f"d{depth}_ms"] = cuda_ms(lambda: W.walk_batch_cuda(*args, depth=depth), iters)
            row["prev_ms"], row["rule_ms"] = _in_turns(lambda: prev_w.walk_batch_cuda(*args),
                                                       lambda: W.walk_batch_cuda(*args), iters)
            print(f"K5 {layout}, {lanes} lanes ({live} live) x {STEPS} steps ({walked} walked): "
                  + ", ".join(f"D = {d} {row[f'd{d}_ms']:.4f} ms ({row[f'd{d}_ms'] * 1e3 / walked:.4f} us/step)"
                              for d in W.DEPTHS)
                  + f"; in turns, earlier {row['prev_ms']} ms, current (D = {row['rule_depth']}) {row['rule_ms']} ms"
                  + f"; bound {row['bound_ms']:.4f} ms (bytes)")
            out[f"{layout}_{lanes}_{live}"] = row
    return out


def bench_merge(rng, fwd, solid, k, prev_c):
    cap = 1 << 23
    acc_k = torch.full((cap,), C.BIASED_SENTINEL, dtype=torch.int64)
    acc_k[: solid.size] = torch.from_numpy(K.as_i64(solid) ^ K.SIGN_BIT)
    acc_c = torch.zeros(cap, dtype=torch.int64)
    acc_c[: solid.size] = torch.from_numpy(rng.integers(1, 60, solid.size))
    sample = K.canonical_u64(fwd[rng.integers(0, fwd.size, cap - 4096)], k)
    batch = np.sort(K.as_i64(sample) ^ K.SIGN_BIT)
    batch = np.concatenate([batch, np.full(4096, C.BIASED_SENTINEL, np.int64)])
    acc_k, acc_c, b = acc_k.cuda(), acc_c.cuda(), torch.from_numpy(batch).cuda()
    want = C._merge_sorted_plain(acc_k, acc_c, b, cap)
    old = lambda: prev_c.merge_sorted_cuda(acc_k, acc_c, b, cap)  # noqa: E731
    new = lambda: C.merge_sorted_cuda(acc_k, acc_c, b, cap)  # noqa: E731
    if not (_equal(old(), want) and _equal(new(), want)):
        raise AssertionError("K4 (earlier or current) differs from its plain version")
    row = {"na": cap, "nb": cap, "n_distinct": int(want[2])}
    row["prev_ms"], row["new_ms"] = _in_turns(old, new, 10)
    print(f"K4 merge 2^23 + 2^23 ({row['n_distinct']} distinct): in turns, earlier {row['prev_ms']} ms, "
          f"current {row['new_ms']} ms")
    return row


def span_map(genome, k: int, window: int):
    """(forward k-mer rows of the genome, its span map): the genome's
    canonical k-mers as the solid set, a repeat set of every 50th (k-1)-mer
    of its first `window` bases."""
    sp, spm1 = Span(k), Span(k - 1)
    fwd, _ = sp.from_codes(genome)
    solid = sp.from_keys(np.unique(sp.keys(sp.canonical(fwd))))
    q, _ = spm1.from_codes(genome[:window])
    repeat = spm1.from_keys(np.unique(spm1.keys(spm1.canonical(q[::50]))))
    return fwd, X.build_fused_span(solid, k, repeat)


def bench_span_scan(rng, genome, qms, k, prev_s):
    window = 1 << 21
    t = qms.to("cuda")
    codes = genome[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    args = (packed, bad, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k)
    want = prev_s.scan_pay_q_span_cuda(*args)
    sectors = span_scan_sectors(packed, bad, t, k)
    io_bytes = packed.numel() + bad.numel() + sum(v.numel() for v in want.values())
    row = {"k": k, "window": window, "table_mb": qms.nbytes >> 20, "probes": window - k + 2, "sectors": sectors,
           "bound_ms": bytes_ms(sectors * SECTOR_BYTES + io_bytes)}
    if not _equal(S.scan_pay_q_span_cuda(*args), want):
        raise AssertionError(f"K6 differs from the earlier kernel (k = {k})")
    row["prev_ms"], row["new_ms"] = _in_turns(lambda: prev_s.scan_pay_q_span_cuda(*args),
                                              lambda: S.scan_pay_q_span_cuda(*args), 20)
    print(f"K6 scan_pay_q_span, k = {k}, 2^21-base window, table {row['table_mb']} MB: in turns, "
          f"earlier {row['prev_ms']} ms, current {row['new_ms']} ms; bound {row['bound_ms']:.4f} ms ({sectors} sectors needed, and loaded, for {row['probes']} probes)")
    return row


def bench_span_walk(rng, fwd, qms, k, prev_w):
    out = {}
    t = qms.to("cuda")
    lane_counts = SPAN_WALK_LANES[k]
    picks = fwd[rng.integers(0, fwd.shape[0], max(lane_counts))]
    for lanes in lane_counts:
        nodes = torch.from_numpy(K.as_i64(picks[:lanes])).cuda()
        budgets = torch.full((lanes,), BUDGET, dtype=torch.int32, device="cuda")
        args = (nodes, budgets, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt,
                qms.log_size, k, STEPS)
        want = prev_w.walk_batch_span_cuda(*args)
        walked = max(int(want[1].max()), 1)
        iters = 20 if lanes <= 128 else 5
        row = {"k": k, "lanes": lanes, "steps_walked": walked,
               "rule_depth": W.lookahead_depth(lanes, "span", span_width(k - 1)),
               "bound_ms": walk_span_bound_ms(want[1], want[3], lanes, STEPS, k)}
        for depth in W.DEPTHS:
            if not _equal(W.walk_batch_span_cuda(*args, depth=depth), want):
                raise AssertionError(f"K7 at D = {depth} differs from the earlier kernel (k = {k}, {lanes} lanes)")
            row[f"d{depth}_ms"] = cuda_ms(lambda: W.walk_batch_span_cuda(*args, depth=depth), iters)
        row["prev_ms"], row["rule_ms"] = _in_turns(lambda: prev_w.walk_batch_span_cuda(*args),
                                                   lambda: W.walk_batch_span_cuda(*args), iters)
        print(f"K7 k = {k}, {lanes} lanes x {STEPS} steps ({walked} walked): "
              + ", ".join(f"D = {d} {row[f'd{d}_ms']:.4f} ms ({row[f'd{d}_ms'] * 1e3 / walked:.4f} us/step)"
                          for d in W.DEPTHS)
              + f"; in turns, earlier {row['prev_ms']} ms, current (D = {row['rule_depth']}) {row['rule_ms']} ms"
              + f"; bound {row['bound_ms']:.4f} ms (bytes)")
        out[f"{k}_{lanes}"] = row
    return out



def random_sector_rate(n_rows: int, seed: int, table_mb: int = 128) -> dict:
    """The card's rate of random reads from a table far above the 50 MB
    L2: torch.index_select of n_rows random rows of a table_mb MB int64
    table (each row one 32-byte sector), three times. {"rows", "ms": [one
    time a run], "g_sectors_per_s": at the best run}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(-(1 << 62), 1 << 62, (table_mb << 17,), dtype=torch.int64, device="cuda", generator=gen)
    idx = torch.randint(0, table.numel(), (n_rows,), device="cuda", generator=gen)
    ms = [cuda_ms(lambda: torch.index_select(table, 0, idx), 20) for _ in range(3)]
    return {"rows": n_rows, "table_mb": table_mb, "ms": ms, "g_sectors_per_s": n_rows / min(ms) / 1e6}


def plane_window(genome, k, seed: int, window: int = 1 << 22):
    """The planes stage's window: the genome's first `window` bases with an
    N run and 64 isolated Ns drawn from `seed`, packed on the card, and the
    repeat set of the maps (every 50th (k-1)-mer of the genome). (packed,
    bad, repeat)."""
    rng = np.random.default_rng(seed)
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::50], k - 1))
    codes = genome[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    return packed, bad, repeat


def bench_planes(genome, solid, k, seed: int, prev_s):
    """K8, K9 and K10 on K1's window (bench_scan's: the same N runs from
    the same seed's draws are not reused, so the window is made here from
    `seed`), each equal to its plain version (K8 and K9 also to the earlier
    checkout's), then in turns, twice, with the earlier K8 and K9 and with
    K1; the registers and spills of scan_planes.cu's kernels first, and
    last the random-sector yardstick (random_sector_rate) at 2^22 rows and
    at the rows K8's probes read."""
    registers = {name: {"registers": regs, "spill_bytes": spill} for name, regs, spill in ptxas_usage("scan_planes.cu")}
    print("scan_planes.cu registers (spill bytes): " + ", ".join(f"{key} {v['registers']} ({v['spill_bytes']})"
                                                                for key, v in registers.items()))
    window = 1 << 22
    packed, bad, repeat = plane_window(genome, k, seed, window)
    qp, qm, qb = (X.build_fused_pair(solid, k, repeat), X.build_fused(solid, k, repeat),
                  X.build_fused_bucket(solid, k, repeat))
    tp, tm, tb = qp.to("cuda"), qm.to("cuda"), qb.to("cuda")
    pair = (packed, bad, tp.slots, tp.stash_keys, tp.stash_l, tp.stash_r, qp.log_size, k)
    q_args = (packed, bad, tm.slots, tm.stash_keys, tm.stash_payload, qm.log_size, k)
    qb_args = (packed, bad, tb.slots, tb.stash_keys, tb.stash_payload, qb.log_nb, k)
    calls = {"earlier K8": lambda: prev_s.scan_planes_q_cuda(*q_args), "K8": lambda: S.scan_planes_q_cuda(*q_args),
             "earlier K9": lambda: prev_s.scan_planes_qb_cuda(*qb_args), "K9": lambda: S.scan_planes_qb_cuda(*qb_args),
             "K1": lambda: S.scan_cls_qp_cuda(*pair, (window - k + 2 + 3) // 4 * 4 // 8),
             "earlier K10": lambda: prev_s.scan_pay_qp_cuda(*pair), "K10": lambda: S.scan_pay_qp_cuda(*pair)}
    plains = {"K8": lambda: S._scan_planes_q_plain(*q_args), "K9": lambda: S._scan_planes_qb_plain(*qb_args),
              "K10": lambda: S._scan_pay_qp_plain(*pair), "earlier K8": lambda: S._scan_planes_q_plain(*q_args),
              "earlier K9": lambda: S._scan_planes_qb_plain(*qb_args),
              "earlier K10": lambda: S._scan_pay_qp_plain(*pair)}
    for name, plain in plains.items():
        if not _equal(calls[name](), plain()):
            raise AssertionError(f"{name} differs from its plain version")
    times = _turns(calls, 20, rounds=2)
    sectors = {"K1": scan_probe_sectors(packed, bad, tp, k), "K8": plane_scan_sectors(packed, bad, tm, k),
               "K9": plane_scan_sectors(packed, bad, tb, k)}
    sectors["K10"] = sectors["K1"]
    n_pos = window - k + 1
    row = {"window": window, "registers": registers, "ms": times, "sectors": sectors,
           "table_mb": {"K1": qp.nbytes >> 20, "K8": qm.nbytes >> 20, "K9": qb.nbytes >> 20, "K10": qp.nbytes >> 20},
           "stages_ms": {name: stage_ms(calls[name], 10)
                         for name in ("earlier K8", "K8", "earlier K9", "K9", "earlier K10", "K10")},
           "bound_ms": {name: bytes_ms(sectors[name] * SECTOR_BYTES + packed.numel() + bad.numel()
                                       + PLANE_BYTES_PER_POSITION * n_pos) for name in ("K8", "K9")}}
    row["bound_ms"]["K10"] = bytes_ms(sectors["K10"] * SECTOR_BYTES + packed.numel() + bad.numel()
                                      + (window - k + 2) + (window - k + 2 + 7) // 8)
    print(f"plane kernels on K1's 2^22-base window, in turns twice ({', '.join(calls)}, and back): "
          + ", ".join(f"{name} {times[name]} ms" for name in calls)
          + "; " + ", ".join(f"{name} {sectors[name]} sectors (table {row['table_mb'][name]} MB)" for name in sectors)
          + f"; by launch (torch.profiler) {row['stages_ms']}; bounds (bytes) {row['bound_ms']}")
    yard = [random_sector_rate(n, seed) for n in (1 << 22, sectors["K8"])]
    rate = max(y["g_sectors_per_s"] for y in yard) * 1e9
    row["random_sectors"] = yard
    row["k8_probes_at_rate_ms"] = sectors["K8"] / rate * 1e3
    print("random-sector yardstick, torch.index_select of random rows of a 128 MB int64 table: "
          + "; ".join(f"{y['rows']} rows {y['ms']} ms, {y['g_sectors_per_s']:.1f} G sectors/s" for y in yard)
          + f"; K8's probes alone at that rate: {row['k8_probes_at_rate_ms']:.4f} ms")
    return row


def bench_mesh(rng, genome, solid, k, prev):
    """K11 on a 2^23-base flush of reads (the sort_batch batch's shape),
    and K12 on one shard of the nine membership queries of 2^20 genome
    positions over the solid set on MESH_SHARDS logical shards (shard 0,
    2^22 lanes, as chip_smoke.py times it): each equal to the earlier
    kernel and to its plain version, timed in turns with the earlier one;
    K12 also with its launches' device times apart (torch.profiler), the
    earlier one's too, and the bitset loads it issues."""
    prev_sc, prev_sm = prev
    registers = {}
    for src in ("sharded_count.cu", "sharded_member.cu"):
        for name, regs, spill in ptxas_usage(src):
            registers[name] = {"registers": regs, "spill_bytes": spill}
    print("K11-K13 registers (spill bytes): " + ", ".join(f"{key} {v['registers']} ({v['spill_bytes']})"
                                                        for key, v in registers.items()))
    # K11: reads of 150 bases joined by an invalid base
    flush = 1 << 23
    n_reads = flush // 151
    starts = rng.integers(0, genome.size - 150, n_reads)
    buf = np.full((n_reads, 151), 255, np.uint8)
    buf[:, :150] = genome[starts[:, None] + np.arange(150)]
    codes = np.full(flush + k - 1, 255, np.uint8)
    codes[: buf.size] = buf.ravel()
    chunk = torch.from_numpy(codes).cuda()
    const = SC.pick_swizzle_const(k)
    want = prev_sc.swizzle_keys_cuda(chunk, k, const)
    if not (_equal(SC.swizzle_keys_cuda(chunk, k, const), want)
            and _equal(SC._swizzle_keys_plain(chunk, k, const), want)):
        raise AssertionError("K11 differs from the earlier kernel or its plain version")
    k11 = {"flush": flush, "bound_ms": bytes_ms(chunk.numel() + 16 * (chunk.numel() - k + 1))}
    k11["prev_ms"], k11["new_ms"] = _in_turns(lambda: prev_sc.swizzle_keys_cuda(chunk, k, const),
                                              lambda: SC.swizzle_keys_cuda(chunk, k, const), 20)
    print(f"K11 swizzle_keys, a 2^23-base flush: in turns, earlier {k11['prev_ms']} ms, current {k11['new_ms']} ms; "
          f"bound {k11['bound_ms']:.4f} ms (bytes)")
    # K12: shard 0 of the nine queries of 2^20 positions on MESH_SHARDS logical shards
    sm = SM.ShardedMembership([torch.device("cuda")] * MESH_SHARDS, solid)
    rows, cap = sm.batch(_member_queries(genome, k))
    args = sm.route_args(0, rows, cap)
    queries, bits, log_bits, n_hash, _, n, _ = args
    want = prev_sm.member_route_cuda(*args)
    lanes = queries.numel()
    k12 = {"lanes": lanes, "shards": n, "cap": cap, "positives": int((want[1] >= 0).sum()),
           "bound_ms": bytes_ms(8 * lanes + 4 * bits.numel() + 8 * n + 12 * n * cap),
           "prev_stages_ms": stage_ms(lambda: prev_sm.member_route_cuda(*args), 10)}
    if not (_equal(SM.member_route_cuda(*args), want) and _equal(SM._route_plain(*args), want)):
        raise AssertionError("K12 differs from the earlier kernel or its plain version")
    k12["loads"] = bloom_probe_loads(bits, log_bits, n_hash, queries)
    k12["stages_ms"] = stage_ms(lambda: SM.member_route_cuda(*args), 10)
    k12["prev_ms"], k12["new_ms"] = _in_turns(lambda: prev_sm.member_route_cuda(*args),
                                              lambda: SM.member_route_cuda(*args), 20)
    k12["g_sectors_per_s"] = k12["loads"] / (sum(k12["new_ms"]) / 2) / 1e6
    print(f"K12 member_route: {lanes} lanes on {n} shards, {k12['positives']} positives, {k12['loads']} bitset loads; "
          f"in turns, earlier {k12['prev_ms']} ms, current {k12['new_ms']} ms ({k12['g_sectors_per_s']:.1f} G "
          f"sectors/s, a sector a load); launches {k12['stages_ms']}; earlier launches {k12['prev_stages_ms']}; "
          f"bound {k12['bound_ms']:.4f} ms (bytes)")
    return {"registers": registers, "swizzle_keys": k11, "member_route": k12}


def _smoke_k14_args(genome, solid, k, seed: int):
    """chip_smoke.py's K14 window: the genome's first 2^22 bases with an N
    run and 64 isolated Ns, over the solid set and a repeat set of every
    50th (k-1)-mer of the genome."""
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::50], k - 1))
    codes = genome[: 1 << 22].copy()
    codes[1000:1100] = 255
    codes[np.random.default_rng(seed).integers(0, codes.size, 64)] = 255
    cuda = torch.device("cuda")
    return (torch.from_numpy(codes).to(cuda), torch.from_numpy(K.as_i64(solid)).to(cuda),
            torch.from_numpy(K.as_i64(repeat)).to(cuda), k)


def _member_queries(genome, k):
    """The nine membership queries (the canonical k-mer and its eight
    neighbours) of each of the genome's first 2^20 positions."""
    positions = 1 << 20
    fwd, _ = K.kmers_from_codes(genome[: positions + k - 1], k)
    mask, top = K.kmer_mask(k), np.uint64(2 * (k - 1))
    return np.concatenate([K.canonical_u64(fwd, k)]
                          + [K.canonical_u64(((fwd << np.uint64(2)) | np.uint64(x)) & mask, k) for x in range(4)]
                          + [K.canonical_u64((fwd >> np.uint64(2)) | (np.uint64(x) << top), k) for x in range(4)])


def _member_shard0(genome, solid, k):
    """chip_smoke.py's K13 shape: _member_queries over the solid set on
    MESH_SHARDS logical shards, routed by K12 and exchanged, probed by K13
    and exchanged back. (owner 0's received queries, its keys; shard 0's
    verdicts in slot order, its slots' lanes, its lane count)."""
    from .parallel import mesh as M

    sm = SM.ShardedMembership([torch.device("cuda")] * MESH_SHARDS, solid)
    rows, cap = sm.batch(_member_queries(genome, k))
    routed = [SM.route(*sm.route_args(j, rows, cap)) for j in range(MESH_SHARDS)]
    recv = M.exchange([r[0].reshape(MESH_SHARDS, cap) for r in routed], sm.mesh)
    found = [SM.probe(recv[o], sm.shard_keys[o], sm.shard_index[o]).reshape(MESH_SHARDS, cap)
             for o in range(MESH_SHARDS)]
    back = M.exchange(found, sm.mesh)
    return recv[0], sm.shard_keys[0], back[0].reshape(-1), routed[0][1], rows.shape[1]


def _turns(fns: dict, iters, rounds: int = 1) -> dict:
    """cuda_ms of each function, in turns: every one in order, then in
    reverse, `rounds` times; `iters` calls each, or {name: calls}. {name:
    [one time a turn]}."""
    order = list(fns)
    times = {name: [] for name in order}
    for name in (order + order[::-1]) * rounds:
        times[name].append(cuda_ms(fns[name], iters[name] if isinstance(iters, dict) else iters))
    return times


def planes_equal_route(got: dict, route) -> bool:
    """Whether the planes of K15 or K16 (on the card, {PLANE_KEYS} with
    fwd, or fwd_words of K16) equal a Planes that the two-step route made
    on the host (planes_from_pay, planes_from_pay_span)."""
    host = {key: v.cpu().numpy() for key, v in got.items()}
    fwd = host["fwd_words"].T.view(np.uint64) if "fwd_words" in host else host["fwd"].view(np.uint64)
    if not np.array_equal(fwd, route.fwd_rows if "fwd_words" in host else route.fwd):
        return False
    return all(host[key].dtype == getattr(route, key).dtype and np.array_equal(host[key], getattr(route, key))
               for key in S.PLANE_KEYS[1:])


def span_plane_window(genome, seed: int, k: int = 45, window: int = 1 << 21):
    """K16's window: the genome's first `window` bases with an N run and 64
    isolated Ns drawn from `seed`, over the span map of the genome's k-mers
    (span_map): (scan_planes_q_span's arguments on the card, the codes, the
    map on the card). The span map takes ~1 min of numpy to build."""
    rng = np.random.default_rng(seed)
    _fwd, qms = span_map(genome, k, window)
    t = qms.to("cuda")
    codes = genome[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    packed, bad = (torch.from_numpy(a).cuda() for a in S.pack_codes_host(codes))
    return (packed, bad, t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k), \
        codes, t


def by_launch(fn, iters: int = 10) -> dict:
    """stage_ms of fn, or where the profiler lost a record in every window,
    launch_means (marked "recorded launches only")."""
    try:
        return stage_ms(fn, iters)
    except RuntimeError as e:
        return {"recorded launches only": launch_means(fn, iters), "stage_ms": str(e)}


def bench_plane_passes(genome, solid, k, seed: int, prev_s) -> dict:
    """K15 on the planes stage's 2^22-base window (plane_window) over the
    pair map of the k = 31 set, and K16 on K6's 2^21-base window over the
    span map of the genome's k = 45 k-mers (span_plane_window); each equal
    to its plain version, to the earlier checkout's kernel and to the
    two-step route it replaces on the card (K10, its payload stream to the
    host and planes_from_pay there; K6 and planes_from_pay_span), then
    timed in turns, twice: the kernel, the earlier checkout's, the kernel
    with its planes copied to the host, the route, the plain version; and
    the launches of both kernels by torch.profiler, in turns twice."""
    out = {}
    packed, bad, repeat = plane_window(genome, k, seed)
    qp = X.build_fused_pair(solid, k, repeat)
    tp = qp.to("cuda")
    pair = (packed, bad, tp.slots, tp.stash_keys, tp.stash_l, tp.stash_r, qp.log_size, k)
    codes = S.unpack_codes(packed, bad).cpu().numpy()

    def k10_route():
        r = S.scan_pay_qp_cuda(*pair)
        return S.planes_from_pay(r["pay8"].cpu().numpy(), r["rep8"].cpu().numpy(), codes, k)

    span, scodes, ts = span_plane_window(genome, seed)

    def k6_route():
        r = S.scan_pay_q_span_cuda(*span)
        return S.planes_from_pay_span(*(r[key].cpu().numpy() for key in ("pay8", "rep8", "str8")), scodes, 45)

    for name, kernel, earlier, plain, args, route, tables, kk, label in (
            ("K15", S.scan_planes_qp_cuda, prev_s.scan_planes_qp_cuda, S._scan_planes_qp_plain, pair, k10_route,
             tp, k, "K10 + planes_from_pay"),
            ("K16", S.scan_planes_q_span_cuda, prev_s.scan_planes_q_span_cuda, S._scan_planes_q_span_plain, span,
             k6_route, ts, 45, "K6 + planes_from_pay_span")):
        got = kernel(*args)
        if not (_equal(got, plain(*args)) and _equal(got, earlier(*args)) and planes_equal_route(got, route())):
            raise AssertionError(f"{name} differs from its plain version, the earlier kernel or the route it replaces")
        calls = {name: lambda: kernel(*args), f"earlier {name}": lambda: earlier(*args),
                 f"{name} + planes to the host": lambda: {key: v.cpu() for key, v in kernel(*args).items()},
                 label: route, "plain": lambda: plain(*args)}
        times = _turns(calls, {name: 20, f"earlier {name}": 20, f"{name} + planes to the host": 10, label: 3,
                               "plain": 3}, rounds=2)
        bound, sectors = plane_pass_bound_ms(args[0], args[1], tables, kk)
        launches = {}
        for turn in (name, f"earlier {name}", f"earlier {name}", name):
            launches.setdefault(turn, []).append(by_launch(calls[turn]))
        row = {"k": kk, "window": args[0].shape[0] * 4, "ms": times, "bound_ms": bound, "sectors": sectors,
               "by_launch": launches}
        print(f"{name}, k = {kk}, {row['window']}-base window: in turns twice (CUDA events, ms) "
              + ", ".join(f"{key} {v}" for key, v in times.items())
              + f"; by launch (torch.profiler), in turns {launches}; bound {bound:.4f} ms (bytes: {sectors} sectors)")
        out[name] = row
    return out


def bench_sorted(genome, solid, k, seed: int, prev_s, prev_sm):
    """K14 on chip_smoke.py's 2^22-base window over the solid set and at
    entry()'s shapes, and K13's probe on owner 0's 5.24 M slots of
    chip_smoke.py's K13 shape, each equal to the earlier kernel and to its
    plain version, timed in turns with the earlier one (earlier, the index
    passed in, the index built in the wrapper, and back; three times at
    entry()'s shapes, where a call is short): with the device time of the
    index builds apart from the lookups and the earlier kernel's
    (torch.profiler), the sectors the lookups read (bounds.py) and the
    registers of every kernel."""
    from . import graft_entry as G

    registers = {}
    for src in ("sorted_index.cu", "scan_sorted.cu", "sharded_member.cu"):
        for name, regs, spill in ptxas_usage(src):
            registers[name] = {"registers": regs, "spill_bytes": spill}
    print("index build, K13 and K14 registers (spill bytes): "
          + ", ".join(f"{key} {v['registers']} ({v['spill_bytes']})" for key, v in registers.items()))
    out = {"registers": registers}

    # K14: the smoke's window, then entry()'s function on its own sets
    args = _smoke_k14_args(genome, solid, k, seed)
    indexes = S.set_indexes(*args[1:3])
    fn, eargs = G.entry()
    shapes = {"window": (args, lambda: S.scan_planes_sorted_cuda(*args, indexes),
                         lambda: S.scan_planes_sorted_cuda(*args), lambda: prev_s.scan_planes_sorted_cuda(*args)),
              "entry": ((*eargs, 31), lambda: fn(*eargs), lambda: S.scan_planes_sorted(*eargs, 31),
                        lambda: prev_s.scan_planes_sorted(*eargs, 31))}
    k14 = {}
    for shape, (sargs, given, built, prev) in shapes.items():
        want = prev()
        if not _equal(S._scan_planes_sorted_plain(*sargs), want):
            raise AssertionError(f"K14's plain version differs from the earlier kernel ({shape})")
        fns = {"earlier": prev, "index passed in": given, "index built in the wrapper": built}
        for name, f in fns.items():
            if not _equal(f(), want):
                raise AssertionError(f"K14 ({shape}, {name}) differs from the earlier kernel")
        sectors = scan_sorted_sectors(*sargs)
        v = {"ms": _turns(fns, *((10, 1) if shape == "window" else (200, 3))), "sectors": sectors,
             "contained": int(want["contains"].sum()),
             "bound_ms": bytes_ms(sargs[0].numel() + 8 * (sargs[1].numel() + sargs[2].numel())
                                  + 20 * (sargs[0].numel() - k + 1)),
             "stages_ms": stage_ms(built, 5), "earlier_stages_ms": stage_ms(prev, 5)}
        v["g_sectors_per_s"] = sectors / float(np.mean(v["ms"]["index passed in"])) / 1e6
        k14[shape] = v
        print(f"K14 scan_planes_sorted, {shape}: a {sargs[0].numel()}-base window over {sargs[1].numel()} keys "
              f"({v['contained']} positions contained): in turns (ms) {v['ms']}; {sectors} sectors "
              f"({v['g_sectors_per_s']:.1f} G/s with the index passed in); by launch with the builds "
              f"{v['stages_ms']}, the earlier {v['earlier_stages_ms']}; bound {v['bound_ms']:.4f} ms (bytes)")
    out["scan_planes_sorted"] = k14

    # K13's probe
    recv, keys, back, send_lane, lanes = _member_shard0(genome, solid, k)
    want = prev_sm.member_probe_cuda(recv, keys)
    if not torch.equal(SM._probe_plain(recv, keys), want):
        raise AssertionError("K13's plain probe differs from the earlier kernel")
    index = SI.build(keys)
    fns = {"earlier": lambda: prev_sm.member_probe_cuda(recv, keys),
           "index passed in": lambda: SM.member_probe_cuda(recv, keys, index),
           "index built in the wrapper": lambda: SM.member_probe_cuda(recv, keys)}
    for name, f in fns.items():
        if not torch.equal(f(), want):
            raise AssertionError(f"K13's probe ({name}) differs from the earlier kernel")
    real = int((recv != -1).sum())
    k13 = {"slots": recv.numel(), "real": real, "keys": keys.numel(), "ms": _turns(fns, 20),
           "bound_ms": bytes_ms(9 * recv.numel() + 8 * keys.numel()),
           "sectors": sorted_lookup_sectors(keys, index, recv),
           "stages_ms": stage_ms(fns["index built in the wrapper"], 10)}
    k13["g_sectors_per_s"] = k13["sectors"] / float(np.mean(k13["ms"]["index passed in"])) / 1e6
    print(f"K13 member_probe: {k13['slots']} slots ({real} real) over {k13['keys']} keys: in turns (ms) "
          f"{k13['ms']}; {k13['sectors']} sectors ({k13['g_sectors_per_s']:.1f} G/s with the index passed in); "
          f"by launch with the build {k13['stages_ms']}; bound {k13['bound_ms']:.4f} ms (bytes)")
    out["member_probe"] = k13

    # K13's scatter, and one PyTorch call of the same function (the real slots picked outside the timing)
    want = prev_sm.member_scatter_cuda(back, send_lane, lanes)
    real = send_lane >= 0
    lane_real, verdict_real = send_lane[real].long(), back[real] != 0
    fns = {"earlier": lambda: prev_sm.member_scatter_cuda(back, send_lane, lanes),
           "current": lambda: SM.member_scatter_cuda(back, send_lane, lanes),
           "index_put_": lambda: torch.zeros(lanes, dtype=torch.bool, device="cuda").index_put_((lane_real,),
                                                                                              verdict_real)}
    if not torch.equal(SM._scatter_plain(back, send_lane, lanes), want):
        raise AssertionError("K13's plain scatter differs from the earlier kernel")
    for name, f in fns.items():
        if not torch.equal(f(), want):
            raise AssertionError(f"K13's scatter ({name}) differs from the earlier kernel")
    m = send_lane.numel()
    stages = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        stages[name].append(stage_ms(fns[name], 20))
    k13s = {"slots": m, "real": int(real.sum()), "lanes": lanes, "ms": _turns(fns, 50, 2), "stages_ms": stages,
            "bound_ms": bytes_ms(scatter_bytes(send_lane, lanes, back.data_ptr()))}
    print(f"K13 member_scatter: {m} slots ({k13s['real']} real) into {lanes} lanes: in turns (ms, the host's launch "
          f"rate where a call's host side is longer than its device time) {k13s['ms']}; device time by launch "
          f"(torch.profiler, in turns) {stages}; bound {k13s['bound_ms']:.4f} ms (bytes)")
    out["member_scatter"] = k13s
    return out


def bench_index(solid, prev_si, seed: int) -> dict:
    """The bucket index build on every set size the port's paths build: the
    solid set (chip_smoke.py's K14 set), the first and the last
    (SENTINEL-tailed) key shard of MESH_SHARDS logical shards, entry()'s
    two sets, and the first shard of 2^12 keys below 2^40 over MESH_SHARDS
    (the dryrun's membership set); each equal to its plain version and to
    the earlier kernel: in turns with the earlier one by CUDA events and,
    twice, by the device time of each launch (torch.profiler; a call is
    shorter on the card than on the host), beside one PyTorch call of the
    function's core, torch.searchsorted of the bucket numbers 0..B into the
    keys' bucket numbers (precomputed), by launch."""
    from . import graft_entry as G

    cuda = torch.device("cuda")
    sm = SM.ShardedMembership([cuda] * MESH_SHARDS, solid)
    _fn, eargs = G.entry()
    small = np.sort(np.random.default_rng(seed).integers(0, 1 << 40, size=1 << 12, dtype=np.uint64))
    sets = {"solid": torch.from_numpy(K.as_i64(solid)).to(cuda), "shard 0": sm.shard_keys[0],
            f"shard {MESH_SHARDS - 1}": sm.shard_keys[-1], "entry() solid set": eargs[1],
            "entry() repeat set": eargs[2],
            "dryrun shard 0": SM.ShardedMembership([cuda] * MESH_SHARDS, small).shard_keys[0]}
    out = {}
    for name, keys in sets.items():
        log_b = SI.log_buckets(keys.numel())
        want = SI._build_plain(keys, log_b)
        fns = {"earlier": lambda: prev_si.build_cuda(keys, log_b), "current": lambda: SI.build_cuda(keys, log_b)}
        for which, f in fns.items():
            got = f()
            if not (torch.equal(got.start, want.start) and torch.equal(got.head, want.head)):
                raise AssertionError(f"the {which} index build differs from its plain version ({name})")
        lo, hi, shift, real = (int(v) for v in want.head.tolist())
        buckets = K.shr(keys[:real] - lo, shift)
        numbers = torch.arange((1 << log_b) + 1, device=cuda)
        if not torch.equal(torch.searchsorted(buckets, numbers).to(torch.int32), want.start):
            raise AssertionError(f"torch.searchsorted's starts differ from the index's ({name})")
        stages = {which: [] for which in fns}
        for which in (list(fns) + list(fns)[::-1]) * 2:
            stages[which].append(sum(stage_ms(fns[which], 20).values()))
        v = {"keys": keys.numel(), "real": real, "log_buckets": log_b, "ms": _turns(fns, 20, 2),
             "launch_ms": stages, "library_ms": sum(stage_ms(lambda: torch.searchsorted(buckets, numbers), 20).values()),
             "bound_ms": bytes_ms(8 * keys.numel() + 4 * numbers.numel() + 32)}
        out[name] = v
        print(f"bucket index build, {name}: {v['keys']} keys ({real} below SENTINEL) in 2^{log_b} buckets: in turns "
              f"(CUDA events, ms) {v['ms']}; by launch (torch.profiler, in turns) {stages}; torch.searchsorted of "
              f"the bucket numbers {v['library_ms']:.4f} ms by launch; bound {v['bound_ms']:.4f} ms (bytes)")
    return out


def branching_library(keys: torch.Tensor, k: int) -> torch.Tensor:
    """One PyTorch route of K17's function: the neighbours, torch.searchsorted
    over the whole set (the sign bit flipped: unsigned order), the gather,
    the compare and the degrees."""
    flipped = keys ^ K.SIGN_BIT
    q = BR.neighbours(keys, k).reshape(-1)
    pos = torch.searchsorted(flipped, q ^ K.SIGN_BIT).clamp_(max=keys.numel() - 1)
    hit = (keys[pos] == q).reshape(-1, 8)
    return ((hit[:, :4].sum(1) != 1) | (hit[:, 4:].sum(1) != 1)).sum()


def bench_branching(solid, k: int) -> dict:
    """K17 on the solid set (the cell's shape: a bacterial genome's
    canonical k-mers): registers and spills; equal to its plain version, to
    the library route and to the host function (timed once: the path it
    replaces); in turns by CUDA events around the wrapper, the index passed
    in at about 1, 2 and 4 keys a bucket; by launch (torch.profiler); the
    plain version and the library route; the whole device path as
    build_graph runs it (the upload from numpy, the index build, K17, the
    scalar back) by the host's clock; the bound and the lookups' sectors
    (bounds.py branching_bytes), their time at the memory rate and their
    rate."""
    import time

    from .graph import dbg

    registers = {name: {"registers": regs, "spill_bytes": spill} for name, regs, spill in ptxas_usage("branching.cu")}
    print("K17 registers (spill bytes): " + ", ".join(f"{key} {v['registers']} ({v['spill_bytes']})"
                                                       for key, v in registers.items()))
    t0 = time.perf_counter()
    want = dbg.Graph(dbg.SolidSet(solid, k)).nb_branching()
    host_s = time.perf_counter() - t0
    keys = torch.from_numpy(K.as_i64(solid)).cuda()
    log_b = SI.log_buckets(keys.numel())
    indexes = {f"2^{log_b - h} buckets": SI.build_cuda(keys, log_b - h) for h in (0, 1, 2)}
    index = indexes[f"2^{log_b} buckets"]
    for name, ix in indexes.items():
        if not int(BR.branching_cuda(keys, ix, k)) == int(BR._count_plain(keys, ix, k)) == want:
            raise AssertionError(f"K17 or its plain version differs from the host function ({name})")
    if int(branching_library(keys, k)) != want:
        raise AssertionError("the library route differs from the host function")
    fns = {name: (lambda ix=ix: BR.branching_cuda(keys, ix, k)) for name, ix in indexes.items()}

    def device_path():
        return BR.nb_branching(torch.from_numpy(K.as_i64(solid)).cuda(), k)

    path_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device_path()
        path_s.append(time.perf_counter() - t0)
    nbytes, apart, distinct = branching_bytes(keys, index, k)
    out = {"keys": keys.numel(), "k": k, "branching": want, "registers": registers, "host_s": host_s,
           "ms": _turns(fns, 20, 2), "launch_ms": {name: by_launch(f, 20) for name, f in fns.items()},
           "index_launch_ms": by_launch(lambda: SI.build_cuda(keys, log_b), 20),
           "plain_ms": cuda_ms(lambda: BR._count_plain(keys, index, k), 3),
           "library_ms": cuda_ms(lambda: branching_library(keys, k), 3),
           "library_launch_ms": by_launch(lambda: branching_library(keys, k), 3),
           "device_path_s": path_s, "bound_bytes": nbytes, "bound_ms": bytes_ms(nbytes), "lookup_sectors": apart,
           "warp_sectors": distinct, "lookup_sectors_ms": bytes_ms(8 * keys.numel() + SECTOR_BYTES * apart),
           "warp_sectors_ms": bytes_ms(8 * keys.numel() + SECTOR_BYTES * distinct)}
    kernel_ms = out["launch_ms"][f"2^{log_b} buckets"]["branching_kernel"]
    out["g_sectors_per_s"] = apart / kernel_ms / 1e6
    print(f"K17 branching on {out['keys']} keys at k = {k} ({want} branching): in turns (CUDA events around the "
          f"wrapper, ms) {out['ms']}; by launch (torch.profiler) {out['launch_ms']}; the index build by launch "
          f"{out['index_launch_ms']}; plain {out['plain_ms']:.4f} ms; torch.searchsorted route "
          f"{out['library_ms']:.4f} ms (by launch {out['library_launch_ms']}); the host function {host_s:.3f} s; "
          f"the device path from numpy (upload, index, K17, the scalar back) {['%.4f' % t for t in path_s]} s; "
          f"bound {out['bound_ms']:.4f} ms ({nbytes} bytes: the keys, starts and head once); the lookups' sectors "
          f"at the memory rate: {apart} each apart {out['lookup_sectors_ms']:.4f} ms, {distinct} a warp's once "
          f"{out['warp_sectors_ms']:.4f} ms; {out['g_sectors_per_s']:.1f} G sectors/s (each apart, by launch)")
    return out


def span_registers() -> dict:
    """Registers and spill bytes of every K6 and K7 instantiation."""
    out = {}
    for src in ("scan_span.cu", "walk_span.cu"):
        for name, regs, spill in ptxas_usage(src):
            args = ",".join(re.findall(r"Li(\d+)E", name))
            kernel = "K6" if "scan_span_kernel" in name else "K7"
            out[f"{kernel}<{args}>"] = {"registers": regs, "spill_bytes": spill}
    print("registers (spill bytes) by instantiation, K6 <Wq,PER>, K7 <Wq,Wk,D>: "
          + ", ".join(f"{key} {v['registers']} ({v['spill_bytes']})" for key, v in out.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev", required=True, help="directory of an earlier checkout (see above)")
    ap.add_argument("--json", help="also write the JSON record to this file")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--only", help="comma-separated stages to run (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 2
    stages = ("span_scan", "span_walk", "nw", "scan", "keys", "walk", "merge", "planes", "mesh", "sorted",
              "plane_passes", "branching")
    only = set(args.only.split(",")) if args.only else set(stages)
    if only - set(stages):
        ap.error(f"unknown stages {sorted(only - set(stages))} (choose from {', '.join(stages)})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    prev_w, prev_c, prev_s, prev_nd = load_checkout(args.prev)
    rng = np.random.default_rng(args.seed)
    k = 31
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome, k)
    solid = np.unique(K.canonical_u64(fwd, k))
    record = {"device": smi}
    if only & {"span_scan", "span_walk"}:
        record["span_registers"] = span_registers()
        srng = np.random.default_rng(args.seed + 1)  # the span stages' own draws
        fwd45, qms45 = span_map(genome, 45, 1 << 21)
        genome128 = srng.integers(0, 4, SPAN_GENOME_128, dtype=np.uint8)
        fwd128, qms128 = span_map(genome128, 128, 1 << 21)
        if "span_scan" in only:
            record["span_scan"] = [bench_span_scan(srng, genome, qms45, 45, prev_s),
                                   bench_span_scan(srng, genome128, qms128, 128, prev_s)]
        if "span_walk" in only:
            record["span_walk"] = {**bench_span_walk(srng, fwd45, qms45, 45, prev_w),
                                   **bench_span_walk(srng, fwd128, qms128, 128, prev_w)}
    # the k = 31 stages draw from `rng` in this order: a stage run without
    # the ones before it sees other draws than in a full run
    if "nw" in only:
        record["nw"] = bench_nw(args.seed, prev_nd)
    for name, bench in (("scan", lambda: bench_scan(rng, genome, solid, k, prev_s)),
                        ("keys", lambda: bench_keys(rng, genome, k, prev_c)),
                        ("walk", lambda: bench_walk(rng, fwd, solid, k, prev_w)),
                        ("merge", lambda: bench_merge(rng, fwd, solid, k, prev_c))):
        if name in only:
            record[name] = bench()
    if "planes" in only:
        record["planes"] = bench_planes(genome, solid, k, args.seed + 2, prev_s)
    if "mesh" in only:
        prev_mesh = tuple(importlib.import_module(f"prev_mindthegap_tpu_torch.parallel.{m}")
                          for m in ("sharded_count", "sharded_membership"))
        record["mesh"] = bench_mesh(np.random.default_rng(args.seed + 3), genome, solid, k, prev_mesh)
    if "sorted" in only:
        prev_sm = importlib.import_module("prev_mindthegap_tpu_torch.parallel.sharded_membership")
        record["sorted"] = bench_sorted(genome, solid, k, args.seed + 4, prev_s, prev_sm)
        record["sorted"]["index_build"] = bench_index(
            solid, importlib.import_module("prev_mindthegap_tpu_torch.ops.sorted_index"), args.seed + 5)
    if "plane_passes" in only:
        record["plane_passes"] = bench_plane_passes(genome, solid, k, args.seed + 2, prev_s)
    if "branching" in only:
        record["branching"] = bench_branching(solid, k)
    line = json.dumps(record)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
