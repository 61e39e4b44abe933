#!/usr/bin/env python3
"""Smoke run of mindthegap_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. print the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from the checkout, one nvcc per source, all
     started together, and time the build: K1 (csrc/scan_qp.cu), K2
     (csrc/nw.cu), K3 (csrc/count_kmers.cu), K4 (csrc/count_merge.cu) and
     K5 (csrc/walk.cu);
  3. hold each kernel against its plain PyTorch version on the card, exactly,
     at the main path's shapes, and time both sides: K1 on a full 2^22-base
     window over the pair map of a bacterial-size solid set; K2 on 256
     seeded pairs of 50 to 10,000 bp (also against the native nw.cpp); K3
     (+ the sort) on one default counting batch of 2^23 bases of the reads;
     K4 merging that batch into an accumulator of the donor's distinct
     k-mers, once at full capacity and once truncated, and on its tile
     edge cases; K5 on donor k-mers with a budget of 10,000 and 2,048
     steps at 4,096 lanes, 128 lanes (the fill's shape) and 1 lane (the
     chain latency), both layouts, and on its look-ahead edge cases at
     every depth. The edge cases come from tests/torch_tables.py
     (merge_edge_cases, edge_walk_case), the generators the CUDA tests
     use, so the smoke and tests/test_torch_cuda.py check the same
     inputs; the script needs the checkout's tests/ directory for them.
     Each kernel's bound is the
     larger of its bytes over 3.35 TB/s and its operations over the card's
     peak rate for them, counted from this run's inputs;
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
  6. check the results: every kernel launched on its path; the find
     artifacts equal a `-device cpu` rerun on the same graph; the
     device-count graph, breakpoints and VCF records equal the host-count
     run's; the device fills' artifacts equal the native fill's; insertion
     recall >= 90% on both paths.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# the bytes one K5 probe needs: two 32-byte sectors of the cuckoo map, or
# one 128-byte bucket line
PROBE_BYTES = {"cuckoo": 64, "bucket": 128}
# int32 ALU ops outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K2 per DP cell: match compare, diagonal, up and left scores, two maxes,
# two tie compares, the match-count add and two selects, the loop bounds
NW_OPS_PER_CELL = 12
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
    """Largest |kernel - plain| over (kernel, plain) integer tensor pairs."""
    return max(int((a.long() - b.long()).abs().max()) for a, b in pairs)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bytes_bound_ms(n_bytes: float) -> dict:
    return {"bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}


def check_scan_kernel(ref: np.ndarray, solid: np.ndarray, k: int, seed: int) -> dict:
    """K1 against its plain version on one full 2^22-base window of the
    reference, over the pair map of the donor's solid set."""
    import torch

    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import extmap as X
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed)
    rfwd, _ = K.kmers_from_codes(ref, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::50], k - 1))  # exercise the REP class
    qp = X.build_fused_pair(solid, k, repeat)
    t = qp.to("cuda")
    window = 1 << 22
    codes = ref[:window].copy()
    codes[1000:1100] = 255
    codes[rng.integers(0, window, 64)] = 255
    packed, bad = S.pack_codes_host(codes)
    packed = torch.from_numpy(packed).cuda()
    bad = torch.from_numpy(bad).cuda()
    args = (packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, t.log_size, k)
    got = S.cls_core_cuda(*args)
    want = S._cls_core_plain(*args)
    torch.cuda.synchronize()
    err = _max_abs_err(zip(got, want))
    ms = _cuda_ms(lambda: S.cls_core_cuda(*args), iters=20, warmup=2)
    plain_ms = _cuda_ms(lambda: S._cls_core_plain(*args), iters=3)
    # one 16-byte row (one 32-byte sector) per position: one lookup per two
    # positions, two hash choices each
    bound = _bytes_bound_ms(window * 32 + _nbytes(packed, bad, *got))
    print(f"K1 scan_cls_qp: window {window}, k {k}, solid {solid.size}, table {qp.nbytes >> 20} MB, "
          f"stash {int(qp.stash_keys.size)}, max_abs_err {err} (tolerance 0: exact), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms (bytes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound}


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
    50 to 10,000 bp (both the shared-memory and the global-scratch launch)."""
    import torch

    from mindthegap_tpu_torch.ops import nw as N
    from mindthegap_tpu_torch.ops import nw_device as ND

    pairs = make_pairs(256, 50, 10_000, seed)
    seq, off = ND.pack_pairs(pairs)
    seq, off = seq.cuda(), off.cuda()
    got = ND.nw_matches_cuda(seq, off)
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
    ms = _cuda_ms(lambda: ND.nw_matches_cuda(seq, off), iters=3)
    cells = float((lens[:, 0] * lens[:, 1]).sum())
    bound_ms = max(cells * NW_OPS_PER_CELL / INT32_OPS_PER_S, _nbytes(seq, off, got) / HBM_BYTES_PER_S) * 1e3
    print(f"K2 nw_matches: 256 pairs, {cells / 1e9:.3f} Gcells, max_abs_err {err} (tolerance 0: exact), "
          "equal to native nw.cpp, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (one call), bound {bound_ms:.4f} ms "
          f"({NW_OPS_PER_CELL} int32 operations per cell)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None}


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
    from torch_tables import merge_edge_cases

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
    err3 = _max_abs_err([(got, want)])
    ms3 = _cuda_ms(lambda: C.kmer_keys_cuda(packed, bad, k), iters=20, warmup=2)
    plain3 = _cuda_ms(lambda: C._kmer_keys_plain(packed, bad, k), iters=3)
    sort_ms = _cuda_ms(lambda: C.sort_batch(packed, bad, k), iters=10)
    bound3 = _bytes_bound_ms(_nbytes(packed, bad, got))
    print(f"K3 kmer_keys: batch {batch} bases ({fill} filled), k {k}, max_abs_err {err3} "
          f"(tolerance 0: exact), kernel {ms3:.4f} ms, plain {plain3:.4f} ms; "
          f"sort_batch (K3 + torch.sort) {sort_ms:.4f} ms; bound {bound3['bound_ms']:.4f} ms (bytes)")

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
    return ({"max_abs_err": err3, "ms": ms3, "plain_ms": plain3, **bound3},
            {"max_abs_err": err4, "ms": ms4, "plain_ms": plain4, **bound4})


def walk_bound_ms(n_app, status, lanes: int, steps: int, layout: str) -> float:
    """The least time for this run's walks: one probe per appended base, one
    for each walk's start node and one for each stop at a branching
    successor, each reading its sectors (cuckoo 2 x 32 B, bucket 128 B),
    plus the inputs and outputs, at the card's memory rate."""
    from mindthegap_tpu_torch.fill import walk_device as W

    probes = int(n_app.sum()) + int((n_app > 0).sum()) + int((status == W.STATUS_EVENT).sum())
    return (probes * PROBE_BYTES[layout] + lanes * (steps + 4 + 8 + 1 + 12)) / HBM_BYTES_PER_S * 1e3


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
           ("K5", ("walk_kernel",)), ("sort", ("radix", "Sort")))


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

    wrappers = {"scan_cls_qp": S.cls_core_cuda, "nw_matches": ND.nw_matches_cuda,
                "kmer_keys": C.kmer_keys_cuda, "merge_sorted": C.merge_sorted_cuda,
                "walk_batch": W.walk_batch_cuda}
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


def build_kernels():
    """Build every kernel library at once: one nvcc per source, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from mindthegap_tpu_torch.fill import walk_device as W
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import counting_device as C
    from mindthegap_tpu_torch.ops import nw_device as ND

    loaders = (S._cls_lib, ND._nw_lib, C._keys_lib, C._merge_lib, W._walk_lib)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for f in [pool.submit(fn) for fn in loaders]:
            f.result()


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
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_kernels()
    print(f"kernel build (nvcc, sm_90a, 5 sources in parallel): {time.perf_counter() - t0:.1f} s")

    seed = 20261016
    k = 31
    case = make_case(ECOLI_LEN, n_ins=100, n_snp=50, n_del=50, seed=seed)
    ref, donor, insertions = case
    fwd, _ = K.kmers_from_codes(donor, k)
    solid = np.unique(K.canonical_u64(fwd, k))  # error-free reads: the donor's k-mers
    k1 = check_scan_kernel(ref, solid, k, seed)
    k2 = check_nw_kernel(seed)

    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        write_fasta(os.path.join(work, "ref.fa"), CHROM, ref)
        reads = write_reads(os.path.join(work, "reads"), donor, 30.0, seed + 1)
        print(f"data: genome {ref.size} bp, {len(insertions)} insertions, 30x 2x150 reads "
              f"({time.perf_counter() - t0:.1f} s to write)")
        k3, k4 = check_count_kernels(reads, solid, k, seed)
        k5 = check_walk_kernel(donor, solid, k, seed)
        for name, r in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4), ("K5", k5)):
            if r["max_abs_err"]:
                raise AssertionError(f"{name} disagrees with its plain version: {r}")
        run = main_path(work, insertions, reads)
        run2 = device_path(work, insertions, reads)
    finally:
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
