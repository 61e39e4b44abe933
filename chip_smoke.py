#!/usr/bin/env python3
"""Smoke run of mindthegap_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. print the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels K1 (csrc/scan_qp.cu) and K2 (csrc/nw.cu) from
     the checkout and time the build;
  3. hold each kernel against its plain PyTorch version on the card, exactly:
     K1 on a full 2^22-base window over the pair map of a bacterial-size
     solid set, K2 on 256 seeded pairs of 50 to 10,000 bp (also against the
     native nw.cpp); time both sides;
  4. drive the main path at the size users run: a seeded genome of
     4,641,652 bp (the length of E. coli K-12 MG1655) with ~100 planted
     homozygous insertions of 20-500 bp plus SNPs and deletions, 30x of
     2x150 bp error-free reads from the donor; `find -in reads -ref ref`
     with default flags (in-process through the CLI entry point, so the
     kernel launch counters are readable), then `fill -bkpt` as a
     subprocess; `nwalign --device` on one filled insertion against its
     planted sequence, checked against the native engine (and K2 against
     its plain version at that pair's shape);
  5. check the results: K1 and K2 launched on the main path, the find artifacts equal
     a `-device cpu` rerun on the same graph, and insertion recall >= 90%.

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
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over (kernel, plain) integer tensor pairs."""
    return max(int((a.long() - b.long()).abs().max()) for a, b in pairs)


def check_scan_kernel(ref: np.ndarray, donor: np.ndarray, k: int, seed: int) -> dict:
    """K1 against its plain version on one full 2^22-base window of the
    reference, over the pair map of the donor's solid set."""
    import torch

    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import extmap as X
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed)
    fwd, _ = K.kmers_from_codes(donor, k)
    solid = np.unique(K.canonical_u64(fwd, k))
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
    print(f"K1 scan_cls_qp: window {window}, k {k}, solid {solid.size}, table {qp.nbytes >> 20} MB, "
          f"stash {int(qp.stash_keys.size)}, max_abs_err {err} (tolerance 0: exact), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    print(f"K2 nw_matches: 256 pairs, {cells / 1e9:.3f} Gcells, max_abs_err {err} (tolerance 0: exact), "
          "equal to native nw.cpp, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (one call)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def main_path(work: str, case, seed: int) -> dict:
    """find -> fill -> nwalign --device on the E. coli-size case (make_case's
    output); returns the kernel launch counts of the run."""
    import torch

    from mindthegap_tpu_torch import cli, nwalign
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import nw as N
    from mindthegap_tpu_torch.ops import nw_device as ND

    t0 = time.perf_counter()
    ref, donor, insertions = case
    write_fasta(os.path.join(work, "ref.fa"), CHROM, ref)
    reads = write_reads(os.path.join(work, "reads"), donor, 30.0, seed + 1)
    print(f"data: genome {ref.size} bp, {len(insertions)} insertions, 30x 2x150 reads "
          f"({time.perf_counter() - t0:.1f} s to write)")

    S.cls_core_cuda.launches = 0
    ND.nw_matches_cuda.launches = 0
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            rc = cli.main(["find", "-in", reads, "-ref", "ref.fa", "-out", "t"])
        if rc != 0:
            raise RuntimeError(f"find exited {rc}: {report.getvalue()[-4000:]}")
        find_s = time.perf_counter() - t0
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
    launches = {"scan_cls_qp": S.cls_core_cuda.launches, "nw_matches": ND.nw_matches_cuda.launches}

    nw_dev = float(out.getvalue().strip())
    nw_nat = N.nw_identity(got, planted_s)
    if nw_dev != nw_nat:
        raise AssertionError(f"nwalign --device {nw_dev} != native {nw_nat}")
    # K2 against its plain version at the shape nwalign gave it (one pair)
    seq, off = ND.pack_pairs([(got, planted_s)])
    k2, plain = ND.nw_matches_cuda(seq.cuda(), off.cuda()), ND._nw_matches_plain(seq.cuda(), off.cuda())
    if not torch.equal(k2, plain):
        raise AssertionError(f"K2 {k2.tolist()} != plain {plain.tolist()} on the nwalign pair")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    cpu_s = _run([sys.executable, "-m", "mindthegap_tpu_torch", "find", "-graph", "t.h5",
                  "-ref", "ref.fa", "-out", "c", "-device", "cpu"], work)
    with open(os.path.join(work, "t.breakpoints")) as a, open(os.path.join(work, "c.breakpoints")) as b:
        if a.read() != b.read():
            raise AssertionError("find -device cpu wrote other .breakpoints than the CUDA run")
    if _records(os.path.join(work, "t.othervariants.vcf")) != _records(os.path.join(work, "c.othervariants.vcf")):
        raise AssertionError("find -device cpu wrote other VCF records than the CUDA run")
    recall = insertion_recall(insertions, filled)
    n_bkpt = sum(1 for line in open(os.path.join(work, "t.breakpoints")) if line.startswith(">")) // 2
    print(f"find (CUDA, graph built from reads): {find_s:.1f} s, {n_bkpt} breakpoints; "
          f"fill: {fill_s:.1f} s, {len(filled)} insertions; find -device cpu -graph: {cpu_s:.1f} s")
    print(f"nwalign --device: identity {nw_dev} (native {nw_nat}; K2 equals its plain version on this "
          f"{len(got)} x {len(planted_s)} pair), {nw_s:.2f} s")
    print(f"CUDA and CPU find outputs identical; insertion recall {recall:.4f} "
          f"({round(recall * len(insertions))}/{len(insertions)})")
    print(f"kernel launches on the main path: {launches}")
    if recall < 0.9:
        raise AssertionError(f"insertion recall {recall:.4f} is below 0.9")
    return {"launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the port must sit beside this script; without it, fail before printing anything
    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import nw_device as ND

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    S._cls_lib()
    ND._nw_lib()
    print(f"kernel build (nvcc, sm_90a): {time.perf_counter() - t0:.1f} s")

    seed = 20261016
    case = make_case(ECOLI_LEN, n_ins=100, n_snp=50, n_del=50, seed=seed)
    k1 = check_scan_kernel(case[0], case[1], 31, seed)
    k2 = check_nw_kernel(seed)
    if k1["max_abs_err"] or k2["max_abs_err"]:
        raise AssertionError(f"kernel disagrees with its plain version: K1 {k1}, K2 {k2}")

    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        run = main_path(work, case, seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        {"name": "scan_cls_qp", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/scan_qp.cu",
         "replaces": "mindthegap_tpu/find/scan_device.py:451",
         "launches": run["launches"]["scan_cls_qp"], **k1},
        {"name": "nw_matches", "route": "cuda", "source": "mindthegap_tpu_torch/csrc/nw.cu",
         "replaces": "mindthegap_tpu/ops/nw_device.py:39",
         "launches": run["launches"]["nw_matches"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
