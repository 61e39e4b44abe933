"""Inputs of a run, made from its seed: the reference, the donor with its
planted variants, the reads, the graph file and the breakpoints file.

`make_case` and the read layout are frozen copies of the repository's
smoke generator (its `make_case` and `write_reads`), with substitution
errors added and the reads written as FASTQ. The draws are numpy's on the
host and the rest integer arithmetic, so the same seed gives the same
bytes on any machine and device.

Base codes: A=0 C=1 T=2 G=3, so the complement of a code is `code ^ 2`.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .reference import words as W

NUC = np.frombuffer(b"ACTG", np.uint8)  # code -> letter
CHROM = "ref"
READ_CHUNK = 100_000  # fragments drawn per call of the generator


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


def case_from_config(cfg: dict, seed: int):
    return make_case(cfg["genome_length"], cfg["insertions"], cfg["snps"], cfg["deletions"], seed)


def write_fasta(path: str, name: str, codes: np.ndarray):
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(NUC[codes].tobytes())
        f.write(b"\n")


# ---------------------------------------------------------------------------
# reads

class ReadLayout:
    """Where the reads of a run come from, drawn from the seed chunk by
    chunk: per chunk the fragment lengths and starts (as the smoke
    generator draws them), then the substitution errors as flat indices
    into the chunk's (reads, read_len) bases of each mate."""

    def __init__(self, donor_len: int, cfg: dict, seed: int):
        self.donor_len = donor_len
        self.read_len = int(cfg["read_length"])
        self.frag_lo, self.frag_hi = (int(x) for x in cfg["fragment_length"])
        self.error_rate = float(cfg["substitution_rate"])
        self.n_frag = int(cfg["coverage"] * donor_len / (2 * self.read_len))
        self.seed = seed

    def chunks(self):
        """Yield (start, flen, err1, sub1, err2, sub2) per chunk: the
        fragments' donor starts and lengths, and for each mate the flat
        indices of its substituted bases and the code added to each (1-3,
        modulo 4)."""
        rng = np.random.default_rng(self.seed)
        rl = self.read_len
        for lo in range(0, self.n_frag, READ_CHUNK):
            nb = min(READ_CHUNK, self.n_frag - lo)
            flen = rng.integers(self.frag_lo, self.frag_hi + 1, nb)
            start = (rng.random(nb) * (self.donor_len - flen + 1)).astype(np.int64)
            errs = []
            for _mate in range(2):
                n_err = int(rng.binomial(nb * rl, self.error_rate))
                idx = np.unique(rng.integers(0, nb * rl, n_err))
                sub = rng.integers(1, 4, idx.size).astype(np.uint8)
                errs += [idx, sub]
            yield (start, flen, *errs)


def reads(layout: ReadLayout, donor: np.ndarray):
    """(mate 1, mate 2) codes of shape (reads, read_len) per chunk, errors
    applied; mate 2 is the reverse complement of the fragment's end."""
    cols = np.arange(layout.read_len)
    for start, flen, e1, s1, e2, s2 in layout.chunks():
        r1 = donor[start[:, None] + cols]
        r2 = donor[(start + flen - 1)[:, None] - cols] ^ 2  # reverse complement
        for r, e, s in ((r1, e1, s1), (r2, e2, s2)):
            flat = r.reshape(-1)
            flat[e] = (flat[e] + s) % 4
        yield r1, r2


def write_fastq(prefix: str, layout: ReadLayout, donor: np.ndarray) -> str:
    """Write the reads as two FASTQ files (quality 'I' everywhere); returns
    the `-in` argument."""
    paths = (f"{prefix}_1.fq", f"{prefix}_2.fq")
    rl = layout.read_len
    tail = np.frombuffer(b"\n+\n" + b"I" * rl + b"\n", np.uint8)
    with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2:
        for r1, r2 in reads(layout, donor):
            for f, r in ((f1, r1), (f2, r2)):
                rec = np.empty((r.shape[0], 3 + rl + tail.size), np.uint8)
                rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
                rec[:, 3:3 + rl] = NUC[r]
                rec[:, 3 + rl:] = tail
                f.write(rec.tobytes())
    return ",".join(paths)


def kmer_abundance(layout: ReadLayout, k: int) -> np.ndarray:
    """For each donor position p, how many reads hold the donor's k-mer at
    p with no substitution in it (either mate, either strand): the count a
    k-mer counter gives that occurrence. Computed from the layout alone,
    without making the reads."""
    n = layout.donor_len
    rl = layout.read_len
    diff = np.zeros(n + 2, np.int64)
    for start, flen, e1, _s1, e2, _s2 in layout.chunks():
        # mate 1 covers donor [start, start + rl), base j at start + j;
        # mate 2 covers [end - rl + 1, end], base j at end - j
        end = start + flen - 1
        lo1, lo2 = start, end - rl + 1
        for lo in (lo1, lo2):
            np.add.at(diff, lo, 1)
            np.add.at(diff, lo + rl - k + 1, -1)
        for lo, e, mirrored in ((lo1, e1, False), (lo2, e2, True)):
            if e.size == 0:
                continue
            read = e // rl
            j = e % rl
            pos = lo[read] + (rl - 1 - j if mirrored else j)  # donor position of the base
            order = np.lexsort((pos, read))
            read, pos = read[order], pos[order]
            base = lo[read]
            a = np.maximum(pos - k + 1, base)  # first k-mer start holding the base
            b = np.minimum(pos, base + rl - k)  # last one
            # errors of one read, sorted by position: count each k-mer once
            same = np.zeros(read.size, bool)
            same[1:] = read[1:] == read[:-1]
            prev_b = np.empty_like(b)
            prev_b[0] = -1
            prev_b[1:] = b[:-1]
            a = np.where(same, np.maximum(a, prev_b + 1), a)
            keep = a <= b
            np.add.at(diff, a[keep], -1)
            np.add.at(diff, b[keep] + 1, 1)
    return np.cumsum(diff)[: n - k + 1]


# ---------------------------------------------------------------------------
# the graph file

def donor_graph(donor: np.ndarray, layout: ReadLayout, k: int, abundance_min: int, device="cpu"):
    """The solid set of a graph file made without counting: the donor's
    canonical k-mers whose read abundance (summed over their occurrences)
    is at least `abundance_min`. Returns (hi, lo, counts) sorted by value,
    (hi, lo) the words of reference/words.py."""
    if k <= 31:
        lo = W.canonical_t(W.forward_t(donor, k, device), k).cpu().numpy().view(np.uint64)
        hi = np.zeros_like(lo)
    else:
        hi, lo = W.canonical(*W.forward(donor, k), k)
    ab = kmer_abundance(layout, k)
    order = W.order_of(hi, lo, k)
    hi, lo, ab = hi[order], lo[order], ab[order]
    new = np.ones(hi.size, bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    idx = np.flatnonzero(new)
    counts = np.add.reduceat(ab, idx)
    keep = counts >= abundance_min
    return hi[idx][keep], lo[idx][keep], counts[keep].astype(np.int64)


def write_graph(path: str, k: int, hi: np.ndarray, lo: np.ndarray, counts: np.ndarray,
                abundance_min: int):
    """Write the graph file `find -graph` and `fill -graph` read: a frozen
    copy of the graph file's writer (an npz container, magic MTGTPU02;
    k-mers as uint64, or above k = 32 as rows of words, word 0 most
    significant; the info tree as JSON)."""
    if k <= 32:
        kmers, words = lo, 1
    else:
        kmers, words = np.stack([hi, lo], axis=1), 2
    info = {"kmers_nb_solid": int(lo.size), "thresholds": int(abundance_min),
            "abundance_max": 2147483647, "abundance_min_is_auto": False}
    tmp = path + ".npz"
    np.savez_compressed(
        tmp,
        magic=np.frombuffer(b"MTGTPU02", dtype=np.uint8),
        k=np.int64(k),
        words=np.int64(words),
        kmers=kmers,
        counts=counts,
        info=np.frombuffer(json.dumps(info).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)
