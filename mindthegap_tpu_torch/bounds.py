"""Least times of the port's kernels on an H100, counted from a run's own
inputs: the bytes each kernel's function must move, at the card's memory
rate, or its operations, at the card's rate for them. chip_smoke.py and
kernel_bench.py report them beside the times they measure."""

from __future__ import annotations

import torch

from .fill import walk_device as W
from .find import scan_device as S
from .ops import extmap as X
from .ops import kmers as K
from .ops import sorted_index as SI
from .ops import span_device as SD

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SECTOR_BYTES = 32  # the least the card reads from device memory at a random address
# the bytes one K5 probe needs: two sectors of the cuckoo map, or one
# 128-byte bucket line
PROBE_BYTES = {"cuckoo": 2 * SECTOR_BYTES, "bucket": 128}
# int32 ALU operations outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K2's least int32 operations per DP cell, with scores shifted by 5 (i + j)
# so that up and left add nothing: the match compare, the diagonal's select
# and add, one three-way max (DPX), two tie compares, the match-count add
# and two selects
NW_OPS_PER_CELL = 9
# the count of the earlier records (diagonal kernel): the up and left adds,
# two two-way maxes and the loop bounds instead
NW_OPS_PER_CELL_12 = 12


def bytes_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def nw_bound_ms(cells: float, ops_per_cell: int = NW_OPS_PER_CELL) -> float:
    """K2's least time for `cells` DP cells, at `ops_per_cell` int32
    operations each."""
    return cells * ops_per_cell / INT32_OPS_PER_S * 1e3


def scan_probe_sectors(packed: torch.Tensor, badbits: torch.Tensor, qp: X.QMapP, k: int) -> int:
    """The random row sectors K1's function needs on one window (packed and
    badbits as scan_cls_qp takes them, qp from QMapP.to on their device):
    the first-choice row of each pair lookup, and the second-choice row of
    each lookup whose key is not in its first (in the second row, in the
    stash or absent)."""
    *_, keys = S.pair_keys(S.unpack_codes(packed, badbits), k)
    in_first, _, _ = X.qp_probe(qp, keys, 0)
    return keys.shape[0] + int((~in_first).sum())


def walk_bound_ms(n_app, status, lanes: int, steps: int, layout: str) -> float:
    """K5's least time for these walks: one probe per appended base, one
    for each walk's start node and one for each stop at a branching
    successor, each reading its sectors, plus the inputs and outputs."""
    probes = int(n_app.sum()) + int((n_app > 0).sum()) + int((status == W.STATUS_EVENT).sum())
    return bytes_ms(probes * PROBE_BYTES[layout] + lanes * (steps + 4 + 8 + 1 + 12))


def span_probe_sectors(qms: X.QMapSpan, words: torch.Tensor) -> int:
    """The random sectors the span map's probes of these canonical keys
    ((Wq, P) words; qms from QMapSpan.to on their device) need, as
    csrc/span_map.cuh reads them: each key's first slot; its Wq-1
    satellite words where that slot holds the key's digest; and, where the
    key is not in its first slot, the second slot and its satellites where
    that one holds the digest."""
    wq = words.shape[0]
    _dig, _v, here, hit = X.span_probe(qms, words)
    miss = ~hit[0]
    return (words.shape[1] + (wq - 1) * int(here[0].sum())
            + int(miss.sum()) + (wq - 1) * int((miss & here[1]).sum()))


def span_scan_sectors(packed: torch.Tensor, badbits: torch.Tensor, qms: X.QMapSpan, k: int) -> int:
    """The random sectors K6's function needs on one window (packed and
    badbits as scan_pay_q_span takes them): span_probe_sectors over the
    canonical (k-1)-mer of every position, as the plain version forms
    them. K6 loads exactly these."""
    qwords, _ = SD.rolling_span(S.unpack_codes(packed, badbits), k - 1)
    canon, _ = SD.canonical_span(qwords, k - 1)
    return span_probe_sectors(qms, canon)


def walk_span_bound_ms(n_app, status, lanes: int, steps: int, k: int) -> float:
    """K7's least time for these walks, counted as walk_bound_ms counts
    K5's probes, each probe reading Wq = ceil((k-1)/32) sectors (a slot and
    its Wq-1 satellite words), plus the inputs and outputs (Wk-word nodes
    in and out, budgets, bases, counts and status)."""
    probes = int(n_app.sum()) + int((n_app > 0).sum()) + int((status == W.STATUS_EVENT).sum())
    wq, wk = SD.span_width(k - 1), SD.span_width(k)
    return bytes_ms(probes * wq * SECTOR_BYTES + lanes * (steps + 16 * wk + 4 + 4 + 1))


# the keys of a bucket that a lookup through a sorted set's bucket index
# loads at once: the mirror of csrc/sorted_index.cuh sidx::LOOKUP_KEYS
LOOKUP_KEYS = 4

# the planes K8 and K9 write for each position: fwd 8 bytes, nb_in and
# nb_out 4 each, valid, contains, suffix_rep and prefix_rep one each
PLANE_BYTES_PER_POSITION = 20


def span_plane_bytes_per_position(k: int) -> int:
    """The planes K16 writes for each position: Wk = ceil(k/32) words of
    fwd_words, nb_in and nb_out 4 bytes each, four one-byte planes."""
    return 8 * SD.span_width(k) + 12


def plane_pass_bound_ms(packed: torch.Tensor, badbits: torch.Tensor, qm, k: int) -> tuple[float, int]:
    """(least ms, random sectors) of K15's or K16's function on one window
    (arguments as scan_planes_qp / scan_planes_q_span take them, qm the
    QMapP or QMapSpan from .to on their device): the sectors its probes
    need (K10's rows, scan_probe_sectors, or K6's, span_scan_sectors), the
    window read once and the planes written once."""
    p = packed.shape[0] * 4 - k + 1
    if isinstance(qm, X.QMapSpan):
        sectors, plane_bytes = span_scan_sectors(packed, badbits, qm, k), span_plane_bytes_per_position(k)
    else:
        sectors, plane_bytes = scan_probe_sectors(packed, badbits, qm, k), PLANE_BYTES_PER_POSITION
    return bytes_ms(sectors * SECTOR_BYTES + packed.numel() + badbits.numel() + plane_bytes * p), sectors


def plane_scan_sectors(packed: torch.Tensor, badbits: torch.Tensor, qm, k: int) -> int:
    """The random sectors K8's or K9's function needs on one window (packed
    and badbits as scan_planes_q / scan_planes_qb take them; qm from
    QMap.to or QMapB.to on their device), one probe per (k-1)-mer of the
    window as the plain version forms them (P + 1 of them): over the cuckoo
    map each first-choice slot and the second-choice slot of each key that
    is not in its first (in its second, in the stash or absent); over the
    bucket map each key's 128-byte line, four sectors."""
    q, _ = S.rolling_kmers(S.unpack_codes(packed, badbits), k - 1)
    keys = K.canonical_u64(q, k - 1)
    if isinstance(qm, X.QMapB):
        return keys.shape[0] * 128 // SECTOR_BYTES
    in_first, _ = X.q_probe(qm, keys, 0)
    return keys.shape[0] + int((~in_first).sum())


def bloom_probe_loads(bits: torch.Tensor, log_bits: int, n_hash: int, queries: torch.Tensor) -> int:
    """The bitset loads K12 issues for these query lanes (bits and queries
    as member_route takes them), a hash a round: every hash of a
    Bloom-positive query; of a negative one, its hashes up to and with its
    first zero bit."""
    from .ops.bloom import _CONSTS

    loads = torch.full(queries.shape, n_hash, dtype=torch.int64, device=queries.device)
    for i, c in reversed(list(enumerate(_CONSTS[:n_hash]))):
        h = (queries ^ K.shr(queries, 33)) * K.i64(c)
        h = h ^ K.shr(h, 29)
        pos = K.shr(h, 64 - log_bits)
        unset = ((bits[K.shr(pos, 5)] >> (pos & 31).to(torch.int32)) & 1) == 0
        loads = torch.where(unset, i + 1, loads)
    return int(loads.sum())


def sorted_lookup_sectors(keys: torch.Tensor, index: SI.SortedIndex, queries: torch.Tensor) -> int:
    """The 32-byte sectors that the lookups of these queries read through
    a sorted set's bucket index, as csrc/sorted_index.cuh takes them (keys,
    index and queries on one device, the index from ops/sorted_index.py):
    none for a query outside [lo, hi] (SENTINEL among them); else the
    sector of its bucket's two starts (two for one bucket in eight), the
    sectors of the bucket's first LOOKUP_KEYS keys, and, where the bucket
    is longer and those keys are all below the query, one a bisection step
    and one for the last compare."""
    scan = LOOKUP_KEYS
    lo, hi, shift, _real = index.head
    inside = ~(K.ult(queries, lo) | K.ult(hi, queries))
    q = queries[inside]
    j = K.shr(q - lo, int(shift))
    begin, end = index.start[j].long(), index.start[j + 1].long()
    n = (end - begin).clamp(max=scan)
    some = n > 0
    sectors = int(inside.sum()) + int((j % 8 == 7).sum())
    sectors += int(((8 * (begin + n - 1)) // SECTOR_BYTES - (8 * begin) // SECTOR_BYTES + 1)[some].sum())
    more = (end - begin > scan) & K.ult(keys[torch.where(end - begin > scan, begin + scan - 1, 0)], q)
    a, b = torch.where(more, begin + scan, 0), torch.where(more, end, 0)
    while bool((live := a < b).any()):
        sectors += int(live.sum())
        mid = (a + b) // 2
        less = live & K.ult(keys[torch.where(live, mid, 0)], q)
        a = torch.where(less, mid + 1, a)
        b = torch.where(live & ~less, mid, b)
    return sectors + int((more & (a < end)).sum())


def branching_bytes(keys: torch.Tensor, index: SI.SortedIndex, k: int, warp: int = 32,
                    chunk: int = 1 << 20) -> tuple[int, int, int]:
    """(the bytes K17 must move, the sectors its lookups read each apart,
    the same with a warp's counted once) on a sorted set, keys and index as
    branching_cuda takes them (k <= 32). The bytes: the keys, the index's
    starts and head read once, the count written once. The lookups' sectors
    are not in the bound: the set is about the L2's size (54 MB for 4.7 M
    keys at k = 31, against 50 MB), and on an H100 K17 ran in less time than
    its memory rate gives for them, counted either way (PERF.md §6). The
    sectors: sorted_lookup_sectors' of the 8 neighbour lookups a key; a
    warp's (its `warp` consecutive keys) the distinct starts' and keys'
    sectors of its first two steps, plus the bisection steps of long
    buckets, each apart. chunk, a multiple of warp, bounds the memory."""
    from .ops import branching_device as BD

    n = keys.shape[0]
    lo, hi, shift, _real = index.head
    key_tag = 1 << 30  # a start's sector id and a key's apart (both below 2^30)
    distinct = apart = 0
    for a in range(0, n, chunk):
        x = keys[a:a + chunk]
        q = BD.neighbours(x, k).reshape(-1)
        w = (torch.arange(x.shape[0], device=keys.device) // warp).repeat_interleave(8)
        inside = ~(K.ult(q, lo) | K.ult(hi, q))
        q, w = q[inside], w[inside]
        j = K.shr(q - lo, int(shift))
        begin, end = index.start[j].long(), index.start[j + 1].long()
        last = begin + (end - begin).clamp(max=LOOKUP_KEYS) - 1
        some = last >= begin
        # the ids of each lookup's sectors: its two starts', its first and last key's
        ids = torch.stack([(4 * j) // SECTOR_BYTES, (4 * j + 4) // SECTOR_BYTES,
                           torch.where(some, key_tag + (8 * begin) // SECTOR_BYTES, -1),
                           torch.where(some, key_tag + (8 * last) // SECTOR_BYTES, -1)], dim=1)
        two_steps = q.shape[0] + int((j % 8 == 7).sum()) + int(((8 * last) // SECTOR_BYTES
                                                                  - (8 * begin) // SECTOR_BYTES + 1)[some].sum())
        lookups = sorted_lookup_sectors(keys, index, q)
        distinct += torch.unique(((w[:, None] << 31) | ids)[ids >= 0]).numel() + lookups - two_steps
        apart += lookups
    return 8 * n + 4 * index.start.numel() + 8 * index.head.numel() + 8, apart, distinct


def scatter_bytes(send_lane: torch.Tensor, lanes: int, back_ptr: int = 0) -> int:
    """The bytes K13's scatter must move (send_lane as member_scatter takes
    it, its verdicts at address back_ptr): every slot's lane, 4 bytes; the
    32-byte sectors of the verdicts that hold a real slot's (lane >= 0: a
    padding slot's verdict is never needed); and the lanes' bools, written
    once."""
    real = torch.nonzero(send_lane >= 0).flatten()
    sectors = torch.unique_consecutive((real + back_ptr % SECTOR_BYTES) // SECTOR_BYTES).numel()
    return 4 * send_lane.numel() + SECTOR_BYTES * sectors + lanes


def scan_sorted_sectors(codes: torch.Tensor, solid: torch.Tensor, repeat: torch.Tensor, k: int) -> int:
    """The sectors K14's lookups read on one window (arguments as
    scan_planes_sorted takes them): sorted_lookup_sectors over each
    position's canonical k-mer and two (k-1)-mers, and over its eight
    neighbours where the k-mer is in the solid set, each set through the
    index ops/sorted_index.py builds for it."""
    fwd, _ = S.rolling_kmers(codes, k)
    canon = K.canonical_u64(fwd, k)
    contained = S._member(solid, canon)
    mask, km1 = K.i64(K.kmer_mask(k)), K.i64(K.kmer_mask(k - 1))
    f = fwd[contained]
    nbrs = [K.canonical_u64(((f << 2) | x) & mask, k) for x in range(4)]
    nbrs += [K.canonical_u64(K.shr(f, 2) | K.i64(x << (2 * (k - 1))), k) for x in range(4)]
    words = (torch.cat([canon, *nbrs]),
             torch.cat([K.canonical_u64(fwd & km1, k - 1), K.canonical_u64(K.shr(fwd, 2) & km1, k - 1)]))
    return sum(sorted_lookup_sectors(keys, SI._build_plain(keys, SI.log_buckets(keys.shape[0])), q)
               for keys, q in zip((solid, repeat), words))
