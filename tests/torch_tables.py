"""Test helper: a fused map with some entries moved from their table slots
into the stash, so that the stash path of a lookup is exercised (the
native builders rarely stash anything at test sizes)."""

import numpy as np

from mindthegap_tpu_torch.ops import extmap as X

_M64 = (1 << 64) - 1
_EMPTY = 0xFFFFFFFFFFFFFFFF


def _mix(key: int, const: int) -> int:
    h = ((key ^ (key >> 33)) * const) & _M64
    return h ^ (h >> 29)


def move_to_stash(qp: X.QMapP, keys) -> X.QMapP:
    """Copy of host map `qp` with the rows of `keys` (canonical (k-2)-mers
    present in the table) cleared and their (L36, R36) put in the stash."""
    slots = qp.slots.copy()
    shift = 64 - qp.log_size
    stash = []
    for key in (int(x) for x in keys):
        for i, const in enumerate((int(X._H1), int(X._H2))):
            h = _mix(key, const)
            row = h >> shift
            lane0, lane1 = int(slots[row, 0]), int(slots[row, 1])
            if ((lane0 >> 9) & 1) and ((lane0 >> 8) & 1) == i and ((lane0 >> 10) & ((1 << 45) - 1)) == h & ((1 << shift) - 1):
                stash.append((key, ((lane0 & 0xFF) << 28) | (lane1 >> 36), lane1 & ((1 << 36) - 1)))
                slots[row] = 0
                break
        else:
            raise KeyError(f"{key} is not in the table")
    stash.sort()
    sk, sl, sr = (np.array(col, np.uint64) for col in zip(*stash))
    return X.QMapP(slots, qp.log_size, qp.k, sk, sl, sr)


def move_to_stash_walk(qm, keys):
    """Copy of host map `qm` (QMap or QMapB) with the slots of `keys`
    (canonical (k-1)-mers present in the table) cleared and their payloads
    added to the stash it already has."""
    bucket = isinstance(qm, X.QMapB)
    slots = qm.slots.copy()
    log = qm.log_nb if bucket else qm.log_size
    shift = 64 - log
    rem_mask = (1 << shift) - 1
    stash = [(int(k), int(v)) for k, v in zip(qm.stash_keys, qm.stash_payload) if int(k) != _EMPTY]
    for key in (int(x) for x in keys):
        if bucket:
            h = _mix(key, int(X._H1))
            cands = [((h >> shift) * 16 + s, 10, 1 << 9, None) for s in range(16)]
        else:
            cands = [(_mix(key, c) >> shift, 11, 1 << 10, i) for i, c in enumerate((int(X._H1), int(X._H2)))]
        for slot, rem_shift, valid, choice in cands:
            h = _mix(key, int(X._H1) if choice in (None, 0) else int(X._H2))
            v = int(slots[slot])
            if (v & valid) and (v >> rem_shift) == h & rem_mask and (choice is None or ((v >> 9) & 1) == choice):
                stash.append((key, v & 0x1FF))
                slots[slot] = 0
                break
        else:
            raise KeyError(f"{key} is not in the table")
    assert len(stash) <= 64
    stash.sort()
    sk = np.array([k for k, _ in stash], np.uint64)
    sv = np.array([v for _, v in stash], np.uint16)
    return (X.QMapB if bucket else X.QMap)(slots, log, sk, sv)


# ---------------------------------------------------------------------------
# edge cases of the kernels' designs, shared by the CPU tests (plain vs JAX)
# and the CUDA tests (kernel vs plain)

MERGE_TILE = 2048  # K4's tile of the merged stream (csrc/count_merge.cu TILE)
_SENT = np.uint64(_EMPTY)


def merge_edge_cases(seed: int = 0):
    """{name: (acc_keys u64, acc_counts i64, batch u64 sorted, out_cap)} for
    K4's tiles: a key repeated across more than 3 tiles, out_cap cutting
    inside that run and exactly at a tile boundary, an all-sentinel
    accumulator (the first flush) and a long all-sentinel batch tail."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, np.iinfo(np.uint64).max, 6000, dtype=np.uint64))
    hot = pool[1000]  # both halves of the unsigned range are in the pool
    acc_keys = np.sort(rng.choice(pool, 3000, replace=False))
    acc = np.full(4096, _SENT, np.uint64)
    acc[: acc_keys.size] = acc_keys
    cnt = np.zeros(4096, np.int64)
    cnt[: acc_keys.size] = rng.integers(1, 1000, acc_keys.size)
    batch = np.sort(np.concatenate([rng.choice(pool, 3000), np.full(3 * MERGE_TILE + 500, hot),
                                    np.full(700, _SENT, np.uint64)]))
    cases = {"repeat-over-3-tiles": (acc, cnt, batch, 8192)}
    # run index of the hot key, and of the run start that opens tile 1
    merged = np.sort(np.concatenate([acc, batch]), kind="stable")
    starts = np.nonzero((merged != _SENT) & np.concatenate([[True], merged[1:] != merged[:-1]]))[0]
    hot_run = int(np.searchsorted(merged[starts], hot))
    cases["cap-inside-long-run"] = (acc, cnt, batch, hot_run + 1)
    # distinct keys only, so that element MERGE_TILE opens a run: cut there
    distinct = np.sort(rng.choice(pool, 2 * MERGE_TILE + 300, replace=False))
    cases["cap-at-tile-boundary"] = (np.full(16, _SENT, np.uint64), np.zeros(16, np.int64),
                                     distinct, MERGE_TILE)
    cases["cap-after-tile-boundary"] = (np.full(16, _SENT, np.uint64), np.zeros(16, np.int64),
                                        distinct, MERGE_TILE + 1)
    cases["all-sentinel-acc"] = (np.full(2048, _SENT, np.uint64), np.zeros(2048, np.int64), batch, 8192)
    tail = np.sort(np.concatenate([rng.choice(pool, 1500), np.full(2 * MERGE_TILE + 77, _SENT, np.uint64)]))
    cases["sentinel-tail"] = (acc, cnt, tail, 8192)
    return cases


def walk_edge_inputs(k: int, lanes: int, seed: int):
    """(solid canonical k-mers, genome codes, start nodes u64[lanes],
    budgets i32[lanes], stash keys) for K5's look-ahead rounds: a genome
    with a planted repeat (forks and merges) and starts 1..16 steps before
    the repeat's ends on both strands, so that walks stop at every depth of
    a round; budgets of 0..7 end in the middle of a round; the stash keys
    are the (k-1)-mers 1..3 steps ahead of some starts, so that speculated
    nodes hit the stash. At k = 32 about half the starts have the top bit
    set; a small k gives a dense graph with many forks."""
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed)
    n = 3000 if k < 12 else 20_000
    genome = rng.integers(0, 4, n, dtype=np.uint8)
    a, b, r = n // 5, 3 * n // 5, 300
    genome[b : b + r] = genome[a : a + r]
    fwd, _ = K.kmers_from_codes(genome, k)
    rev, _ = K.kmers_from_codes(genome[::-1] ^ 2, k)
    solid = np.unique(K.canonical_u64(fwd, k))
    near = [a + r - k - d for d in range(1, 17)] + [b - k - d for d in range(1, 17)]
    starts = [fwd[p] for p in near] + [rev[n - k - p] for p in near[:16]]
    starts += list(fwd[rng.integers(0, fwd.size, max(lanes - len(starts), 0))])
    nodes = np.array(starts[:lanes], np.uint64)
    budgets = np.full(lanes, 10_000, np.int32)
    budgets[: min(lanes, 64)][1::4] = rng.integers(0, 8, len(budgets[: min(lanes, 64)][1::4]))
    q = np.unique(K.canonical_u64(fwd[[p + d for p in near[::3] for d in (1, 2, 3)]] & np.uint64((1 << (2 * (k - 1))) - 1), k - 1))
    return solid, genome, nodes, budgets, q[:40]


def edge_walk_case(layout: str, k: int, lanes: int, device):
    """A table with stashed look-ahead nodes and the starts of
    walk_edge_inputs, as walk_batch's arguments on `device` (64 steps)."""
    import torch

    from mindthegap_tpu_torch.ops import kmers as K

    solid, _genome, nodes, budgets, stash = walk_edge_inputs(k, lanes, seed=k + lanes)
    build = X.build_fused_bucket if layout == "bucket" else X.build_fused
    qm = move_to_stash_walk(build(solid, k, np.zeros(0, np.uint64)), stash)
    t = qm.to(device)
    log = qm.log_nb if layout == "bucket" else qm.log_size
    return qm, (torch.from_numpy(K.as_i64(nodes)).to(device), torch.from_numpy(budgets).to(device),
                t.slots, t.stash_keys, t.stash_payload, log, k, 64, layout)


# K1's tile is 256 * 2 or 256 * 4 pairs (1,024 or 2,048 payload entries);
# K3's is 2,048 windows
SCAN_EDGE_NAMES = ("n-exc-0", "n-exc-at-cap", "n-exc-over-cap", "cap-0", "shortest", "shortest-cap-over-n4")


def scan_edge_windows(k: int, seed: int = 0):
    """(host pair map with 30 entries moved to its stash, {name: (codes
    u8[w], exc_cap)}) for K1's compaction: a window unrelated to the solid
    set (n_exc 0); a window of the genome with N runs across payload entry
    1,024, 2,048 and 4,096 (tile boundaries) whose cap is exactly its n_exc,
    n_exc - 1 (one over) and 0 (the feed's forced dense re-dispatch); and
    the shortest window the feed sends (k + 8 bases rounded up to 8), with
    the default cap and with a cap above its n4 payload entries. The caps
    come from the plain scan's n_exc."""
    import torch

    from mindthegap_tpu_torch.find import scan_device as S
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome, k)
    solid = np.unique(K.canonical_u64(fwd[:30_000], k))
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    host = X.build_fused_pair(solid, k, np.unique(K.canonical_u64(rfwd[::40], k - 1)))
    r, _ = K.kmers_from_codes(genome[12_000:12_200], k - 2)
    qp = move_to_stash(host, np.unique(K.canonical_u64(r, k - 2))[:30])

    def default_cap(w):
        return (w - k + 2 + 3) // 4 * 4 // 8

    window = genome[10_000:10_000 + 8192].copy()
    for lo, hi in ((1000, 1040), (2030, 2070), (4090, 4100)):
        window[lo:hi] = 255
    window[rng.integers(0, window.size, 12)] = 255
    t = qp.to("cpu")
    packed, bad = (torch.from_numpy(a) for a in S.pack_codes_host(window))
    n_exc = int(S.scan_cls_qp(packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, t.log_size, k, 0)["n_exc"])
    short = genome[10_000:10_000 + -(-(k + 8) // 8) * 8].copy()
    cases = {
        "n-exc-0": (rng.integers(0, 4, 8192, dtype=np.uint8), default_cap(8192)),
        "n-exc-at-cap": (window, n_exc),
        "n-exc-over-cap": (window, n_exc - 1),
        "cap-0": (window, 0),
        "shortest": (short, default_cap(short.size)),
        "shortest-cap-over-n4": (short, 64),
    }
    assert tuple(cases) == SCAN_EDGE_NAMES
    return qp, cases


def key_edge_batches(seed: int = 0):
    """{name: (codes u8[w], k)} for K3 at k in {1, 15, 16, 31, 32}: a
    batch of 2^17 bases (the final flush's floor) with isolated Ns at every
    bit position of a bad byte, every 64 bases, so that windows end and
    start on each side of every packed-byte and bad-byte boundary, plus an
    N run across the tile boundary at window 2,048; a batch of 4,392 bases
    (not a multiple of the tile, nor of 64); and the smallest batch the
    wrapper takes (k rounded up to 8 bases; an N as its last base when it
    holds more than one window)."""
    rng = np.random.default_rng(seed)
    cases = {}
    for k in (1, 15, 16, 31, 32):
        codes = rng.integers(0, 4, 1 << 17, dtype=np.uint8)
        i = np.arange(codes.size // 64)
        codes[64 * i + i % 8] = 255
        codes[2040:2060] = 255
        cases[f"bad-bit-positions-k{k}"] = (codes, k)
        odd = rng.integers(0, 4, 4392, dtype=np.uint8)
        odd[rng.integers(0, odd.size, 40)] = 255
        cases[f"length-4392-k{k}"] = (odd, k)
        small = rng.integers(0, 4, -(-k // 8) * 8, dtype=np.uint8)
        if small.size > k:
            small[-1] = 255
        cases[f"smallest-k{k}"] = (small, k)
    return cases


# ---------------------------------------------------------------------------
# the span map (32 < k <= 256): K6's windows and K7's walks


def move_to_stash_span(qms: X.QMapSpan, rows) -> X.QMapSpan:
    """Copy of host span map `qms` with the slots of `rows` (canonical
    (k-1)-mer rows [n, Wq] present in the table) cleared and their salted
    digests, satellite words and payloads added to the stash."""
    from mindthegap_tpu_torch.ops.span_device import digest64

    slots, sat = qms.slots.copy(), qms.sat.copy()
    shift = 64 - qms.log_size
    rem_mask = (1 << shift) - 1
    wq = sat.shape[0] + 1
    stash = [(int(k), tuple(int(x) for x in s), int(v))
             for k, s, v in zip(qms.stash_key64, qms.stash_sat, qms.stash_payload) if int(k) != _EMPTY]
    rows = np.asarray(rows, np.uint64).reshape(-1, wq)
    for row, dig in zip(rows, digest64(rows.T)):
        dig = int(dig) ^ qms.salt
        for i, const in enumerate((int(X._H1), int(X._H2))):
            h = _mix(dig, const)
            slot = h >> shift
            v = int(slots[slot])
            sats = tuple(int(x) for x in sat[:, slot])
            if (v >> 10) & 1 and (v >> 9) & 1 == i and v >> 11 == h & rem_mask and sats == tuple(int(x) for x in row[1:]):
                stash.append((dig, sats, v & 0x1FF))
                slots[slot] = 0
                sat[:, slot] = 0
                break
        else:
            raise KeyError(f"{row} is not in the table")
    assert len(stash) <= 64
    stash.sort()
    sk = np.array([k for k, _, _ in stash], np.uint64)
    ss = np.array([s for _, s, _ in stash], np.uint64).reshape(len(stash), wq - 1)
    sv = np.array([v for _, _, v in stash], np.uint16)
    return X.QMapSpan(slots, sat, qms.log_size, qms.salt, sk, ss, sv)


def _span_rows(codes: np.ndarray, k: int):
    """(forward rows [P, W], canonical rows [P, W]) of every k-mer of `codes`."""
    from mindthegap_tpu_torch.ops.span import Span

    sp = Span(k)
    fwd, _ = sp.from_codes(codes)
    return fwd, sp.canonical(fwd)


def _unique_rows(rows: np.ndarray, k: int) -> np.ndarray:
    from mindthegap_tpu_torch.ops.span import Span

    sp = Span(k)
    return sp.from_keys(np.unique(sp.keys(rows)))


SPAN_EDGE_NAMES = ("genome-ns-stash", "unrelated", "all-invalid", "shortest")


def span_edge_windows(k: int, seed: int = 0, repeats: bool = True):
    """(host span map with 30 entries moved to its stash, {name: codes u8[w]})
    for K6 and K16 at 32 < k <= 256, over the map of a 40 kb genome's k-mers
    (the first 30 kb) with a repeat set of every 40th (k-1)-mer (none where
    `repeats` is False, as context_genome_wg builds its map): 8,256 bases of
    the genome (four full tiles of 2,048 (k-1)-mers and a partial one) with
    N runs across the tile boundaries and isolated Ns, whose (k-1)-mers hit
    the stash; a window unrelated to the map; a window of invalid bases
    only (every (k-1)-mer reads as all-A); and the shortest window the feed
    sends (k + 8 bases rounded up to 8). n_pay = w - k + 2 is a multiple of
    8 only where k = 2 mod 8, so the last byte of rep8 and str8 is partial
    at the k the tests use."""
    from mindthegap_tpu_torch.ops.span import Span

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
    _fwd, canon = _span_rows(genome[:30_000], k)
    solid = _unique_rows(canon, k)
    _qf, qcanon = _span_rows(genome, k - 1)
    repeat = _unique_rows(qcanon[::40], k - 1) if repeats else np.zeros((0, qcanon.shape[1]), np.uint64)
    host = X.build_fused_span(solid, k, repeat)
    _sf, scanon = _span_rows(genome[12_000:12_300], k - 1)
    stash = _unique_rows(scanon, k - 1)[:30]
    qms = move_to_stash_span(host, stash)

    window = genome[10_000:10_000 + 8256].copy()
    for lo, hi in ((2030, 2070), (4090, 4100), (6100, 6100 + k)):
        window[lo:hi] = 255
    window[rng.integers(0, window.size, 12)] = 255
    cases = {
        "genome-ns-stash": window,
        "unrelated": rng.integers(0, 4, 4096, dtype=np.uint8),
        "all-invalid": np.full(256 + 8 * (k // 8), 255, np.uint8),
        "shortest": genome[10_000:10_000 + -(-(k + 8) // 8) * 8].copy(),
    }
    assert tuple(cases) == SPAN_EDGE_NAMES and Span(k - 1).W == qms.sat.shape[0] + 1
    return qms, cases


def walk_span_edge_inputs(k: int, lanes: int, seed: int):
    """(solid canonical k-mer rows, start rows u64[lanes, Wk], budgets
    i32[lanes], stash (k-1)-mer rows) for K7: a genome with a planted
    repeat (forks and merges), starts 1..16 steps before the repeat's ends
    on both strands, the two dead ends of the genome (tips), budgets of
    0..7 among the first 64 lanes, and stash keys 1..3 steps ahead of some
    starts."""
    from mindthegap_tpu_torch.ops.span import Span

    rng = np.random.default_rng(seed)
    n = 20_000
    genome = rng.integers(0, 4, n, dtype=np.uint8)
    a, b, r = n // 5, 3 * n // 5, 300
    genome[b : b + r] = genome[a : a + r]
    fwd, canon = _span_rows(genome, k)
    rev, _ = _span_rows(genome[::-1] ^ 2, k)
    solid = _unique_rows(canon, k)
    near = [a + r - k - d for d in range(1, 17)] + [b - k - d for d in range(1, 17)]
    starts = [fwd[-1], rev[-1]] + [fwd[p] for p in near] + [rev[n - k - p] for p in near[:16]]
    starts += list(fwd[rng.integers(0, fwd.shape[0], max(lanes - len(starts), 0))])
    nodes = np.array(starts[:lanes], np.uint64)
    budgets = np.full(lanes, 10_000, np.int32)
    budgets[: min(lanes, 64)][3::4] = np.arange(len(budgets[: min(lanes, 64)][3::4])) % 8
    ahead = fwd[[p + d for p in near[::3] for d in (1, 2, 3)]]
    sp, spm1 = Span(k), Span(k - 1)
    stash = _unique_rows(spm1.canonical(sp.low_bits(ahead, k - 1)), k - 1)[:40]
    return solid, nodes, budgets, stash


def edge_walk_span_case(k: int, lanes: int, device):
    """A span map with stashed look-ahead nodes and the starts of
    walk_span_edge_inputs, as walk_batch_span's arguments on `device` (64
    steps)."""
    import torch

    from mindthegap_tpu_torch.ops import kmers as K
    from mindthegap_tpu_torch.ops.span import Span

    solid, nodes, budgets, stash = walk_span_edge_inputs(k, lanes, seed=k + lanes)
    qms = move_to_stash_span(X.build_fused_span(solid, k, np.zeros((0, Span(k - 1).W), np.uint64)), stash)
    t = qms.to(device)
    return qms, (torch.from_numpy(K.as_i64(nodes)).to(device), torch.from_numpy(budgets).to(device),
                 t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size, k, 64)


# ---------------------------------------------------------------------------
# the plane path (k <= 32): K8's and K9's windows over the cuckoo and bucket
# maps, K10's over the pair map

PLANE_EDGE_NAMES = ("genome-ns-stash", "unrelated", "short")


def plane_edge_windows(k: int, layout: str, seed: int = 0, repeats: bool = True):
    """(host map of `layout` — "cuckoo" (QMap), "bucket" (QMapB) or "pair"
    (QMapP) — over the k-mers of a 40 kb genome's first 30 kb with a repeat
    set of every 40th (k-1)-mer (none where `repeats` is False, as
    context_genome_wg builds its map), 30 of its keys moved to the stash; {name:
    codes u8[w]}) for K8, K9 and K10: 8,200 bases of the genome with N runs
    across the kernels' block boundaries (positions 512, 1,024, 2,048 and
    4,096) and isolated Ns, whose (k-1)-mers hit the stash, its first and
    last positions in the map; a window unrelated to the map; and the
    shortest window the feed sends (k + 8 bases rounded up to 8: shorter
    than 2k from k = 9 on). P = w - k + 1 is odd where k is even, so k = 31
    and 32 give K10's rep8 both parities of its last pair."""
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome[:30_000], k)
    solid = np.unique(K.canonical_u64(fwd, k))
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::40], k - 1)) if repeats else np.zeros(0, np.uint64)
    if layout == "pair":
        r, _ = K.kmers_from_codes(genome[12_000:12_200], k - 2)
        qm = move_to_stash(X.build_fused_pair(solid, k, repeat), np.unique(K.canonical_u64(r, k - 2))[:30])
    else:
        build = X.build_fused_bucket if layout == "bucket" else X.build_fused
        q, _ = K.kmers_from_codes(genome[12_000:12_200], k - 1)
        qm = move_to_stash_walk(build(solid, k, repeat), np.unique(K.canonical_u64(q, k - 1))[:30])
    window = genome[10_000:10_000 + 8200].copy()
    for lo, hi in ((500, 530), (1020, 1030), (2040, 2050 + k), (4090, 4100)):
        window[lo:hi] = 255
    window[rng.integers(3000, window.size - 100, 12)] = 255
    cases = {
        "genome-ns-stash": window,
        "unrelated": rng.integers(0, 4, 4096, dtype=np.uint8),
        "short": genome[10_000:10_000 + -(-(k + 8) // 8) * 8].copy(),
    }
    assert tuple(cases) == PLANE_EDGE_NAMES
    return qm, cases


PLANE_PIPELINE_NAMES = ("long-ragged", "second-slots", "all-absent", "full-stash-unsorted")


def plane_pipeline_case(k: int, name: str, seed: int = 0):
    """(host cuckoo map, codes u8[w]) of one of K8's pipeline cases at k (9
    to 32; K8 takes tiles of 1,024 positions, persistent blocks each taking
    several, and queues the keys that miss their first slot):
    "long-ragged": 2^20 + 296 bases (1,024 tiles and a ragged last one) of
    a genome whose k-mers make the map, every 50th (k-1)-mer the repeat
    set, with N runs across tiles and isolated Ns; "second-slots": 16,000
    bases over the map of their own k-mers built at a load factor of 0.49
    (half full: ~28% of the keys in their second slot); "all-absent": 8,192
    random bases over the map of an unrelated genome (every key misses its
    first slot, so every tile's queue holds all of its keys); "full-stash-
    unsorted": 16,000 bases of a genome over the map of its k-mers with 64
    of them moved to the stash, the stash in descending order."""
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed + k)
    none = np.zeros(0, np.uint64)

    def own_map(genome, load_factor=0.35, repeat=none):
        fwd, _ = K.kmers_from_codes(genome, k)
        return X.build_fused(np.unique(K.canonical_u64(fwd, k)), k, repeat, load_factor=load_factor)

    if name == "long-ragged":
        genome = rng.integers(0, 4, (1 << 20) + 4096, dtype=np.uint8)
        rfwd, _ = K.kmers_from_codes(genome, k - 1)
        qm = own_map(genome, repeat=np.unique(K.canonical_u64(rfwd[::50], k - 1)))
        codes = genome[1000 : 1000 + (1 << 20) + 296].copy()
        for lo in range(1000, codes.size, 100_003):
            codes[lo : lo + 40] = 255  # runs across tiles
        codes[rng.integers(0, codes.size, 300)] = 255
        return qm, codes
    if name == "second-slots":
        genome = rng.integers(0, 4, 16_000, dtype=np.uint8)
        return own_map(genome, load_factor=0.49), genome
    if name == "all-absent":
        return own_map(rng.integers(0, 4, 16_000, dtype=np.uint8)), rng.integers(0, 4, 8192, dtype=np.uint8)
    if name == "full-stash-unsorted":
        genome = rng.integers(0, 4, 16_000, dtype=np.uint8)
        qm = own_map(genome)
        q, _ = K.kmers_from_codes(genome[5000:7000], k - 1)
        room = 64 - int((qm.stash_keys != _SENT).sum())
        stashed = move_to_stash_walk(qm, np.unique(K.canonical_u64(q, k - 1))[:room])
        assert stashed.stash_keys.size == 64
        return X.QMap(stashed.slots, stashed.log_size, stashed.stash_keys[::-1].copy(),
                      stashed.stash_payload[::-1].copy()), genome
    raise KeyError(name)


PAIR_PIPELINE_NAMES = ("long-ragged", "second-slots", "all-absent", "full-stash-unsorted")


def pair_pipeline_case(k: int, name: str, seed: int = 0, cut: int | None = None):
    """(host pair map, codes u8[w]) of one of K10's pipeline cases at k (3
    to 32), the windows and maps that stress its probes across tiles (512
    pairs a block): "long-ragged": 2^20 + 296 bases (1,025 tiles, the last
    ragged; P = w - k + 1 odd at odd k and even at even k, so k = 31 and 32
    give rep8 both parities of its last pair) of a genome whose k-mers make
    the map, every 50th (k-1)-mer the repeat set, with N runs across tiles
    and isolated Ns (`cut` keeps its first `cut` bases, a multiple of 8);
    "second-slots": 65,536 bases of a 250,000-base genome over the map of
    its k-mers built at a load factor of 0.49, near the most the map takes
    (~27% of the pairs in their second row at k = 31); "all-absent": 8,192
    random bases over the map of an unrelated genome (from k = 13 on every
    pair misses its first row); "full-stash-unsorted": 16,000 bases of a
    genome over the map of its k-mers with 64 of its pair keys moved to the
    stash (below k = 6, all of them and keys that no window holds), the
    stash in descending order."""
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed + k)
    none = np.zeros(0, np.uint64)

    def own_map(genome, load_factor=0.35, repeat=none):
        fwd, _ = K.kmers_from_codes(genome, k)
        return X.build_fused_pair(np.unique(K.canonical_u64(fwd, k)), k, repeat, load_factor=load_factor)

    if name == "long-ragged":
        genome = rng.integers(0, 4, (1 << 20) + 4096, dtype=np.uint8)
        rfwd, _ = K.kmers_from_codes(genome, k - 1)
        qp = own_map(genome, repeat=np.unique(K.canonical_u64(rfwd[::50], k - 1)))
        codes = genome[1000 : 1000 + (1 << 20) + 296].copy()
        for lo in range(1000, codes.size, 100_003):
            codes[lo : lo + 40] = 255  # runs across tiles
        codes[rng.integers(0, codes.size, 300)] = 255
        return qp, codes[:cut] if cut else codes
    if name == "second-slots":
        genome = rng.integers(0, 4, 250_000, dtype=np.uint8)
        return own_map(genome, load_factor=0.49), genome[50_000 : 50_000 + (1 << 16)].copy()
    if name == "all-absent":
        return own_map(rng.integers(0, 4, 16_000, dtype=np.uint8)), rng.integers(0, 4, 8192, dtype=np.uint8)
    if name == "full-stash-unsorted":
        genome = rng.integers(0, 4, 16_000, dtype=np.uint8)
        r, _ = K.kmers_from_codes(genome[5000:7000], k - 2)
        stashed = move_to_stash(own_map(genome), np.unique(K.canonical_u64(r, k - 2))[:64])
        # below k = 6 there are fewer than 64 (k-2)-mers: keys that no window holds fill the stash
        fill = 64 - stashed.stash_keys.size
        sk = np.concatenate([stashed.stash_keys, np.arange(fill, dtype=np.uint64) + np.uint64(1 << 62)])
        sl, sr = (np.concatenate([col, rng.integers(1, 1 << 36, fill, dtype=np.uint64)])
                  for col in (stashed.stash_l, stashed.stash_r))
        order = np.argsort(sk)[::-1]
        return X.QMapP(stashed.slots, stashed.log_size, k, sk[order], sl[order], sr[order]), genome
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the tiles of K15 and K16: each tile of 512 pairs (K15) or of 1,024
# positions (K16; 512 above k = 129) writes all of its positions, so it
# probes the key past its end, its halo, itself

HALO_STATES = ("halo-second", "halo-stash", "halo-absent")
PAIR_TILE_KS = (24, 25, 26, 27, 28, 31, 32)
SPAN_TILE_CASES = tuple((k, side) for k in (45, 128, 129, 130) for side in ("below", "above"))


def move_to_second_row(qp: X.QMapP, keys) -> X.QMapP:
    """Copy of host map `qp` with each of `keys` (canonical (k-2)-mers in
    the table) in its second row: moved there from its first, where the
    second row is free."""
    slots = qp.slots.copy()
    shift = 64 - qp.log_size
    rem_mask = (1 << shift) - 1
    for key in (int(x) for x in keys):
        h1, h2 = _mix(key, int(X._H1)), _mix(key, int(X._H2))
        r1, r2 = h1 >> shift, h2 >> shift
        lane0 = int(slots[r2, 0])
        if (lane0 >> 9) & 1 and (lane0 >> 8) & 1 and (lane0 >> 10) & ((1 << 45) - 1) == h2 & rem_mask:
            continue  # there already
        lane0 = int(slots[r1, 0])
        if not ((lane0 >> 9) & 1 and not (lane0 >> 8) & 1 and (lane0 >> 10) & ((1 << 45) - 1) == h1 & rem_mask):
            raise KeyError(f"{key} is not in the table")
        if slots[r2].any():
            raise ValueError(f"the second row of {key} is taken")
        slots[r2] = np.array([(h2 & rem_mask) << 10 | 1 << 9 | 1 << 8 | lane0 & 0xFF, int(slots[r1, 1])], np.uint64)
        slots[r1] = 0
    return X.QMapP(slots, qp.log_size, qp.k, qp.stash_keys, qp.stash_l, qp.stash_r)


def move_to_second_slot_span(qms: X.QMapSpan, rows) -> X.QMapSpan:
    """Copy of host span map `qms` with each of `rows` (canonical (k-1)-mer
    rows [n, Wq] in the table) in its second slot: moved there from its
    first, where the second slot is free."""
    from mindthegap_tpu_torch.ops.span_device import digest64

    slots, sat = qms.slots.copy(), qms.sat.copy()
    shift = 64 - qms.log_size
    rem_mask = (1 << shift) - 1
    wq = sat.shape[0] + 1
    rows = np.asarray(rows, np.uint64).reshape(-1, wq)
    for row, dig in zip(rows, digest64(rows.T)):
        dig = int(dig) ^ qms.salt
        (h1, s1), (h2, s2) = ((h, h >> shift) for h in (_mix(dig, int(X._H1)), _mix(dig, int(X._H2))))
        here = [(int(slots[s]) >> 10) & 1 and (int(slots[s]) >> 9) & 1 == i and int(slots[s]) >> 11 == h & rem_mask
                and tuple(int(x) for x in sat[:, s]) == tuple(int(x) for x in row[1:])
                for i, (h, s) in enumerate(((h1, s1), (h2, s2)))]
        if here[1]:
            continue
        if not here[0]:
            raise KeyError(f"{row} is not in the table")
        if (int(slots[s2]) >> 10) & 1:
            raise ValueError(f"the second slot of {row} is taken")
        slots[s2] = np.uint64((h2 & rem_mask) << 11 | 1 << 10 | 1 << 9 | int(slots[s1]) & 0x1FF)
        sat[:, s2] = sat[:, s1]
        slots[s1] = 0
        sat[:, s1] = 0
    return X.QMapSpan(slots, sat, qms.log_size, qms.salt, qms.stash_key64, qms.stash_sat, qms.stash_payload)


def pair_tile_case(k: int, state: str, seed: int = 0):
    """(host pair map, codes u8[4,120]) of K15's tile edges at k (24 to
    32): a window of a genome whose k-mers make the map (every 40th
    (k-1)-mer the repeat set), P = 4,121 - k positions: at k = 25 P =
    4,096, four whole tiles, the last tile's halo (pair 2,048) holding
    entry P; at k = 26 and 27 the 2,048 pairs end at the fourth tile's
    end, at k = 28 one pair before it, at k = 24 one past it (a fifth
    tile of one pair); at k = 31 and 32 P = 4,090 and 4,089. The key of
    every tile's halo that the window holds (pairs 512, 1,024, 1,536,
    2,048) is in its second row ("halo-second"), in the stash
    ("halo-stash"), or nowhere: a base of it changed in the window
    ("halo-absent"). The genome is the first of seed + k, seed + k + 100,
    ... whose halo keys' second rows are free."""
    from mindthegap_tpu_torch.ops import kmers as K

    for attempt in range(20):
        rng = np.random.default_rng(seed + k + 100 * attempt)
        genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
        fwd, _ = K.kmers_from_codes(genome[:30_000], k)
        rfwd, _ = K.kmers_from_codes(genome[:30_000], k - 1)
        qp = X.build_fused_pair(np.unique(K.canonical_u64(fwd, k)), k, np.unique(K.canonical_u64(rfwd[::40], k - 1)))
        codes = genome[10_000 : 10_000 + 4120].copy()
        halos = [m for m in (512, 1024, 1536, 2048) if 2 * m + k - 2 < codes.size]  # the key: bases 2m+1 .. 2m+k-2
        r, _ = K.kmers_from_codes(codes, k - 2)
        keys = np.unique(K.canonical_u64(r[[2 * m + 1 for m in halos]], k - 2))
        if state != "halo-second":
            break
        try:
            qp = move_to_second_row(qp, keys)
            break
        except ValueError:  # a second row taken: the next genome
            continue
    if state == "halo-second":
        pass
    elif state == "halo-stash":
        qp = move_to_stash(qp, keys)
    elif state == "halo-absent":
        for m in halos:
            codes[2 * m + k // 2] ^= 1
    else:
        raise KeyError(state)
    return qp, codes


def span_tile_case(k: int, side: str, state: str, seed: int = 0):
    """(host span map, codes u8[w]) of K16's tile edges at k (33 to 256;
    tiles of 1,024 positions to k = 129, then 512): a window of a genome
    whose k-mers make the map (every 40th (k-1)-mer the repeat set) whose P
    = w - k + 1 positions end at the fourth tile's end or just below it
    ("below": w the largest multiple of 8 with P <= 4 tiles) or just above
    it ("above": the smallest with P >= 4 tiles); at k = 129 both end at
    it, at k = 128 one past it, at k = 130 one before it. The halo key of
    every tile that the window holds ((k-1)-mers 1, 2, 3 and 4 tiles in)
    is in its second slot ("halo-second"), in the stash ("halo-stash"), or
    nowhere: a base of it changed in the window ("halo-absent"). The genome
    is the first of seed + k, seed + k + 100, ... whose halo keys' second
    slots are free."""
    tile = 1024 if k <= 129 else 512
    end = 4 * tile + k - 1  # the w at which P is four tiles
    w = end // 8 * 8 if side == "below" else -(-end // 8) * 8
    halos = [j * tile for j in range(1, 5) if j * tile + k - 1 <= w]  # the (k-1)-mer from base j * tile
    for attempt in range(20):
        rng = np.random.default_rng(seed + k + 100 * attempt)
        genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
        _fwd, canon = _span_rows(genome[:30_000], k)
        _qf, qcanon = _span_rows(genome[:30_000], k - 1)
        qms = X.build_fused_span(_unique_rows(canon, k), k, _unique_rows(qcanon[::40], k - 1))
        codes = genome[10_000 : 10_000 + w].copy()
        _q, qc = _span_rows(codes, k - 1)
        rows = _unique_rows(qc[halos], k - 1)
        if state != "halo-second":
            break
        try:
            qms = move_to_second_slot_span(qms, rows)
            break
        except ValueError:  # a second slot taken: the next genome
            continue
    if state == "halo-second":
        pass
    elif state == "halo-stash":
        qms = move_to_stash_span(qms, rows)
    elif state == "halo-absent":
        for j in halos:
            codes[j + k // 2] ^= 1
    else:
        raise KeyError(state)
    return qms, codes


SCATTER_EDGE_NAMES = ("ragged", "padding-anywhere", "all-padding", "all-real", "one-lane", "owner-segments")


def scatter_edge_cases(seed: int = 0):
    """{name: (verdicts u8[m], lanes int32[m], lane count)} for K13's scatter
    (4 slots a thread, 1,024 a block): 12,295 slots (neither a multiple
    of a block's nor a thread's), a third of them real, the padding (lane -1)
    anywhere; every other slot real; all padding; all real (a permutation
    of 4,099 lanes); one lane; 4 owners' segments of 1,000 slots, each a
    real prefix in ascending lane order then padding, as K12 fills them."""
    rng = np.random.default_rng(seed)

    def case(m, lanes, real):
        lane = np.full(m, -1, np.int32)
        lane[real] = rng.choice(lanes, int(np.count_nonzero(real)), replace=False)
        return rng.integers(0, 2, m).astype(np.uint8), lane, lanes

    m = 12 * 1024 + 7
    cases = {
        "ragged": case(m, 20_000, rng.random(m) < 1 / 3),
        "padding-anywhere": case(4000, 5000, np.arange(4000) % 2 == 1),
        "all-padding": case(1000, 300, np.zeros(1000, bool)),
        "all-real": case(4099, 4099, np.ones(4099, bool)),
        "one-lane": case(9, 1, np.arange(9) == 4),
    }
    seg = np.full((4, 1000), -1, np.int32)
    lanes = rng.permutation(8000)[:2200].astype(np.int32)
    for o, (lo, hi) in enumerate(((0, 700), (700, 1300), (1300, 2200), (2200, 2200))):
        seg[o, : hi - lo] = np.sort(lanes[lo:hi])
    cases["owner-segments"] = (rng.integers(0, 2, 4000).astype(np.uint8), seg.reshape(-1), 8000)
    assert tuple(cases) == SCATTER_EDGE_NAMES
    return cases


# ---------------------------------------------------------------------------
# the device mesh: K11's chunks, K12's and K13's key sets and queries, K14's
# windows over sorted sets

SWIZZLE_EDGE_NAMES = ("reads-ns", "one-window", "all-invalid", "n-at-ends", "tile-boundaries", "ragged-16")


def swizzle_edge_chunks(k: int, seed: int = 0):
    """{name: codes u8} for K11 at this k (1 to 32): 5,000 bases of read
    codes joined by invalid bases with N runs across the first kernel's
    1,024-window tiles; a chunk of exactly k bases (one window); a chunk of
    invalid bases only; Ns as the first and last bases of a chunk one tile
    and a few windows long; 2^17 + 40 bases (at least 2^17 windows) with N
    runs across the kernel's 2,048-window tiles and on 64-base and 16-base
    boundaries (the staging units); 4,103 bases, a length that is not a
    multiple of 16 (the last unit staged byte by byte)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, 5000, dtype=np.uint8)
    reads[150::151] = 255
    for lo in (1000, 2040, 3070):
        reads[lo : lo + 10] = 255
    ends = rng.integers(0, 4, 1024 + k + 5, dtype=np.uint8)
    ends[0] = ends[-1] = 255
    tiles = rng.integers(0, 4, (1 << 17) + 40, dtype=np.uint8)
    for m in range(1, 64, 3):
        tiles[2048 * m - 2 : 2048 * m + 1] = 255  # a run across a tile boundary
    tiles[64 * np.arange(7, 2048, 37)] = 255      # first bases of 64-base spans
    tiles[16 * np.arange(11, 8192, 53) - 1] = 255  # last bases of 16-base units
    ragged = rng.integers(0, 4, 4103, dtype=np.uint8)
    ragged[[0, 15, 16, 2047, 2048, 4095, 4096, 4102]] = 255
    cases = {
        "reads-ns": reads,
        "one-window": rng.integers(0, 4, k, dtype=np.uint8),
        "all-invalid": np.full(600, 255, np.uint8),
        "n-at-ends": ends,
        "tile-boundaries": tiles,
        "ragged-16": ragged,
    }
    assert tuple(cases) == SWIZZLE_EDGE_NAMES
    return cases


MEMBER_EDGE_NAMES = ("mixed", "empty-set", "key-at-bound", "high-keys", "one-shard", "overflow", "one-lane",
                     "tiles-interleaved", "owner-at-cap", "owner-over-cap", "one-owner", "sentinel-queries",
                     "eight-shards", "one-far-key", "narrow-range", "sentinel-tail-1", "sentinel-tail-2",
                     "sentinel-tail-3", "single-key", "outside-range")


def _owner_runs(keys, counts, seed: int):
    """Queries on 4 shards of len(counts) lanes each: shard j's lanes hold
    counts[j][o] keys of owner o (key shard o of `keys`, 4 even shards),
    shuffled within the shard."""
    rng = np.random.default_rng(seed)
    per = keys.size // 4
    rows, used = [], [0] * 4
    for shard in counts:
        row = []
        for o, c in enumerate(shard):
            row.append(keys[o * per + used[o] : o * per + used[o] + c])
            used[o] += c
        row = np.concatenate(row)
        rng.shuffle(row)
        rows.append(row)
    return np.concatenate(rows)


def member_edge_cases(seed: int = 0):
    """{name: (sorted keys u64, queries u64, shards, cap_factor)} for K12 and
    K13 through ShardedMembership: present and absent keys on 4 shards; an
    empty key set; queries equal to each shard's first key (an owner bound)
    and its neighbours; keys and queries above 2^63 (unsigned order: the
    owner bounds negative as int64); one shard; a capacity of 64 (overflow,
    the host route); a single query (lanes padded with the SENTINEL);
    2^17 lanes a shard on 4 shards, owners interleaved so that each owner's
    lanes cross all 64 of a shard's 2,048-lane tiles; present keys only
    (each one a Bloom positive) at a capacity of 64, with one owner's count
    on shard 0 exactly at the capacity, and at one above it (overflow); every
    query in one owner's key range, at a capacity that holds them all;
    SENTINEL queries among real ones; 8 shards. Then the sets that skew
    the owners' bucket indexes (ops/sorted_index.py): 1,999 keys 3 apart
    and one far key (the last shard's keys but one in its first bucket);
    16 values 64 times each (a range smaller than the bucket count, every
    key a duplicate); key counts that leave 1, 2 and 3 SENTINEL keys at the
    end of the last shard (its padding slots found there); a single key
    (three shards of SENTINEL alone); queries below and above every key."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    keys = keys[: keys.size // 8 * 8]  # even shards: no SENTINEL padding among the keys
    mixed = np.concatenate([rng.choice(keys, 3000), rng.integers(0, 1 << 62, 3000, dtype=np.uint64)])
    rng.shuffle(mixed)
    per = -(-keys.size // 4)
    bounds = keys[::per]
    one = np.uint64(1)
    at_bound = np.concatenate([bounds, bounds - one, bounds + one, keys[-1:], keys[-1:] + one])
    high = np.unique(rng.integers(0, 1 << 64, 5000, dtype=np.uint64))
    high_q = np.concatenate([rng.choice(high, 2000), rng.integers(0, 1 << 64, 2000, dtype=np.uint64), high[::1250]])
    big = np.unique(rng.integers(0, 1 << 62, 1 << 16, dtype=np.uint64))
    big = big[: big.size // 4 * 4]
    interleaved = np.concatenate([rng.choice(big, 1 << 18), rng.integers(0, 1 << 62, 1 << 18, dtype=np.uint64)])
    rng.shuffle(interleaved)
    # 4 shards of 128 lanes (512 queries), capacity 64: owner 0 on shard 0 at 64, then at 65
    at_cap = _owner_runs(keys, [[64, 64, 0, 0], [0, 64, 64, 0], [0, 0, 64, 64], [64, 0, 0, 64]], seed)
    over_cap = _owner_runs(keys, [[65, 63, 0, 0], [0, 64, 64, 0], [0, 0, 64, 64], [63, 0, 0, 65]], seed)
    lo, hi = int(bounds[2]), int(bounds[3])
    one_owner = np.concatenate([keys[2 * per : 3 * per], rng.integers(lo, hi, 1000, dtype=np.uint64)])
    rng.shuffle(one_owner)
    with_sentinel = mixed.copy()
    with_sentinel[rng.choice(mixed.size, 300, replace=False)] = np.uint64(0xFFFFFFFFFFFFFFFF)
    cases = {
        "mixed": (keys, mixed, 4, 1.25),
        "empty-set": (np.zeros(0, np.uint64), mixed[:500], 4, 1.25),
        "key-at-bound": (keys, at_bound, 4, 1.25),
        "high-keys": (high, high_q, 4, 1.25),
        "one-shard": (keys, mixed, 1, 1.25),
        "overflow": (keys, mixed, 4, 0.0),
        "one-lane": (keys, keys[7:8], 4, 1.25),
        "tiles-interleaved": (big, interleaved, 4, 1.25),
        "owner-at-cap": (keys, at_cap, 4, 0.0),
        "owner-over-cap": (keys, over_cap, 4, 0.0),
        "one-owner": (keys, one_owner, 4, 4.0),
        "sentinel-queries": (keys, with_sentinel, 4, 1.25),
        "eight-shards": (keys, mixed, 8, 1.25),
    }
    srng = np.random.default_rng(seed + 1)  # the skewed sets' own draws
    cluster = np.arange(1999, dtype=np.uint64) * np.uint64(3) + np.uint64(1000)
    far = np.uint64((1 << 62) + 12345)
    far_q = np.concatenate([srng.choice(cluster, 1500), srng.integers(900, 7100, 1500, dtype=np.uint64),
                            [far, far - one, far + one], srng.integers(0, 1 << 63, 200, dtype=np.uint64)])
    narrow = np.repeat(np.arange(100, 116, dtype=np.uint64), 64)
    cases["one-far-key"] = (np.append(cluster, far), far_q, 4, 1.25)
    cases["narrow-range"] = (narrow, srng.integers(90, 130, 2000, dtype=np.uint64), 4, 1.25)
    for tail in (1, 2, 3):
        tkeys = np.unique(srng.integers(0, 1 << 62, 1200, dtype=np.uint64))[: 1000 - tail]
        tq = np.concatenate([srng.choice(tkeys, 1000), srng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
        cases[f"sentinel-tail-{tail}"] = (tkeys, tq, 4, 1.25)
    single = keys[100:101]
    cases["single-key"] = (single, np.concatenate([single, single - one, single + one, mixed[:500]]), 4, 1.25)
    inner = np.unique(srng.integers(1 << 40, 1 << 41, 3000, dtype=np.uint64))
    outer = np.concatenate([srng.choice(inner, 1000), srng.integers(0, 1 << 40, 1000, dtype=np.uint64),
                            srng.integers(1 << 41, 1 << 63, 1000, dtype=np.uint64), inner[[0, -1]] - one,
                            inner[[0, -1]] + one])
    cases["outside-range"] = (inner, outer, 4, 1.25)
    assert tuple(cases) == MEMBER_EDGE_NAMES
    return cases


ROUTE_EDGE_NAMES = ("64-shards",)


def route_edge_cases(seed: int = 0):
    """{name: (sorted keys u64, queries u64, shards, cap_factor)} for K12 at
    its most shards (64, beyond the JAX test mesh's 8): 2^14 keys, present
    and absent queries over 4,096 lanes a shard (shards past the queries
    hold SENTINEL padding only)."""
    rng = np.random.default_rng(seed + 64)
    keys = np.unique(rng.integers(0, 1 << 63, 1 << 14, dtype=np.uint64))
    keys = keys[: keys.size // 64 * 64]
    q = np.concatenate([rng.choice(keys, 96_000), rng.integers(0, 1 << 63, 96_000, dtype=np.uint64)])
    rng.shuffle(q)
    cases = {"64-shards": (keys, q, 64, 1.25)}
    assert tuple(cases) == ROUTE_EDGE_NAMES
    return cases


SORTED_EDGE_NAMES = ("genome-ns", "empty-solid", "empty-repeat", "all-invalid", "shortest", "one-far-key",
                     "narrow-range", "high-keys", "sentinel-tail", "single-key", "outside-range")


def sorted_edge_windows(k: int, seed: int = 0):
    """{name: (codes u8, solid, repeat: sorted u64 sets)} for K14 at k (2
    to 32): 3,000 bases of a genome whose k-mers make the
    solid set (every third one left out, and 200 random keys added), its
    every 7th (k-1)-mer the repeat set, with N runs across the kernel's
    256-position blocks; the same window over an empty solid set and over an
    empty repeat set; a window of invalid bases; a window of k bases. Then
    the same window over sets that skew their bucket indexes
    (ops/sorted_index.py), each made of the window's own canonical k-mers
    (and (k-1)-mers): the 100 smallest and one far key (all but one in the
    first bucket, which is longer than a lookup's first loads); 16
    consecutive words 8 times each (a range smaller than the bucket count;
    at k = 2 the whole k-mer space); every word with 200 keys of 2^63 and
    above (unsigned order); with a SENTINEL tail of 3 and of 1; a single
    key; the middle half of the words (lookups below and above the range)."""
    from mindthegap_tpu_torch.ops import kmers as K

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome, k)
    top = np.uint64(1 << 63) if k == 32 else np.uint64(1 << (2 * k)) - np.uint64(1)
    extra = rng.integers(0, int(top), 200, dtype=np.uint64)
    solid = np.unique(np.concatenate([K.canonical_u64(np.delete(fwd, np.s_[::3]), k), K.canonical_u64(extra, k)]))
    rfwd, _ = K.kmers_from_codes(genome, k - 1)
    repeat = np.unique(K.canonical_u64(rfwd[::7], k - 1))
    window = genome[500:3500].copy()
    for lo in (250, 510, 1020):
        window[lo : lo + 9] = 255
    empty = np.zeros(0, np.uint64)
    cases = {
        "genome-ns": (window, solid, repeat),
        "empty-solid": (window, empty, repeat),
        "empty-repeat": (window, solid, empty),
        "all-invalid": (np.full(300, 255, np.uint8), solid, repeat),
        "shortest": (genome[1000 : 1000 + k].copy(), solid, repeat),
    }
    srng = np.random.default_rng(seed + 1)  # the skewed sets' own draws
    wfwd, _ = K.kmers_from_codes(genome[500:3500], k)
    wrep, _ = K.kmers_from_codes(genome[500:3500], k - 1)
    sets = (np.unique(K.canonical_u64(wfwd, k)), np.unique(K.canonical_u64(wrep, k - 1)))
    far, sent = np.uint64((1 << 64) - 2), np.uint64(0xFFFFFFFFFFFFFFFF)

    def narrow(words, width):
        lo = max(0, min(int(words[words.size // 2]) - 8, (1 << (2 * width)) - 16))
        return np.repeat(np.arange(lo, lo + 16, dtype=np.uint64), 8)

    def high(words):
        return np.unique(np.concatenate([words, srng.integers(1 << 63, (1 << 64) - 1, 200, dtype=np.uint64)]))

    cases["one-far-key"] = (window, *(np.append(w[:100], far) for w in sets))
    cases["narrow-range"] = (window, narrow(sets[0], k), narrow(sets[1], k - 1))
    cases["high-keys"] = (window, high(sets[0]), high(sets[1]))
    cases["sentinel-tail"] = (window, np.append(sets[0], [sent] * 3), np.append(sets[1], sent))
    cases["single-key"] = (window, sets[0][sets[0].size // 3 :][:1], sets[1][:1])
    cases["outside-range"] = (window, *(w[w.size // 4 : 3 * w.size // 4] for w in sets))
    assert tuple(cases) == SORTED_EDGE_NAMES
    return cases


INDEX_EDGE_NAMES = ("tail-one-real", "one-sentinel", "long-tail", "range-above-power-of-two", "n-2^20-minus-1",
                    "n-2^20", "n-2^20-plus-1", "empty", "across-2^63", "tail-31", "tail-32", "tail-33",
                    "short-tailed", "all-sentinel-5", "all-sentinel-40")


def index_edge_sets(seed: int = 0):
    """{name: sorted u64 keys} for the bucket index's build
    (ops/sorted_index.py, csrc/sorted_index.cu): one real key before a tail
    of 5,000 SENTINELs; 100,000 keys and exactly one SENTINEL; 300,000
    keys before a tail of 700,000 SENTINELs (the search for the first
    SENTINEL over three of its rounds); hi - lo just above a power of two
    (the buckets after hi's are half of them); 2^20 - 1, 2^20 and 2^20 + 1
    keys; no key; 100,000 keys across 2^63 (unsigned order); tails of 31,
    32 and 33 SENTINELs after 50,000 keys (the kernel reads the last 32
    keys, then searches); 7 keys and 3 SENTINELs (fewer than 32 keys);
    5 and 40 SENTINELs and no other key."""
    rng = np.random.default_rng(seed)

    def uniform(n, lo=0, width=1 << 62):
        keys = np.unique(rng.integers(0, width, n + n // 50 + 16, dtype=np.uint64) + np.uint64(lo))
        return keys[:n]

    base = np.uint64(1 << 40)
    above = np.unique(np.concatenate([uniform(200_000, 1 << 40, 1 << 32), [base, base + np.uint64((1 << 32) + 999)]]))
    cases = {
        "tail-one-real": np.append(uniform(1), [_SENT] * 5000),
        "one-sentinel": np.append(uniform(100_000), _SENT),
        "long-tail": np.append(uniform(300_000), [_SENT] * 700_000),
        "range-above-power-of-two": above,
        "n-2^20-minus-1": uniform((1 << 20) - 1),
        "n-2^20": uniform(1 << 20),
        "n-2^20-plus-1": uniform((1 << 20) + 1),
        "empty": np.zeros(0, np.uint64),
        "across-2^63": uniform(100_000, (1 << 63) - (1 << 40), 1 << 41),
        **{f"tail-{t}": np.append(uniform(50_000), [_SENT] * t) for t in (31, 32, 33)},
        "short-tailed": np.append(uniform(7), [_SENT] * 3),
        "all-sentinel-5": np.full(5, _SENT),
        "all-sentinel-40": np.full(40, _SENT),
    }
    assert tuple(cases) == INDEX_EDGE_NAMES
    return cases


# ---------------------------------------------------------------------------
# the analysis scripts' case (mindthegap_tpu_torch/scripts/context_genome_wg.py)

SCRIPT_CHROMS = (("ref", 12_000), ("chr2", 6_000))


def script_case(root: str, k: int, seed: int = 0) -> dict:
    """Files of context_genome_wg's case at k (k <= 32 or the span
    layout), written under `root`: "ref.fa" (two sequences, the second
    with an N run), "graph.h5" (the solid set: every k-mer of the
    sequences, and the k-mers of one-SNP copies of the 50 bases upstream of
    every other breakpoint, 2, 4, ..., 12 SNP sites for the 1st, 2nd, ...,
    6th of them, each site making two reference positions branch, so that a
    degree of 3 or 4 covers 4% to ~30% of the window the script reads) and
    "t.breakpoints" (find's records: 10 on
    "ref", one of them 20 bases from its start; 2 on "chr2", one just after
    the N run; one on a sequence the reference does not hold). Returns the
    paths, the planted positions and the sequences' codes."""
    import os

    from mindthegap_tpu_torch.graph import dbg as D
    from mindthegap_tpu_torch.ops import kmers as K
    from mindthegap_tpu_torch.ops.span import Span

    rng = np.random.default_rng(seed + k)
    seqs = {name: rng.integers(0, 4, n, dtype=np.uint8) for name, n in SCRIPT_CHROMS}
    seqs["chr2"][3000:3040] = 255
    bkpts = [("ref", p) for p in (20, *range(700, 12_000, 1250))] + [("chr2", 1500), ("chr2", 3100), ("chrX", 400)]
    planted = [(c, p) for i, (c, p) in enumerate(bkpts) if c != "chrX" and i % 2 == 1]
    pieces = [codes for codes in seqs.values()]
    for j, (chrom, p) in enumerate(planted):
        codes = seqs[chrom]
        for s in range(p - 48, p - 48 + 8 * (j + 1), 4):  # a SNP at base s in a copy of the k - 1 bases on each side
            copy = codes[s - k + 1 : s + k].copy()
            copy[k - 1] = (copy[k - 1] + 1) % 4
            pieces.append(copy)
    if k <= 32:
        keys = [K.canonical_u64(fwd[valid], k) for fwd, valid in (K.kmers_from_codes(c, k) for c in pieces)]
    else:
        sp = Span(k)
        keys = [sp.keys(sp.canonical(rows[valid])) for rows, valid in (sp.from_codes(c) for c in pieces)]
    graph = D.Graph(D.SolidSet(np.unique(np.concatenate(keys)), k))
    paths = {name: os.path.join(root, name) for name in ("ref.fa", "graph.h5", "t.breakpoints")}
    graph.save(paths["graph.h5"])
    letters = np.frombuffer(b"ACTG", np.uint8)
    with open(paths["ref.fa"], "w") as f:
        for name, codes in seqs.items():
            f.write(f">{name} a test sequence\n")
            f.write(np.where(codes == 255, ord("N"), letters[np.minimum(codes, 3)]).astype(np.uint8).tobytes().decode())
            f.write("\n")
    with open(paths["t.breakpoints"], "w") as f:
        for i, (chrom, p) in enumerate(bkpts):
            left, right = rng.integers(0, 4, k), rng.integers(0, 4, k)
            for side, kmer in (("left", left), ("right", right)):
                f.write(f">bkpt{i + 1}_{chrom}_pos_{p}_fuzzy_0_HOM  {side}_kmer\n")
                f.write(letters[kmer].tobytes().decode() + "\n")
    return {"paths": paths, "planted": planted, "seqs": seqs}

