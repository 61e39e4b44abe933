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
