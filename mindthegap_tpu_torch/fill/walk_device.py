"""Device-batched fill walker: simple-path extension over many jobs at once
(the counterpart of mindthegap_tpu/fill/walk_device.py).

The `fill` hot loop (reference src/Filler.cpp:854-884: per-breakpoint
bounded BFS in the DBG) spends nearly all of its probes on uninterrupted
simple-path stretches. The traversal automaton (fill/traversal.py) yields
exactly those stretches as ("walk", node, budget) requests; this module
satisfies them for J jobs at once on the device. Per step and job, one
fused quotient-map lookup (ops/extmap.py QMap or QMapB) gives the
successor bitmap of `node` and the predecessor bitmap of its unique
successor; the next step's lookup, carried, gives the successor bitmap of
the successor. The walk stops:

  "tip"    when node has no successor;
  "event"  when node forks, the successor has != 1 predecessors, or the
           successor has != 1 successors — the sparse cases the host
           automaton replays exactly;
  "budget" when the job's base budget is spent.

Appended bases occupy the first n_appended slots of each job's row.
walk_batch (k <= 32) runs the hand kernel K5 (csrc/walk.cu: a team of
threads per lane, probing several steps ahead per DRAM round trip) on CUDA
tensors, and walk_batch_span (32 < k <= 256, multi-word nodes over the
span map) the hand kernel K7 (csrc/walk_span.cu: the same team look-ahead
over multi-word nodes); each runs its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_kernel_tensor, launch
from ..ops import extmap as X
from ..ops import kmers as K

STATUS_RUNNING = 0  # budget/steps exhausted; resume from end_node
STATUS_TIP = 1
STATUS_EVENT = 2

NO_BASE = 255

_LIVE_CHECK = 16  # the plain walk stops once no lane is live, checked this often


def _walk_batch_plain(nodes, budgets, slots, stash_k, stash_v, log_size: int, k: int,
                      steps: int, layout: str):
    """Plain version of K5: the step of the JAX walker as tensor ops over
    all lanes. It stops early once no lane is live: a stopped lane never
    changes, so the outputs are those of all `steps` steps."""
    if layout == "bucket":
        qm, lookup = X.QMapB(slots, log_size, stash_k, stash_v), X.lookup_qb
    else:
        qm, lookup = X.QMap(slots, log_size, stash_k, stash_v), X.lookup_q
    mask_k = K.i64(K.kmer_mask(k))
    mask_q = K.i64(K.kmer_mask(k - 1))
    # the 4-bit bitmap functions as 16-entry tables (one gather per use
    # instead of a dozen elementwise ops on a few lanes)
    nib = torch.arange(16, device=nodes.device)
    pop4 = X._popcount4(nib)
    base_of = ((nib >> 1) & 1) + 2 * ((nib >> 2) & 1) + 3 * ((nib >> 3) & 1)

    def ext_pre_of(node):
        """(ext, pre) of node's (k-1)-suffix as read."""
        q = node & mask_q
        cq = K.canonical_u64(q, k - 1)
        return X._oriented(lookup(qm, cq), q == cq)

    node = nodes.clone()
    ext, pre = ext_pre_of(node)
    n_app = torch.zeros_like(budgets)
    status = torch.zeros(nodes.shape, dtype=torch.uint8, device=nodes.device)
    bases = torch.full((nodes.shape[0], steps), NO_BASE, dtype=torch.uint8, device=nodes.device)
    for s in range(steps):
        live = (status == STATUS_RUNNING) & (n_app < budgets)
        if s % _LIVE_CHECK == 0 and not bool(live.any()):
            break
        cnt_out = pop4[ext]
        tip = cnt_out == 0
        fork = cnt_out > 1
        x = base_of[ext]  # with exactly one bit set: its index
        nxt = ((node << 2) | x) & mask_k
        merge = pop4[pre] != 1  # predecessors(nxt) != 1
        ext2, pre2 = ext_pre_of(nxt)
        branch2 = pop4[ext2] != 1  # successors(nxt) != 1

        stop_tip = live & tip
        stop_event = live & ~tip & (fork | merge | branch2)
        append = live & ~tip & ~fork & ~merge & ~branch2
        bases[:, s] = torch.where(append, x, NO_BASE).to(torch.uint8)
        status = torch.where(stop_tip, STATUS_TIP, status)
        status = torch.where(stop_event, STATUS_EVENT, status)
        node = torch.where(append, nxt, node)
        ext = torch.where(append, ext2, ext)
        pre = torch.where(append, pre2, pre)
        n_app = n_app + append.to(n_app.dtype)
    return bases, n_app, node, status


_WALK_LIB = None


def _walk_lib():
    global _WALK_LIB
    if _WALK_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("walk.cu", "libmtg_walk.so")
        lib.walk_launch.restype = ctypes.c_int
        lib.walk_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _WALK_LIB = lib
    return _WALK_LIB


# K5's look-ahead: a round probes every node the next D steps can reach,
# 1 + 4 + ... + 4^(D-1) of them (1, 5 or 21), in one DRAM round trip, so a
# lane's chain of dependent probes takes about 1/D of the round trips. The
# price is probes. While a round's probes over all lanes are few, a deeper
# round costs only issue slots; past what the card serves in one round
# trip, the probe rate sets the time and a deeper round only probes more.
# So D falls as the lanes grow, and sooner for the cuckoo map, whose probe
# is two random sectors, than for the bucket map, whose probe is one line.
# K7 ("span") probes eagerly, both cuckoo slots with their satellite words,
# 2 Wq sectors a probe, so its thresholds hold lanes x Wq. The thresholds
# are measured (python -m mindthegap_tpu_torch.kernel_bench on an H100,
# 2,048 steps; K5 at 1 to 65,536 lanes, K7 at k = 45 and k = 128): D = 3 is
# the fastest up to _MAX_LANES[layout][3] lanes (lane-words for "span"),
# D = 2 up to _MAX_LANES[layout][2], D = 1 beyond. Lanes count as walks: a
# lane with a budget of 0 probes nothing, and BatchWalker sends only the
# walks still live.
DEPTHS = (1, 2, 3)  # the depths csrc/walk.cu and csrc/walk_span.cu are built for
_MAX_LANES = {"cuckoo": {3: 1024, 2: 6144}, "bucket": {3: 1536, 2: 10240}, "span": {3: 1024, 2: 8192}}


def lookahead_depth(lanes: int, layout: str, words: int = 1) -> int:
    """K5's or K7's look-ahead depth D for `lanes` live walks in `layout`
    ("cuckoo", "bucket" or "span", whose probes read `words` = Wq sectors
    a slot; see above)."""
    return next((d for d in (3, 2) if lanes * words <= _MAX_LANES[layout][d]), 1)


def walk_batch_cuda(nodes, budgets, slots, stash_k, stash_v, log_size: int, k: int,
                    steps: int, layout: str, depth: int | None = None):
    """K5 (csrc/walk.cu): the same outputs as _walk_batch_plain, one team
    of threads per lane probing `depth` steps ahead per round trip
    (lookahead_depth; an explicit 1..3 is for measuring the rule). Counts
    its launches in `walk_batch_cuda.launches`."""
    check_kernel_tensor(nodes, "nodes", torch.int64, 1)
    check_kernel_tensor(budgets, "budgets", torch.int32, 1)
    check_kernel_tensor(slots, "slots", torch.int64, 1)
    check_kernel_tensor(stash_k, "stash_k", torch.int64, 1)
    check_kernel_tensor(stash_v, "stash_v", torch.int64, 1)
    lanes = nodes.shape[0]
    n_stash = stash_k.shape[0]
    if layout not in ("cuckoo", "bucket"):
        raise ValueError(f"unknown walker layout {layout!r}")
    bucket = layout == "bucket"
    if slots.shape[0] != (1 << log_size) * (16 if bucket else 1):
        raise ValueError(f"slots must hold {'16 * 2**log_nb' if bucket else '2**log_size'} words")
    if bucket and slots.data_ptr() % 16:
        raise ValueError("bucket slots must be 16-byte aligned (ulonglong2 loads)")
    if budgets.shape[0] != lanes or not 1 <= n_stash <= 64 or stash_v.shape[0] != n_stash:
        raise ValueError("budgets must match nodes and the stash must hold 1..64 entries")
    if not 3 <= k <= 32 or steps < 1:
        raise ValueError(f"k must be in [3, 32] and steps >= 1, got k={k}, steps={steps}")
    depth = lookahead_depth(lanes, layout) if depth is None else depth
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    dev = nodes.device
    bases = torch.full((lanes, steps), NO_BASE, dtype=torch.uint8, device=dev)
    n_app = torch.empty(lanes, dtype=torch.int32, device=dev)
    end_nodes = torch.empty(lanes, dtype=torch.int64, device=dev)
    status = torch.empty(lanes, dtype=torch.uint8, device=dev)
    launch("walk", _walk_lib().walk_launch,
           nodes.data_ptr(), budgets.data_ptr(), slots.data_ptr(), log_size, int(bucket),
           stash_k.data_ptr(), stash_v.data_ptr(), n_stash, k, steps, lanes, depth,
           bases.data_ptr(), n_app.data_ptr(), end_nodes.data_ptr(), status.data_ptr(),
           device=dev)
    walk_batch_cuda.launches += 1
    return bases, n_app, end_nodes, status


walk_batch_cuda.launches = 0


def walk_batch(nodes, budgets, slots, stash_k, stash_v, log_size: int, k: int,
               steps: int, layout: str = "cuckoo"):
    """Advance J simple-path walks by up to `steps` bases each.

    nodes:   int64[J] current k-mers (u64 words, forward orientation)
    budgets: int32[J] remaining per-job base budgets
    slots, stash_k, stash_v: the int64 tables of QMap.to / QMapB.to
    log_size: the QMap's log_size, or the QMapB's log_nb
    layout:  "cuckoo" (QMap, 2 gathers per probe) or "bucket" (QMapB, 1)

    Returns (bases u8[J, steps] — appended base codes, NO_BASE padding;
    n_appended i32[J]; end_nodes int64[J]; status u8[J])."""
    fn = walk_batch_cuda if nodes.is_cuda else _walk_batch_plain
    return fn(nodes, budgets, slots, stash_k, stash_v, log_size, k, steps, layout)


# ---------------------------------------------------------------------------
# The span walker (32 < k <= 256): nodes are int64 rows of Wk = ceil(k/32)
# words, word 0 most significant, over the multi-word map (ops/extmap.py
# QMapSpan); the same contract and stop reasons as walk_batch.


def _mask_top_span(words: torch.Tensor, nbases: int) -> torch.Tensor:
    """Keep the low 2 * nbases bits of a (W, J) span value."""
    from ..ops.span_device import span_width, top_mask

    w = words.shape[0]
    keep = span_width(nbases)  # the words that hold those bits, the top one masked
    out = words.clone()
    out[: w - keep] = 0
    out[w - keep] &= top_mask(nbases)
    return out


def _shl2_span(words: torch.Tensor, x=0) -> torch.Tensor:
    """(W, J) span value << 2, base x shifted in (no mask)."""
    low = torch.zeros_like(words[:1]) | x  # what enters the last word
    return (words << 2) | torch.cat([K.shr(words[1:], 62), low])


def _walk_batch_span_plain(nodes, budgets, slots, sat, stash_k64, stash_sat, stash_v,
                           salt: int, log_size: int, k: int, steps: int):
    """Plain version of K7: the step of the JAX span walker as tensor ops
    over all lanes, on (Wk, J) words. It stops early once no lane is live,
    as _walk_batch_plain does."""
    from ..ops import span_device as SD

    qm = X.QMapSpan(slots, sat, log_size, salt, stash_k64, stash_sat, stash_v)
    wk = nodes.shape[1]
    wq = SD.span_width(k - 1)
    nib = torch.arange(16, device=nodes.device)
    pop4 = X._popcount4(nib)
    base_of = ((nib >> 1) & 1) + 2 * ((nib >> 2) & 1) + 3 * ((nib >> 3) & 1)
    # each payload byte seen from the other strand (_oriented as a table)
    byte = torch.arange(256, device=nodes.device)
    flip8 = X._shuffle02(byte >> 4) | (X._shuffle02(byte & 0xF) << 4)

    def ext_pre_of(words):
        """(ext, pre) of each node's (k-1)-suffix as read."""
        q = _mask_top_span(words[wk - wq:], k - 1)
        cq, is_c = SD.canonical_span(q, k - 1)
        pay8 = X.lookup_q_span(qm, cq) & 0xFF
        ep = torch.where(is_c, pay8, flip8[pay8])
        return ep & 0xF, ep >> 4

    node = nodes.T.clone()  # (Wk, J)
    ext, pre = ext_pre_of(node)
    lanes = nodes.shape[0]
    n_app = torch.zeros_like(budgets)
    status = torch.zeros(lanes, dtype=torch.uint8, device=nodes.device)
    bases = torch.full((lanes, steps), NO_BASE, dtype=torch.uint8, device=nodes.device)
    for s in range(steps):
        live = (status == STATUS_RUNNING) & (n_app < budgets)
        if s % _LIVE_CHECK == 0 and not bool(live.any()):
            break
        cnt_out = pop4[ext]
        tip = cnt_out == 0
        fork = cnt_out > 1
        x = base_of[ext]  # with exactly one bit set: its index
        nxt = _mask_top_span(_shl2_span(node, x), k)
        merge = pop4[pre] != 1  # predecessors(nxt) != 1
        ext2, pre2 = ext_pre_of(nxt)
        branch2 = pop4[ext2] != 1  # successors(nxt) != 1

        stop_tip = live & tip
        stop_event = live & ~tip & (fork | merge | branch2)
        append = live & ~tip & ~fork & ~merge & ~branch2
        bases[:, s] = torch.where(append, x, NO_BASE).to(torch.uint8)
        status = torch.where(stop_tip, STATUS_TIP, status)
        status = torch.where(stop_event, STATUS_EVENT, status)
        node = torch.where(append[None, :], nxt, node)
        ext = torch.where(append, ext2, ext)
        pre = torch.where(append, pre2, pre)
        n_app = n_app + append.to(n_app.dtype)
    return bases, n_app, node.T.contiguous(), status


_WALK_SPAN_LIB = None


def _walk_span_lib():
    global _WALK_SPAN_LIB
    if _WALK_SPAN_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("walk_span.cu", "libmtg_walk_span.so")
        lib.walk_span_launch.restype = ctypes.c_int
        lib.walk_span_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _WALK_SPAN_LIB = lib
    return _WALK_SPAN_LIB


def walk_batch_span_cuda(nodes, budgets, slots, sat, stash_k64, stash_sat, stash_v,
                         salt: int, log_size: int, k: int, steps: int, depth: int | None = None):
    """K7 (csrc/walk_span.cu): the same outputs as _walk_batch_span_plain,
    one team of threads per lane probing `depth` steps ahead per round trip
    (lookahead_depth(lanes, "span", Wq); an explicit 1..3 is for measuring
    the rule). Counts its launches in `walk_batch_span_cuda.launches`."""
    from ..ops.span_device import span_width

    check_kernel_tensor(nodes, "nodes", torch.int64, 2)
    check_kernel_tensor(budgets, "budgets", torch.int32, 1)
    X.check_span_tables(slots, sat, stash_k64, stash_sat, stash_v, log_size, k)
    lanes = nodes.shape[0]
    if nodes.shape[1] != span_width(k) or budgets.shape[0] != lanes or lanes < 1 or steps < 1:
        raise ValueError(f"nodes must be [lanes >= 1, {span_width(k)}] words with a budget each, and steps >= 1")
    depth = lookahead_depth(lanes, "span", span_width(k - 1)) if depth is None else depth
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    dev = nodes.device
    bases = torch.full((lanes, steps), NO_BASE, dtype=torch.uint8, device=dev)
    n_app = torch.empty(lanes, dtype=torch.int32, device=dev)
    end_nodes = torch.empty_like(nodes)
    status = torch.empty(lanes, dtype=torch.uint8, device=dev)
    launch("span walk", _walk_span_lib().walk_span_launch,
           nodes.data_ptr(), budgets.data_ptr(),
           slots.data_ptr(), sat.data_ptr() if sat.numel() else None, log_size, K.i64(salt),
           stash_k64.data_ptr(), stash_sat.data_ptr() if stash_sat.numel() else None, stash_v.data_ptr(),
           stash_k64.shape[0], k, steps, lanes, depth,
           bases.data_ptr(), n_app.data_ptr(), end_nodes.data_ptr(), status.data_ptr(),
           device=dev)
    walk_batch_span_cuda.launches += 1
    return bases, n_app, end_nodes, status


walk_batch_span_cuda.launches = 0


def walk_batch_span(nodes, budgets, slots, sat, stash_k64, stash_sat, stash_v,
                    salt: int, log_size: int, k: int, steps: int):
    """Advance J simple-path walks by up to `steps` bases each, 32 < k <= 256.

    nodes:   int64[J, Wk] current k-mers (u64 words, word 0 most
             significant, forward orientation)
    budgets: int32[J] remaining per-job base budgets
    the map: the int64 tables of QMapSpan.to, its salt and log_size

    Returns (bases u8[J, steps] — appended base codes, NO_BASE padding;
    n_appended i32[J]; end_nodes int64[J, Wk]; status u8[J]). On a CUDA
    tensor this runs the kernel K7; on a CPU tensor its plain version."""
    fn = walk_batch_span_cuda if nodes.is_cuda else _walk_batch_span_plain
    return fn(nodes, budgets, slots, sat, stash_k64, stash_sat, stash_v, salt, log_size, k, steps)


class BatchWalker:
    """Host driver: satisfies batches of ("walk", node, budget) requests
    with walk_batch (k <= 32, a QMap or QMapB) or walk_batch_span (32 < k
    <= 256, a QMapSpan), re-invoking in `steps`-sized chunks until every
    lane has stopped. Each call takes only the walks still live, one lane
    each (at least `min_lanes`, the rest with a budget of 0), so that K5's
    and K7's look-ahead depth follows the live walks; the step count starts
    at 256 and doubles to 2048, as in the JAX walker. Span nodes travel as
    rows of Wk int64 words and come back as python ints.

    With `mesh` (a list of devices, a power of two of them;
    parallel/mesh.py) the lanes of a k <= 32 walk are split over the mesh,
    the map on every device (parallel/mesh.py walk_shards), as many lanes a
    shard; span walks ride `device` alone, as in the JAX package."""

    def __init__(self, qmap, k: int, device, min_lanes: int = 8, steps: int = 256,
                 max_steps: int = 2048, mesh=None):
        self.k = k
        self.device = torch.device(device)
        if isinstance(qmap, X.QMapSpan):
            from ..ops.span_device import span_width

            self.layout = "span"
            self.wk = span_width(k)
        else:
            self.layout = "bucket" if isinstance(qmap, X.QMapB) else "cuckoo"
            self.wk = 1
        self.log_size = qmap.log_nb if self.layout == "bucket" else qmap.log_size
        self.mesh = mesh if self.layout != "span" else None
        self.min_lanes = min_lanes
        if self.mesh is not None:
            from ..parallel import mesh as M

            assert len(mesh) & (len(mesh) - 1) == 0, "mesh size must be a power of two"
            self.mesh_tables = M.per_device(self.mesh, qmap.to)
            self.min_lanes = max(min_lanes, len(mesh))
        else:
            self.tables = qmap.to(self.device)
        self.steps = steps
        self.max_steps = max_steps
        self.n_device_calls = 0
        self.n_walked = 0

    def _call_device(self, nodes, budgets, steps: int):
        t = self.tables
        if self.layout == "span":
            return walk_batch_span(nodes, budgets, t.slots, t.sat, t.stash_key64, t.stash_sat,
                                   t.stash_payload, t.salt, self.log_size, self.k, steps)
        return walk_batch(nodes, budgets, t.slots, t.stash_keys, t.stash_payload,
                          self.log_size, self.k, steps, self.layout)

    def _rows(self, ints) -> np.ndarray:
        """Python-int nodes as u64 rows [n, Wk] (word 0 most significant)."""
        wk = self.wk
        rows = np.zeros((len(ints), wk), np.uint64)
        for i, v in enumerate(ints):
            v = int(v)
            for w in range(wk):
                rows[i, wk - 1 - w] = (v >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
        return rows

    def _int(self, row) -> int:
        v = 0
        for word in row:
            v = (v << 64) | int(word)
        return v

    def walk_many(self, requests):
        """requests: list of (node:int, budget:int). Returns a list of
        (bases: list[int], end_node: int, reason: str) in request order."""
        n = len(requests)
        if n == 0:
            return []
        nodes = self._rows([node for node, _ in requests])
        remaining = np.array([max(budget, 0) for _, budget in requests], np.int32)
        status = np.zeros(n, np.uint8)
        out_bases: list[list[int]] = [[] for _ in range(n)]
        steps = self.steps
        while True:
            idx = np.nonzero((status == STATUS_RUNNING) & (remaining > 0))[0]
            if idx.size == 0:
                break
            # only the live walks go to the device (at least min_lanes lanes;
            # on a mesh, as many a shard)
            lanes = max(self.min_lanes, idx.size)
            if self.mesh is not None:
                lanes = -(-lanes // len(self.mesh)) * len(self.mesh)
            lane_nodes = np.zeros((lanes, self.wk), np.uint64)
            lane_budgets = np.zeros(lanes, np.int32)
            lane_nodes[: idx.size] = nodes[idx]
            lane_budgets[: idx.size] = remaining[idx]
            if self.layout != "span":
                lane_nodes = lane_nodes[:, 0]
            if self.mesh is not None:
                from ..parallel import mesh as M

                bases, n_app, end_nodes, st = M.walk_shards(self.mesh, self.mesh_tables, K.as_i64(lane_nodes),
                                                            lane_budgets, self.log_size, self.k, steps, self.layout)
            else:
                bases, n_app, end_nodes, st = self._call_device(
                    torch.from_numpy(K.as_i64(lane_nodes)).to(self.device),
                    torch.from_numpy(lane_budgets).to(self.device),
                    steps,
                )
            bases = bases[: idx.size].cpu().numpy()
            n_app = n_app[: idx.size].cpu().numpy()
            self.n_device_calls += 1
            for row, i in enumerate(idx):
                if n_app[row]:
                    out_bases[i].extend(int(b) for b in bases[row, : n_app[row]])
            # words with the top bit set come back as negative int64
            nodes[idx] = K.as_u64(end_nodes).reshape(-1, self.wk)[: idx.size]
            remaining[idx] -= n_app
            status[idx] = st[: idx.size].cpu().numpy()
            self.n_walked += int(n_app.sum())
            steps = min(steps * 2, self.max_steps)

        results = []
        for i in range(n):
            st = int(status[i])
            reason = "tip" if st == STATUS_TIP else ("event" if st == STATUS_EVENT else "budget")
            results.append((out_bases[i], self._int(nodes[i]), reason))
        return results


def run_jobs_batched(gens, walker: BatchWalker):
    """Drive many traversal coroutines concurrently: collect every pending
    ("walk", node, budget) request, satisfy the whole batch on the device,
    feed the results back, repeat. Yields each coroutine's return value in
    input order, streaming finished prefixes as they complete."""
    n = len(gens)
    results = [None] * n
    done = [False] * n
    pending: dict[int, tuple] = {}

    def advance(i, value, first):
        try:
            req = next(gens[i]) if first else gens[i].send(value)
            pending[i] = req
        except StopIteration as e:
            results[i] = e.value
            done[i] = True

    for i in range(n):
        advance(i, None, True)
    next_emit = 0
    while next_emit < n and done[next_emit]:
        yield results[next_emit]
        results[next_emit] = None
        next_emit += 1
    while pending:
        idxs = sorted(pending)
        reqs = [pending.pop(i) for i in idxs]
        outs = walker.walk_many([(r[1], r[2]) for r in reqs])
        for i, out in zip(idxs, outs):
            advance(i, out, False)
        while next_emit < n and done[next_emit]:
            yield results[next_emit]
            results[next_emit] = None
            next_emit += 1
    while next_emit < n:
        yield results[next_emit]
        results[next_emit] = None
        next_emit += 1
