"""Device-batched fill walker: simple-path extension over many jobs at once
(the counterpart of mindthegap_tpu/fill/walk_device.py, k <= 32).

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
walk_batch runs the hand kernel K5 (csrc/walk.cu: a team of threads per
lane, probing several steps ahead per DRAM round trip) on CUDA tensors and
its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import NotYetPorted
from ..device import check_kernel_tensor
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
# The thresholds are measured (python -m mindthegap_tpu_torch.kernel_bench
# on an H100, 2,048 steps, 1 to 65,536 lanes): D = 3 is the fastest up to
# _MAX_LANES[layout][3] lanes, D = 2 up to _MAX_LANES[layout][2], D = 1
# beyond. Lanes count as walks: a lane with a budget of 0 probes nothing,
# and BatchWalker sends only the walks still live.
DEPTHS = (1, 2, 3)  # the depths csrc/walk.cu is built for
_MAX_LANES = {"cuckoo": {3: 1024, 2: 6144}, "bucket": {3: 1536, 2: 10240}}


def lookahead_depth(lanes: int, layout: str) -> int:
    """K5's look-ahead depth D for `lanes` live walks in `layout` (see above)."""
    return next((d for d in (3, 2) if lanes <= _MAX_LANES[layout][d]), 1)


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
    err = _walk_lib().walk_launch(
        nodes.data_ptr(), budgets.data_ptr(), slots.data_ptr(), log_size, int(bucket),
        stash_k.data_ptr(), stash_v.data_ptr(), n_stash, k, steps, lanes, depth,
        bases.data_ptr(), n_app.data_ptr(), end_nodes.data_ptr(), status.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
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


class BatchWalker:
    """Host driver: satisfies batches of ("walk", node, budget) requests
    with walk_batch, re-invoking in `steps`-sized chunks until every lane
    has stopped. Each call takes only the walks still live, one lane each
    (at least `min_lanes`, the rest with a budget of 0), so that K5's
    look-ahead depth follows the live walks; the step count starts at 256
    and doubles to 2048, as in the JAX walker."""

    def __init__(self, qmap, k: int, device, min_lanes: int = 8, steps: int = 256,
                 max_steps: int = 2048, mesh=None):
        if mesh is not None:
            raise NotYetPorted("the walker's device mesh")
        if not isinstance(qmap, (X.QMap, X.QMapB)):
            raise NotYetPorted("the span walker (-fill-engine device with -kmer-size above 32)")
        self.k = k
        self.device = torch.device(device)
        self.layout = "bucket" if isinstance(qmap, X.QMapB) else "cuckoo"
        self.log_size = qmap.log_nb if self.layout == "bucket" else qmap.log_size
        self.tables = qmap.to(self.device)
        self.min_lanes = min_lanes
        self.steps = steps
        self.max_steps = max_steps
        self.n_device_calls = 0
        self.n_walked = 0

    def _call_device(self, nodes, budgets, steps: int):
        t = self.tables
        return walk_batch(nodes, budgets, t.slots, t.stash_keys, t.stash_payload,
                          self.log_size, self.k, steps, self.layout)

    def walk_many(self, requests):
        """requests: list of (node:int, budget:int). Returns a list of
        (bases: list[int], end_node: int, reason: str) in request order."""
        n = len(requests)
        if n == 0:
            return []
        nodes = np.array([node for node, _ in requests], np.uint64)
        remaining = np.array([max(budget, 0) for _, budget in requests], np.int32)
        status = np.zeros(n, np.uint8)
        out_bases: list[list[int]] = [[] for _ in range(n)]
        steps = self.steps
        while True:
            idx = np.nonzero((status == STATUS_RUNNING) & (remaining > 0))[0]
            if idx.size == 0:
                break
            # only the live walks go to the device (at least min_lanes lanes)
            lanes = max(self.min_lanes, idx.size)
            lane_nodes = np.zeros(lanes, np.uint64)
            lane_budgets = np.zeros(lanes, np.int32)
            lane_nodes[: idx.size] = nodes[idx]
            lane_budgets[: idx.size] = remaining[idx]
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
            nodes[idx] = K.as_u64(end_nodes)[: idx.size]  # k = 32 nodes may have the top bit set
            remaining[idx] -= n_app
            status[idx] = st[: idx.size].cpu().numpy()
            self.n_walked += int(n_app.sum())
            steps = min(steps * 2, self.max_steps)

        results = []
        for i in range(n):
            st = int(status[i])
            reason = "tip" if st == STATUS_TIP else ("event" if st == STATUS_EVENT else "budget")
            results.append((out_bases[i], int(nodes[i]), reason))
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
