"""Local assembly: bounded breadth-first contig construction in the DBG.

Re-creates the behavior of GATB-core's BranchingTerminator +
IterativeExtensions<span>(..., TRAVERSAL_CONTIG, until_max_depth, Breadth,
false, max_depth, max_nodes).construct_linear_seqs(L, R, file, swf) as used
by the reference (src/Filler.cpp:866-884). The GATB submodule is absent
upstream, so the exact semantics were reconstructed and *calibrated* against
the committed per-job oracles (nb-nodes / total-nt / nb-target-nodes rows in
test/full_test/gold_bed.info.txt and test/contig_test/gold.info.txt).

Shape of the algorithm:
- a queue of (kmer, depth) seeds, starting at the last k-mer of L;
- each seed is extended to the right into a contig: follow simple paths,
  crossing error tips / clean bubbles Monument-style (frontline BFS with an
  external-in-branching check, depth/breadth caps, near-identical consensus
  validation), stopping at real divergences;
- a terminator marks branching nodes already consumed so parallel arms do
  not re-traverse shared sequence;
- each contig is emitted as a node; the graph successors of its end k-mer
  are queued with accumulated depth;
- stop conditions: max_nodes contigs and max_depth accumulated length.

TraversalPolicy collects every micro-decision that is only observable
through the oracles; defaults are the calibrated values.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ..ops import kmers as K
from ..ops.nw import nw_identity
from ..ops.span import canonical_int


@dataclass
class TraversalPolicy:
    trace_fn: object = None            # optional callback(event:str, **kw) for calibration
    in_branch_stop: bool = True        # stop when the unique successor has in-degree > 1
    explore_branching: bool = True     # Monument-style bubble/tip crossing
    bubble_max_depth: int = 500
    bubble_max_breadth: int = 20
    consensus_identity: int = 90       # pairwise NW identity (percent) for bubble validation
    start_mark: bool = True            # mark a branching start node when traversed
    passed_branch_mark: bool = True    # mark branching nodes stepped onto mid-path
    branch_stop_mark: bool = False     # mark the branching node an extension stopped at
    skip_marked_start: str = "kmer"      # "skip" | "kmer" (emit bare kmer) | "no"
    stop_at_marked: bool = True        # stop extension when the next node is marked
    explore_marked_fail: bool = False  # bubble/tip crossing fails on marked frontier nodes
    merge_reverse_check: bool = False  # cross a pure merge only if a REVERSE
    # frontline from the merge node collapses (or dies) within the bubble
    # caps — i.e. the external in-arm is a local bubble/tip, not a genuinely
    # different long path (GATB MonumentTraversal in-branching validation)
    swf_mode: str = "none"             # "none" | "r_in_seq" | "seq_in_r" | "anchor_in_seq"
    swf_noextend: bool = False         # swf hit suppresses pushes instead of breaking
    push_on_marked_stop: bool = True   # push the marked stop-node as a new seed
    marked_start_push: bool = False     # bare marked-start pops push their successors
    lifo: bool = False                 # queue discipline (False = FIFO)
    depth_with_kmer: bool = True       # depth += len(contig) (else len(contig) - k)
    max_nodes_strict: bool = False     # break when nbNodes >= max_nodes (else >)
    # --- GATB BranchingTerminator edge-bitmask model (VERDICT r3 item 6):
    # marks live per BRANCHING node as an 8-bit edge mask (bits 0-3 out by
    # nt, 4-7 in by predecessor top base, canonical orientation); node-level
    # marks of non-branching nodes delegate to edges touching branching
    # neighbors. Off by default (the calibrated node-mark model).
    edge_marks: bool = False
    step_mark_kind: str = "edge"       # passed_branch_mark marks: "edge" | "node"
    stop_check_kind: str = "edge"      # stop_at_marked checks: "edge" | "node"
    pop_check_kind: str = "edge"       # marked-start pop checks: "edge" | "node"
    bubble_mark_kind: str = "paths"    # explore marking: "paths" (edges of
    # enumerated bubble paths) | "nodes" (delegated node-mark of involved)


_M64 = (1 << 64) - 1
_H1I = 0x9E3779B97F4A7C15
_H2I = 0xC2B2AE3D27D4EB4F


def _shuffle02_int(v: int) -> int:
    """Permute 4-bit bitmap positions b -> b^2 (complement is code^2)."""
    return ((v & 0b0011) << 2) | ((v >> 2) & 0b0011)


class GraphView:
    """Forward-kmer graph interface for the traversal's point queries.

    Backed by the fused quotient map (ops/extmap.py QMap) over canonical
    (k-1)-mers: ONE scalar table probe yields the full successor set (ext
    bits) or predecessor set (pre bits) of a node — exact, and sharing the
    structure the device walker (fill/walk_device.py) gathers from. For
    k > 32 spans, falls back to binary-search point queries on the sorted
    solid set (no python-set materialization at any k)."""

    def __init__(self, graph, qmap=None, layout: str = "cuckoo"):
        """layout: "cuckoo" (2-probe QMap, default) or "bucket" (single-probe
        QMapB — the device walker then issues one bucket gather per step)."""
        self.g = graph
        self.k = graph.k
        self._succ: dict[int, tuple] = {}
        self._pred: dict[int, tuple] = {}
        self.qm = None
        self.native = None  # NativeTraversal session (enable_native)
        if graph.k <= 32:
            from ..ops import extmap as X

            if qmap is None:
                if layout == "bucket":
                    qmap = X.build_fused_bucket(
                        graph.solid.keys, graph.k, np.zeros(0, np.uint64)
                    )
                else:
                    qmap = X.build_fused(
                        graph.solid.keys, graph.k, np.zeros(0, np.uint64)
                    )
            self.qm = qmap
            self._is_bucket = isinstance(qmap, X.QMapB)
            self._slots = self.qm.slots
            self._log_size = self.qm.log_nb if self._is_bucket else self.qm.log_size
            self._stash = {
                int(sk): int(sv)
                for sk, sv in zip(self.qm.stash_keys, self.qm.stash_payload)
                if sk != np.uint64(0xFFFFFFFFFFFFFFFF)
            }

    def enable_native(self, policy: "TraversalPolicy") -> bool:
        """Attach the native C++ traversal engine (native/traversal.cpp) so
        construct_linear_seqs_co short-circuits to it. k <= 32 probes the
        cuckoo QMap; 32 < k <= 256 binary-searches the sorted solid key
        blob (SpanGraph backend). Returns success."""
        from . import traversal_native as TN

        if not TN.available():
            return False
        try:
            if self.qm is not None and not getattr(self, "_is_bucket", False):
                self.native = TN.NativeTraversal(self.qm, self.k, policy)
            elif self.k > 32 and getattr(self.g.solid, "span", None) is not None:
                self.native = TN.NativeTraversalSpan(self.g.solid.keys, self.k, policy)
            else:
                return False
        except Exception:
            self.native = None
            return False
        return True

    # -- scalar fused-map probe (python ints; exact) -----------------------
    def _payload_int(self, key: int) -> int:
        shift = 64 - self._log_size
        rem_mask = (1 << shift) - 1
        if self._is_bucket:
            h = ((key ^ (key >> 33)) * _H1I) & _M64
            h ^= h >> 29
            rem = h & rem_mask
            base = (h >> shift) * 16
            for s in range(16):
                v = int(self._slots[base + s])
                if (v & 512) and (v >> 10) == rem:
                    return v & 0x1FF
            return self._stash.get(key, 0)
        for i, const in enumerate((_H1I, _H2I)):
            h = ((key ^ (key >> 33)) * const) & _M64
            h ^= h >> 29
            v = int(self._slots[h >> shift])
            if (v & 1024) and (v >> 11) == (h & rem_mask) and bool(v & 512) == (i == 1):
                return v & 0x1FF
        return self._stash.get(key, 0)

    def _ext_bits(self, q: int) -> int:
        """Which bases x make q.x a solid k-mer ((k-1)-mer q as read)."""
        cq = canonical_int(q, self.k - 1)
        pay = self._payload_int(cq)
        return pay & 0xF if q == cq else _shuffle02_int((pay >> 4) & 0xF)

    def _pre_bits(self, q: int) -> int:
        """Which bases y make y.q a solid k-mer ((k-1)-mer q as read)."""
        cq = canonical_int(q, self.k - 1)
        pay = self._payload_int(cq)
        return (pay >> 4) & 0xF if q == cq else _shuffle02_int(pay & 0xF)

    def contains_fwd(self, fwd: int) -> bool:
        if self.qm is not None:
            return bool((self._ext_bits(fwd >> 2) >> (fwd & 3)) & 1)
        return self.g.solid.contains_int(canonical_int(fwd, self.k))

    def successors(self, fwd: int):
        r = self._succ.get(fwd)
        if r is None:
            mask = (1 << (2 * self.k)) - 1
            if self.qm is not None:
                ext = self._ext_bits(fwd & ((1 << (2 * (self.k - 1))) - 1))
                r = tuple(
                    (nt, ((fwd << 2) | nt) & mask) for nt in range(4) if (ext >> nt) & 1
                )
            else:
                r = tuple(
                    (nt, nxt)
                    for nt in range(4)
                    for nxt in [((fwd << 2) | nt) & mask]
                    if self.contains_fwd(nxt)
                )
            self._succ[fwd] = r
        return r

    def predecessors(self, fwd: int):
        r = self._pred.get(fwd)
        if r is None:
            shift = 2 * (self.k - 1)
            if self.qm is not None:
                pre = self._pre_bits(fwd >> 2)
                r = tuple(
                    (nt, (fwd >> 2) | (nt << shift)) for nt in range(4) if (pre >> nt) & 1
                )
            else:
                r = tuple(
                    (nt, prv)
                    for nt in range(4)
                    for prv in [(fwd >> 2) | (nt << shift)]
                    if self.contains_fwd(prv)
                )
            self._pred[fwd] = r
        return r

    def canonical(self, fwd: int) -> int:
        return canonical_int(fwd, self.k)

    def is_branching(self, fwd: int) -> bool:
        return len(self.successors(fwd)) != 1 or len(self.predecessors(fwd)) != 1


class Terminator:
    """BranchingTerminator stand-in: remembers marked (canonical) nodes."""

    def __init__(self, view: GraphView):
        self.view = view
        self.marked: set[int] = set()

    def reset(self):
        self.marked.clear()

    def mark(self, fwd: int):
        self.marked.add(self.view.canonical(fwd))

    def is_marked(self, fwd: int) -> bool:
        return self.view.canonical(fwd) in self.marked


class EdgeTerminator(Terminator):
    """GATB BranchingTerminator model (the reference delegates to it at
    src/Filler.cpp:866): an 8-bit edge bitmask per BRANCHING node — bits 0-3
    = out-edges keyed by appended nt, bits 4-7 = in-edges keyed by the
    predecessor's top base, both expressed in the node's canonical
    orientation. Only branching nodes hold state; edge/node marks touching
    non-branching nodes delegate to their branching endpoints/neighbors."""

    def __init__(self, view: GraphView):
        super().__init__(view)
        self.masks: dict[int, int] = {}  # canonical branching kmer -> mask

    def reset(self):
        super().reset()
        self.masks.clear()

    # -- orientation helpers ------------------------------------------------
    def _out_bit(self, u: int, nt: int) -> tuple[int, int]:
        """(canonical key, bit) of edge u --nt--> . as seen from u."""
        cu = self.view.canonical(u)
        return (cu, nt) if u == cu else (cu, 4 + (nt ^ 2))

    def _in_bit(self, v: int, top_base: int) -> tuple[int, int]:
        """(canonical key, bit) of edge . --> v arriving with predecessor
        top base `top_base`, as seen from v."""
        cv = self.view.canonical(v)
        return (cv, 4 + top_base) if v == cv else (cv, top_base ^ 2)

    # -- edge marks ---------------------------------------------------------
    def mark_edge(self, u: int, nt: int):
        """Mark edge u --nt--> v on every branching endpoint."""
        view = self.view
        k = view.k
        v = ((u << 2) | nt) & ((1 << (2 * k)) - 1)
        if view.is_branching(u):
            key, bit = self._out_bit(u, nt)
            self.masks[key] = self.masks.get(key, 0) | (1 << bit)
        if view.is_branching(v):
            key, bit = self._in_bit(v, (u >> (2 * (k - 1))) & 3)
            self.masks[key] = self.masks.get(key, 0) | (1 << bit)

    def is_marked_edge(self, u: int, nt: int) -> bool:
        view = self.view
        k = view.k
        v = ((u << 2) | nt) & ((1 << (2 * k)) - 1)
        if view.is_branching(u):
            key, bit = self._out_bit(u, nt)
            if (self.masks.get(key, 0) >> bit) & 1:
                return True
        if view.is_branching(v):
            key, bit = self._in_bit(v, (u >> (2 * (k - 1))) & 3)
            if (self.masks.get(key, 0) >> bit) & 1:
                return True
        return False

    # -- node marks (delegated) ---------------------------------------------
    def mark(self, fwd: int):
        """Node mark: a branching node gets all 8 bits; a non-branching node
        delegates to every edge shared with a branching neighbor."""
        view = self.view
        if view.is_branching(fwd):
            self.masks[view.canonical(fwd)] = 0xFF
            return
        k = view.k
        for nt, nb in view.successors(fwd):
            if view.is_branching(nb):
                key, bit = self._in_bit(nb, (fwd >> (2 * (k - 1))) & 3)
                self.masks[key] = self.masks.get(key, 0) | (1 << bit)
        for nt, pb in view.predecessors(fwd):
            if view.is_branching(pb):
                key, bit = self._out_bit(pb, fwd & 3)
                self.masks[key] = self.masks.get(key, 0) | (1 << bit)

    def is_marked(self, fwd: int) -> bool:
        view = self.view
        if view.is_branching(fwd):
            return self.masks.get(view.canonical(fwd), 0) != 0
        k = view.k
        for nt, nb in view.successors(fwd):
            if view.is_branching(nb):
                key, bit = self._in_bit(nb, (fwd >> (2 * (k - 1))) & 3)
                if (self.masks.get(key, 0) >> bit) & 1:
                    return True
        for nt, pb in view.predecessors(fwd):
            if view.is_branching(pb):
                key, bit = self._out_bit(pb, fwd & 3)
                if (self.masks.get(key, 0) >> bit) & 1:
                    return True
        return False


def _find_end_of_branching(view: GraphView, start: int, policy: TraversalPolicy,
                           term: "Terminator | None" = None):
    """Frontline BFS from a branching node until the frontline collapses to a
    single node. Fails on external in-branching (a new frontline node with a
    predecessor that was never frontlined — the GATB FrontlineBranching
    check), on dead frontlines, on depth/breadth caps, and (with
    policy.explore_marked_fail) on frontline nodes already marked by the
    terminator (GATB's marked-territory check).

    Returns (end_node, depth, involved) or None."""
    already = {view.canonical(start)}
    frontline = [nxt for _, nxt in view.successors(start)]
    for n in frontline:
        already.add(view.canonical(n))
    if policy.explore_marked_fail and term is not None:
        for n in frontline:
            if term.is_marked(n):
                return None
    involved = set(frontline)
    depth = 1
    while depth < policy.bubble_max_depth:
        if len(frontline) == 0:
            return None
        if len(frontline) == 1:
            return frontline[0], depth, involved
        if len(frontline) > policy.bubble_max_breadth:
            return None
        new_frontline: list[int] = []
        seen_new = set()
        for node in frontline:
            for _, nxt in view.successors(node):
                # external in-branching check
                for _, prd in view.predecessors(nxt):
                    if view.canonical(prd) not in already:
                        return None
                if policy.explore_marked_fail and term is not None and term.is_marked(nxt):
                    return None
                c = view.canonical(nxt)
                if c in already:
                    if c in seen_new and nxt not in new_frontline:
                        pass
                    continue
                already.add(c)
                seen_new.add(c)
                new_frontline.append(nxt)
        involved |= set(new_frontline)
        frontline = new_frontline
        depth += 1
    return None


def _reverse_collapse_ok(view: GraphView, node: int, policy: TraversalPolicy) -> bool:
    """Reverse frontline BFS from an in-branching node: True when the
    frontline collapses to <= 1 node (the in-arms share a recent ancestor) or
    dies entirely (error tips) within the bubble caps. This is the
    admissibility test for crossing a pure merge (merge_reverse_check)."""
    already = {view.canonical(node)}
    frontline = [p for _, p in view.predecessors(node)]
    for n in frontline:
        already.add(view.canonical(n))
    depth = 1
    while depth < policy.bubble_max_depth:
        if len(frontline) <= 1:
            return True
        if len(frontline) > policy.bubble_max_breadth:
            return False
        new_frontline: list[int] = []
        for n in frontline:
            for _, p in view.predecessors(n):
                c = view.canonical(p)
                if c in already:
                    continue
                already.add(c)
                new_frontline.append(p)
        frontline = new_frontline
        depth += 1
    return False


def _all_paths_between(view: GraphView, start: int, end: int, max_depth: int, max_breadth: int):
    """All nt-strings labelling paths start -> end of length <= max_depth."""
    out: list[str] = []
    stack = [(start, "")]
    while stack:
        node, s = stack.pop()
        if node == end and s:
            out.append(s)
            if len(out) > max_breadth:
                return None
            continue
        if len(s) >= max_depth:
            continue
        for nt, nxt in view.successors(node):
            stack.append((nxt, s + "ACTG"[nt]))
    return out


def _explore_branching(view: GraphView, term: Terminator, node: int, policy: TraversalPolicy):
    """Monument explore_branching: cross a tip/clean bubble, returning
    (consensus string, end node), or None."""
    res = _find_end_of_branching(view, node, policy, term)
    if res is None:
        return None
    end, depth, involved = res
    paths = _all_paths_between(view, node, end, depth + 1, policy.bubble_max_breadth)
    if not paths:
        return None
    if len(paths) > 1:
        for i in range(len(paths)):
            for j in range(i + 1, len(paths)):
                if nw_identity(paths[i], paths[j]) * 100 < policy.consensus_identity:
                    return None
    consensus = sorted(paths)[0]
    if getattr(policy, "edge_marks", False) and policy.bubble_mark_kind == "paths":
        # edge-bitmask model: mark every edge of every enumerated bubble path
        mask = (1 << (2 * view.k)) - 1
        for s in paths:
            cur = node
            for ch in s:
                nt = "ACTG".index(ch)
                term.mark_edge(cur, nt)
                cur = ((cur << 2) | nt) & mask
    else:
        for n in involved:
            if view.is_branching(n):
                term.mark(n)
    return consensus, end


def host_walk(view: GraphView, node: int, budget: int):
    """The scalar walk engine: extend a pure simple path from `node` for at
    most `budget` bases. Stops BEFORE anything the traversal automaton has an
    opinion about — a tip, a fork, an in-branching successor, or a branching
    next node — and hands control back. The device engine
    (fill/walk_device.py walk_batch) implements exactly this contract
    batched over jobs; both drive the same coroutine (traverse_right_co).

    Returns (bases: list[int], end_node, reason) with reason in
    {"tip", "event", "budget"}."""
    bases: list[int] = []
    while len(bases) < budget:
        succs = view.successors(node)
        if len(succs) == 0:
            return bases, node, "tip"
        if len(succs) > 1:
            return bases, node, "event"
        nt, nxt = succs[0]
        # predecessors(nxt) != 1 covers both the in_branch_stop fork check
        # (>1) and the in-degree-0 half of is_branching(nxt) — a successor
        # with no recorded predecessors (possible when the seed k-mer itself
        # is not solid, e.g. user-provided -contig seeds) must be handed back
        # so the automaton can mark it; successors(nxt) != 1 is the other
        # half of is_branching.
        if len(view.predecessors(nxt)) != 1:
            return bases, node, "event"
        if len(view.successors(nxt)) != 1:
            return bases, node, "event"
        bases.append(nt)
        node = nxt
    return bases, node, "budget"


def traverse_right_co(view: GraphView, term: Terminator, start: int, policy: TraversalPolicy, maxlen: int):
    """Coroutine form of the right-extension loop: yields ("walk", node,
    budget) requests for the uninterrupted simple-path stretches (satisfied
    by host_walk or the batched device walker) and replays the reference's
    per-branching-event logic on the sparse events in between.

    Returns (sequence, end_kmer, stop_reason) with stop_reason in
    {"tip", "fork", "merge", "marked", "maxlen"}."""
    seq = [K.kmer_to_str(start, view.k)]
    slen = view.k
    node = start
    reason = "maxlen"
    while slen < maxlen:
        bases, node, wreason = yield ("walk", node, maxlen - slen)
        if bases:
            seq.append("".join("ACTG"[b] for b in bases))
            slen += len(bases)
        if wreason == "budget":
            break  # slen reached maxlen; reason stays "maxlen"
        if wreason == "tip":
            reason = "tip"
            break
        # wreason == "event": replay ONE iteration of the reference loop body
        succs = view.successors(node)
        if len(succs) == 0:  # unreachable (tips stop the walker) — kept for safety
            reason = "tip"
            break
        if len(succs) > 1 or (
            policy.in_branch_stop and len(view.predecessors(succs[0][1])) > 1
        ):
            crossed = None
            merge_only = len(succs) == 1
            admissible = True
            if merge_only and policy.merge_reverse_check:
                admissible = _reverse_collapse_ok(view, succs[0][1], policy)
            if policy.explore_branching and admissible:
                crossed = _explore_branching(view, term, node, policy)
            if policy.trace_fn:
                policy.trace_fn("branch", offset=slen, node=node,
                                kind="fork" if len(succs) > 1 else "merge",
                                crossed=None if crossed is None else len(crossed[0]))
            if crossed is None:
                reason = "fork" if len(succs) > 1 else "merge"
                if policy.branch_stop_mark and len(succs) > 1:
                    term.mark(node)
                break
            seq.append(crossed[0])
            slen += len(crossed[0])
            node = crossed[1]
            continue
        nt, nxt = succs[0]
        if view.is_branching(nxt):
            edge_mode = getattr(policy, "edge_marks", False)
            stop_hit = (
                term.is_marked_edge(node, nt)
                if edge_mode and policy.stop_check_kind == "edge"
                else term.is_marked(nxt)
            )
            if policy.trace_fn:
                policy.trace_fn("step_branching", offset=slen, node=nxt, marked=stop_hit)
            if policy.stop_at_marked and stop_hit:
                reason = "marked"
                break
            if policy.passed_branch_mark:
                if edge_mode and policy.step_mark_kind == "edge":
                    term.mark_edge(node, nt)
                else:
                    term.mark(nxt)
        seq.append("ACTG"[nt])
        slen += 1
        node = nxt
    return "".join(seq), node, reason


def drive(gen, walk_fn):
    """Run a traversal coroutine to completion against a walk engine."""
    try:
        req = next(gen)
        while True:
            req = gen.send(walk_fn(req[1], req[2]))
    except StopIteration as e:
        return e.value


def traverse_right(view: GraphView, term: Terminator, start: int, policy: TraversalPolicy, maxlen: int):
    """Extend a contig to the right from `start` (host walk engine).

    Returns (sequence, end_kmer, stop_reason) with stop_reason in
    {"tip", "fork", "merge", "marked", "maxlen"}."""
    return drive(
        traverse_right_co(view, term, start, policy, maxlen),
        lambda node, budget: host_walk(view, node, budget),
    )


def construct_linear_seqs_co(
    graph,
    L: str,
    R: str,
    max_depth: int,
    max_nodes: int,
    swf: bool,
    policy: TraversalPolicy | None = None,
    view: GraphView | None = None,
):
    """Coroutine form of construct_linear_seqs: yields walk requests (via
    traverse_right_co) so many jobs can share one batched device walker.

    Returns the ordered list of contig strings (node id = list index)."""
    policy = policy or TraversalPolicy()
    view = view or GraphView(graph)
    edge_mode = getattr(policy, "edge_marks", False)
    term = EdgeTerminator(view) if edge_mode else Terminator(view)
    k = view.k

    start = K.str_to_kmer(L[len(L) - k :].upper())

    # native short-circuit: the whole job runs in C++ (bit-exact port of the
    # loop below; gated by the python-vs-native differential tests)
    if view.native is not None and policy.trace_fn is None and not edge_mode:
        try:
            view.native.set_policy(policy)
        except KeyError:
            pass  # non-ABI policy enum value: fall through to python
        else:
            return view.native.construct_linear_seqs(start, R or "", max_depth, max_nodes, swf)
    queue = deque([(start, 0)])
    contigs: list[str] = []

    def swf_hit(seq: str) -> bool:
        if not swf or not R:
            return False
        if policy.swf_mode == "r_in_seq":
            return R in seq
        if policy.swf_mode == "seq_in_r":
            return seq in R
        if policy.swf_mode == "anchor_in_seq":
            return any(R[i : i + k] in seq for i in range(0, len(R) - k + 1, k))
        return False

    while queue:
        popped = queue.pop() if policy.lifo else queue.popleft()
        cur, depth = popped[0], popped[1]
        in_edge = popped[2] if len(popped) > 2 else None
        if edge_mode and policy.pop_check_kind == "edge":
            pop_marked = in_edge is not None and term.is_marked_edge(*in_edge)
        else:
            pop_marked = term.is_marked(cur)
        if contigs and pop_marked:
            if policy.skip_marked_start == "skip":
                continue
            if policy.skip_marked_start == "kmer":
                seq = K.kmer_to_str(cur, k)
                contigs.append(seq)
                if swf_hit(seq) and not policy.swf_noextend:
                    break
                if policy.marked_start_push:
                    for nt, nxt in view.successors(cur):
                        queue.append((nxt, depth + len(seq), (cur, nt)))
                continue
        if policy.start_mark and view.is_branching(cur):
            term.mark(cur)
        seq, last, reason = yield from traverse_right_co(view, term, cur, policy, max_depth)
        contigs.append(seq)
        hit = swf_hit(seq)
        if hit and not policy.swf_noextend:
            break
        new_depth = depth + (len(seq) if policy.depth_with_kmer else len(seq) - k)
        if policy.max_nodes_strict:
            if len(contigs) >= max_nodes:
                break
        elif len(contigs) > max_nodes:
            break
        if new_depth > max_depth:
            continue
        if hit and policy.swf_noextend:
            continue
        if reason == "marked" and not policy.push_on_marked_stop:
            continue
        for nt, nxt in view.successors(last):
            queue.append((nxt, new_depth, (last, nt)))
    return contigs


def construct_linear_seqs(
    graph,
    L: str,
    R: str,
    max_depth: int,
    max_nodes: int,
    swf: bool,
    policy: TraversalPolicy | None = None,
    view: GraphView | None = None,
):
    """The IterativeExtensions::construct_linear_seqs equivalent (host walk
    engine; reference src/Filler.cpp:866-884).

    Returns the ordered list of contig strings (node id = list index)."""
    view = view or GraphView(graph)
    return drive(
        construct_linear_seqs_co(graph, L, R, max_depth, max_nodes, swf, policy, view),
        lambda node, budget: host_walk(view, node, budget),
    )
