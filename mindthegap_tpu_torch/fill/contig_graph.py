"""Contig graph construction and path enumeration.

Exact re-implementation of the reference's IGraphOutput / GraphAnalysis pair
(src/IGraphOutput.cpp + src/GraphAnalysis.cpp) without the DOT-file round
trip: nodes are the traversal contigs in emission order; a directed edge
A -> B exists iff A's last (k-1)-mer equals B's first (k-1)-mer as strings
(the "FF" label case — R* labelled edges are dropped by the reference parser,
GraphAnalysis.cpp:98-105; self-loops suppressed for (k-1)-length nodes,
IGraphOutput.cpp:161).
"""

from __future__ import annotations

from .types import FilledInsertion, InfoNode
from ..utils.dna import revcomp_inplace_style

MAX_BREADTH = 20  # GraphAnalysis.hpp:43
MAX_CALLS = 10000000  # GraphAnalysis.cpp:250

_FORWARD, _REVCOMP = 0, 1
_LEFT, _RIGHT = 0, 1


def to_dot(contigs: list[str], k: int) -> str:
    """Render the contig graph in the reference's DOT format
    (src/GraphOutputDot.cpp print_node/print_edge + src/IGraphOutput.cpp
    construct_graph/print_edges): `digraph dedebruijn {` header, per node
    its left (R*) then right (F*) labelled edges, then the node line
    `<id> [label="SEQ"];`. The reference writes this as the per-gap-fill
    temporary `.graph` file that GraphAnalysis parses back; here it is an
    inspection artifact (the pipeline stays in memory)."""
    from ..ops.span import canonical_int, revcomp_int
    from ..ops.kmers import str_to_kmer

    km1 = k - 1

    def code_seed(s: str):
        fwd = str_to_kmer(s)
        canon = canonical_int(fwd, km1)
        return canon, _FORWARD if fwd == canon else _REVCOMP

    # kmer_links: canonical (k-1)-extremity -> {(node, strand, left_or_right)}
    links: dict[int, set] = {}
    for i, s in enumerate(contigs):
        lk, ls = code_seed(s[:km1])
        rk, rs = code_seed(s[len(s) - km1 :])
        links.setdefault(lk, set()).add((i, ls, _LEFT))
        links.setdefault(rk, set()).add((i, rs, _RIGHT))

    table0 = {_LEFT: "R", _RIGHT: "F"}
    table1 = {_LEFT: "F", _RIGHT: "R"}
    out = ["digraph dedebruijn {"]

    def print_edges(canon, strand, seq_len, direction, node_id):
        # std::set<node_strand> order: (node, left_or_right, strand)
        for cur_node, cur_strand, cur_lr in sorted(
            links.get(canon, ()), key=lambda t: (t[0], t[2], t[1])
        ):
            if cur_node == node_id and seq_len == km1:
                continue
            label = table0[direction]
            if cur_lr == direction:
                if cur_strand != strand:
                    label += table1[direction]
                else:
                    continue
            else:
                if cur_strand == strand:
                    label += table0[direction]
                else:
                    continue
            out.append('%d -> %d [label="%s"];' % (node_id, cur_node, label))

    for i, s in enumerate(contigs):
        lk, ls = code_seed(s[:km1])
        rk, rs = code_seed(s[len(s) - km1 :])
        print_edges(lk, ls, len(s), _LEFT, i)
        print_edges(rk, rs, len(s), _RIGHT, i)
        out.append('%d [label="%s"];' % (i, s))
    out.append("}")
    return "\n".join(out) + "\n"


class ContigGraph:
    def __init__(self, contigs: list[str], k: int):
        self.k = k
        self.node_sequences = {i: s for i, s in enumerate(contigs)}
        self.nb_nodes = len(contigs)
        self.out_edges: dict[int, set[int]] = {}
        self.in_edges: dict[int, set[int]] = {}

        km1 = k - 1
        left_index: dict[str, list[int]] = {}
        for i, s in enumerate(contigs):
            left_index.setdefault(s[:km1], []).append(i)
        for a, s in enumerate(contigs):
            right = s[len(s) - km1 :]
            for b in left_index.get(right, []):
                if a == b and len(s) == km1:
                    continue  # self loop on same kmer suppressed
                self.out_edges.setdefault(a, set()).add(b)
                self.in_edges.setdefault(b, set()).add(a)

    # ------------------------------------------------------------------
    # DFS from each terminal node backwards to node 0
    # (find_all_paths_rev, GraphAnalysis.cpp:203-326)
    # ------------------------------------------------------------------
    def find_all_paths_rev(self, terminal_nodes: list[InfoNode]):
        all_paths: set[tuple[tuple[int, ...], tuple]] = set()
        for t in sorted(terminal_nodes, key=lambda x: (x.node_id, x.pos)):
            terminal_node = t.node_id
            target_id = t.target_id
            start_path = (terminal_node,)
            if terminal_node == 0:
                return {(start_path, target_id)}
            state = {"calls": 0, "success": True}
            paths = self._rev_dfs(terminal_node, terminal_nodes, start_path, state, terminal_node, target_id)
            all_paths |= paths
        return all_paths

    def _rev_dfs(self, start_node, terminal_nodes, current_path, state, terminal_node, target_id):
        paths: set = set()
        state["calls"] += 1
        if state["calls"] > MAX_CALLS:
            state["success"] = False
            return paths

        # a path containing another terminal node anywhere but its end is dropped
        if start_node != terminal_node:
            for t in terminal_nodes:
                if t.node_id == start_node:
                    return paths

        if start_node == 0:
            paths.add((current_path, target_id))
            return paths

        for next_node in sorted(self.in_edges.get(start_node, ())):
            if next_node not in current_path:
                extended = (next_node,) + current_path
                new_paths = self._rev_dfs(next_node, terminal_nodes, extended, state, terminal_node, target_id)
                paths |= new_paths
                if len(paths) >= MAX_BREADTH:
                    state["success"] = False
            if not state["success"]:
                return paths
        return paths

    # ------------------------------------------------------------------
    # paths -> inserted sequences (paths_to_sequences, GraphAnalysis.cpp:331-460)
    # ------------------------------------------------------------------
    def paths_to_sequences(self, paths: list[tuple[int, ...]], terminal_nodes: list[InfoNode]):
        k = self.k
        sequences: list[FilledInsertion] = []
        errs_in_anchor = 0
        target_id_anchor: tuple = ("", False)
        for p in sorted(paths):
            sequence = ""
            for idx, node in enumerate(p):
                rc = node > self.nb_nodes
                if rc:
                    node -= self.nb_nodes
                node_sequence = self.node_sequences[node]
                if rc:
                    node_sequence = revcomp_inplace_style(node_sequence)

                if idx == len(p) - 1:
                    pos_anchor = 0
                    for t in sorted(terminal_nodes, key=lambda x: (x.node_id, x.pos)):
                        if t.node_id == node:
                            pos_anchor = t.pos
                            errs_in_anchor = t.nb_errors
                            target_id_anchor = t.target_id
                            break
                    node_sequence = node_sequence[:pos_anchor]
                    if pos_anchor <= k - 1:
                        cut = len(sequence) - ((k - 1) - pos_anchor)
                        # C++ substr with huge (wrapped) count keeps the whole string
                        sequence = sequence[:cut] if cut >= 0 else sequence
                    else:
                        if idx != 0:
                            node_sequence = node_sequence[k - 1 :]
                        else:
                            node_sequence = node_sequence[k:]
                        sequence += node_sequence
                    break

                if idx != 0:
                    node_sequence = node_sequence[k - 1 :]
                else:
                    node_sequence = node_sequence[k:]
                sequence += node_sequence

            if len(sequence) > 0:
                sequences.append(FilledInsertion(sequence, errs_in_anchor, target_id_anchor))
        return sequences
