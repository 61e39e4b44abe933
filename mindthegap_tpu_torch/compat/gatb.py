"""pyGATB-compatible API shim.

The reference ecosystem's analysis scripts use pyGATB
(e.g. the reference's scripts/python3/Context_genome_WG.py:1 `from gatb
import Graph`; graph["ACGT..."] -> Node with .in_degree/.out_degree/
.reversed). This module exposes the same surface over this framework's
de Bruijn graph so those scripts run with only the import changed:

    from mindthegap_tpu_torch.compat.gatb import Graph

    graph = Graph("-in graph.h5")
    node = graph[kmer_string]
    node.in_degree, node.out_degree, node.reversed, bytes(node), str(node)
"""

from __future__ import annotations

import shlex

from ..graph import dbg
from ..ops import kmers as K
from ..ops.span import canonical_int, revcomp_int
from ..utils import dna


class Node:
    """A k-mer node (forward-oriented view, pyGATB Node surface)."""

    def __init__(self, graph: "Graph", fwd: int, k: int):
        self._g = graph
        self._fwd = fwd
        self.k = k

    @property
    def in_degree(self) -> int:
        return self._g._graph.indegree_int(self._fwd)

    @property
    def out_degree(self) -> int:
        return self._g._graph.outdegree_int(self._fwd)

    @property
    def reversed(self) -> "Node":
        return Node(self._g, revcomp_int(self._fwd, self.k), self.k)

    def __contains_graph__(self) -> bool:
        return self._g._graph.contains_canon_int(canonical_int(self._fwd, self.k))

    @property
    def abundance(self) -> int:
        return self._g._graph.query_abundance_int(canonical_int(self._fwd, self.k))

    def __eq__(self, other):
        # pyGATB nodes compare by canonical value (node.reversed == node)
        return isinstance(other, Node) and canonical_int(self._fwd, self.k) == canonical_int(
            other._fwd, other.k
        )

    def __hash__(self):
        return hash(canonical_int(self._fwd, self.k))

    def __str__(self) -> str:
        return dna.codes_to_seq(_int_to_codes(self._fwd, self.k))

    def __bytes__(self) -> bytes:
        return str(self).encode()

    def __repr__(self):
        return "Node(%s)" % str(self)


def _int_to_codes(v: int, k: int):
    import numpy as np

    out = np.empty(k, np.uint8)
    for i in range(k - 1, -1, -1):
        out[i] = v & 3
        v >>= 2
    return out


class Graph:
    """pyGATB-style Graph facade: ``Graph("-in graph.h5")``."""

    def __init__(self, options: str = "", **kw):
        args = shlex.split(options)
        path = kw.get("in_") or None
        for i, a in enumerate(args):
            if a == "-in" and i + 1 < len(args):
                path = args[i + 1]
        if path is None:
            raise ValueError("Graph: missing -in <graph file>")
        self._graph = dbg.Graph.load(path)
        self.kmer_size = self._graph.k

    def __getitem__(self, kmer: str) -> Node:
        if len(kmer) != self.kmer_size:
            raise ValueError(
                "kmer length %d != graph kmer size %d" % (len(kmer), self.kmer_size)
            )
        codes = dna.seq_to_codes(kmer)
        if (codes == dna.INVALID).any():
            raise ValueError("kmer contains non-ACGT characters")
        fwd = 0
        for c in codes:
            fwd = (fwd << 2) | int(c)
        return Node(self, fwd, self.kmer_size)

    def __contains__(self, kmer: str) -> bool:
        node = self[kmer]
        return node.__contains_graph__()
