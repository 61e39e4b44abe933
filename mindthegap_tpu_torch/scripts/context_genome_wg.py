"""Filter likely-false-positive breakpoints by k-mer connectivity context —
equivalent of the reference's scripts/python3/Context_genome_WG.py
(README.txt: drop a breakpoint when more than `1 - threshold` of the 50
k-mers upstream of its left anchor have unusual connectivity, i.e. total
branching degree > 2), using this package's Graph API in place of pyGATB.

Usage: python -m mindthegap_tpu_torch.scripts.context_genome_wg -g find.h5 -p reference.fa
           -b find.breakpoints -o filtered.breakpoints [-m threshold(default .80)] [-device cuda|cpu]

The branching degree nb_in + nb_out of every position of every sequence is
a plane pass over the graph's solid set (no repeat set). On a CUDA device
(the default) it runs on the card, over windows of the sequence with a
halo of k - 1 bases: the pair map and the kernel K15 (find/scan_device.py
scan_planes_qp) at k <= 32, the span map and K16 (scan_planes_q_span) at
32 < k <= 256; above k = 256, and with `-device cpu`, the host plane pass
(find/scan.py compute_planes). Every route gives the same bytes.
"""

import getopt
import sys

import numpy as np

from ..device import resolve_device
from ..find import scan
from ..graph.dbg import Graph
from ..io.bank import Bank
from ..utils import dna

WINDOW = 50  # kmers inspected upstream of the breakpoint


def _split_device(argv):
    """(argv without the port's `-device NAME`, NAME or None)."""
    rest, device = [], None
    it = iter(argv)
    for arg in it:
        if arg in ("-device", "--device"):
            device = next(it, None)
            if device is None:
                raise getopt.GetoptError(f"option {arg} requires an argument")
        else:
            rest.append(arg)
    return rest, device


def device_degree_fn(graph, device, window: int | None = None):
    """`codes -> nb_in + nb_out` (int32, one a position) through the plane
    kernels on `device` (K15 over the pair map at k <= 32, K16 over the
    span map at 32 < k <= 256, both maps built with no repeat set), in the
    windows of the find scan (find/runner.py _window_feed, a halo of k - 1
    bases): `window` bases, by default 2^22 at k <= 32 and 2^21 above, as
    find's plane path takes them. On a CPU device the kernels' plain
    versions run."""
    import torch

    from ..find import scan_device as S
    from ..find.runner import _to_host, _upload, _window_feed
    from ..ops import extmap as X
    from ..ops.span import Span

    device = torch.device(device)
    k = graph.k
    if k <= 32:
        qm = X.build_fused_pair(graph.solid.kmers, k, np.zeros(0, np.uint64))
        t = qm.to(device)
        tables = (t.slots, t.stash_keys, t.stash_l, t.stash_r, qm.log_size, k)
        scan_fn, default = S.scan_planes_qp, 1 << 22
    else:
        rows = Span(k).from_keys(graph.solid.keys)
        qm = X.build_fused_span(rows, k, np.zeros((0, Span(k - 1).W), np.uint64))
        t = qm.to(device)
        tables = (t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qm.salt, qm.log_size, k)
        scan_fn, default = S.scan_planes_q_span, 1 << 21
    del qm

    def dispatch(part):
        packed, bad, _row = _upload(part, k, device)
        res = scan_fn(packed, bad, *tables)
        return _to_host({"deg": res["nb_in"] + res["nb_out"]}, device)

    def emit(pending, take, _last):
        host, done = pending
        if done is not None:
            done.synchronize()
        yield host["deg"].numpy()[:take]

    feed = _window_feed(k, window or default, dispatch, emit)

    def degrees(codes):
        parts = list(feed(codes))
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    return degrees


def main(argv):
    argv, device_name = _split_device(argv)
    opts, _args = getopt.getopt(
        argv, "g:p:b:o:m:", ["graph=", "genome_parser=", "bkpt_file=", "bkpt_outp=", "threshold="]
    )
    graph_path = genome = bkpt_file = out = None
    threshold = 0.80
    for opt, arg in opts:
        if opt in ("-g", "--graph"):
            graph_path = arg
        elif opt in ("-p", "--genome_parser"):
            genome = arg
        elif opt in ("-b", "--bkpt_file"):
            bkpt_file = arg
        elif opt in ("-o", "--bkpt_outp"):
            out = arg
        elif opt in ("-m", "--threshold"):
            threshold = float(arg)
    if not (graph_path and genome and bkpt_file and out):
        print(__doc__)
        return 2
    device = resolve_device(device_name)

    graph = Graph.load(graph_path)
    k = graph.k
    if device.type == "cuda" and k <= 256:
        degree_fn = device_degree_fn(graph, device)
    else:
        empty_rep = np.zeros(0, np.uint64)

        def degree_fn(codes):
            planes = scan.compute_planes(codes, k, graph.solid.kmers, empty_rep)
            return planes.nb_in + planes.nb_out

    # per-chromosome branching degrees
    degs = {}
    for rec in Bank.open(genome):
        degs[rec.comment_short] = degree_fn(dna.seq_to_codes(rec.seq))

    kept = dropped = 0
    with open(bkpt_file) as fi, open(out, "w") as fo:
        records = fi.read().splitlines()
        for i in range(0, len(records) - 3, 4):
            header_l, seq_l, header_r, seq_r = records[i : i + 4]
            # header: >bkptN_<chrom>_pos_<pos>_...
            tokens = header_l[1:].split("_")
            chrom, pos = tokens[1], int(tokens[3])
            deg = degs.get(chrom)
            ok = True
            if deg is not None:
                lo = max(0, pos - WINDOW)
                window = deg[lo:pos]
                if window.size:
                    unusual = int((window > 2).sum())
                    ok = (1.0 - unusual / window.size) >= threshold
            if ok:
                fo.write("%s\n%s\n%s\n%s\n" % (header_l, seq_l, header_r, seq_r))
                kept += 1
            else:
                dropped += 1
    print(f"kept {kept} breakpoints, filtered {dropped}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
