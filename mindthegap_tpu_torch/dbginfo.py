"""Graph artifact inspector (the reference ecosystem's dbginfo equivalent,
reference README.md:210-231): prints the info tree of a graph file produced
by `find`/`fill`.

Usage: python -m mindthegap_tpu_torch.dbginfo -in <graph.h5> [-export-h5 <out.h5>]

-export-h5 writes a REAL HDF5 container (h5dump/h5py inspectable; schema
documented in mindthegap_tpu_torch/graph/dbg.py save_hdf5) that Graph.load
— and therefore `-graph` on both tools — accepts interchangeably with the
native npz artifact.
"""

from __future__ import annotations

import sys


def main(argv: list[str]) -> int:
    path = None
    export = None
    args = list(argv)
    while args:
        a = args.pop(0)
        if a == "-in" and args:
            path = args.pop(0)
        elif a == "-export-h5" and args:
            export = args.pop(0)
        elif a in ("-h", "-help"):
            print(__doc__)
            return 0
        else:
            path = a
    if not path:
        print(__doc__)
        return 1

    import numpy as np

    from .graph.dbg import Graph
    from .utils.properties import Properties

    g = Graph.load(path)
    info = Properties()
    info.add(0, "graph")
    info.add(1, "file", path)
    info.add(1, "kmer-size", "%i", g.k)
    info.add(1, "kmers_nb_solid", "%i", len(g.solid))
    for key in ("thresholds", "abundance_max", "nb_branching", "cutoffs_auto.values"):
        if key in g.info:
            info.add(1, key, str(g.info[key]))
    if g.solid.counts is not None and len(g.solid):
        info.add(1, "abundance_mean", "%.2f", float(np.mean(g.solid.counts)))
        info.add(1, "abundance_max_seen", "%i", int(np.max(g.solid.counts)))
    sys.stdout.write(info.dump())
    if export:
        g.save_hdf5(export)
        print(f"exported HDF5 graph: {export}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
