"""find_reads.graph_build_s: seconds a job spends building the graph from
the reads: parsing, counting, the solid filter, the branching count and
the save (the -profile phase "graph build")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "graph build")
