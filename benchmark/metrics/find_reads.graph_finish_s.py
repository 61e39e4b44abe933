"""find_reads.graph_finish_s: seconds a job spends finishing the graph on
the host after counting: the abundance cutoff and the solid filter, then
the branching count (the -profile spans "graph build / solid filter" and
"graph build / branching")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "graph build / solid filter", "graph build / branching")
