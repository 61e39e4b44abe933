"""find_reads.graph_save_s: seconds a job spends writing the graph file
(the -profile span "graph build / save", a compressed npz)."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "graph build / save")
