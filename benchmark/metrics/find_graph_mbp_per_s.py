"""find_graph_mbp_per_s: reference Mbp through whole `find -graph` jobs a
second, host clock over the window."""

from mtgbench.readers import rate


def read(run):
    return rate(run, "ref_bp", 1e-6)
