"""find_reads_mbp_per_s: read Mbp through whole `find -in` jobs (the graph
built from the reads, then the scan) a second, host clock over the window."""

from mtgbench.readers import rate


def read(run):
    return rate(run, "read_bp", 1e-6)
