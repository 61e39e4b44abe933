"""find_reads.count_host_s: seconds the host spends in device counting:
packing and uploading each staging buffer, launching the sort and the
merge, waiting on the previous merge, and reading the counts back (the
-profile spans "graph build / flush" and "graph build / readback")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "graph build / flush", "graph build / readback")
