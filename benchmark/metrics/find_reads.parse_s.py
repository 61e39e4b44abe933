"""find_reads.parse_s: seconds a job spends parsing the read files into
base codes (the -profile span "graph build / parse", the native parser)."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "graph build / parse")
