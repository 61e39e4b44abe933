"""find_graph.map_place_s: seconds a job spends placing the scan map's keys
in its tables (the -profile span "scan engine setup / map build / place":
the pair map's qpmap_build attempts, or the span map's cuckoo placement,
quotient encoding and satellite planes)."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "scan engine setup / map build / place")
