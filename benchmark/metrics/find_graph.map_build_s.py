"""find_graph.map_build_s: seconds a job spends building and uploading the
scan map (the -profile phase "scan engine setup")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "scan engine setup")
