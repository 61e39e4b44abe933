"""find_graph.map_upload_s: seconds a job spends copying the scan map's
tables to the card (the -profile span "scan engine setup / upload", a
pageable copy)."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "scan engine setup / upload")
