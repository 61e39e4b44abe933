"""find_graph.map_host_build_s: seconds a job spends building the scan map
on the host, before its upload (the -profile span "scan engine setup /
map build": the native pair map at k <= 32, the numpy span map above)."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "scan engine setup / map build")
