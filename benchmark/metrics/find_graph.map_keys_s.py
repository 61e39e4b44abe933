"""find_graph.map_keys_s: seconds a job spends making the span map's keys
(k > 32): the (k-1)-mer edge rows of both strands, their dedup by sort,
and their digests (the -profile span "scan engine setup / map build /
keys")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "scan engine setup / map build / keys")
