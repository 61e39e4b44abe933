"""find_graph.scan_replay_s: seconds a job spends in the reference scan and
the automaton's replay (the -profile phase "scan+replay (fused)")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "scan+replay (fused)")
