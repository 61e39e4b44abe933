"""find_graph.graph_prep_s: seconds a job spends loading the graph and
building the reference repeat set (-profile phases "graph load" and
"reference repeat set")."""

from mtgbench.readers import phase_mean


def read(run):
    return phase_mean(run, "graph load", "reference repeat set")
