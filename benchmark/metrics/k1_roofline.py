"""k1_roofline: K1's share of its roofline over the traced window
(roofline/k1.py)."""

from mtgbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1")
