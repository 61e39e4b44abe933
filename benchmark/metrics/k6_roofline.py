"""k6_roofline: K6's share of its roofline over the traced window
(roofline/k6.py)."""

from mtgbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k6")
