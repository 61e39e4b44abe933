"""device_idle_pct.find_graph: share of the traced window with no kernel, copy
or memset on the device."""

from mtgbench.readers import idle_pct


def read(run):
    return idle_pct(run)
