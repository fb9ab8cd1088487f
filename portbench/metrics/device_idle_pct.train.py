"""device_idle_pct.train: the share of the traced sub-window in which no
operation ran on the device (the union of the trace's device
intervals against the sub-window's length)."""

from portbench.layer_metrics import idle_pct


def read(r):
    return idle_pct(r)
