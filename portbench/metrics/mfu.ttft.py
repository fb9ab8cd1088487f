"""mfu.ttft: the model's operations in the traced sub-window (counted by
``portbench/counts.py`` from the lengths the harness handed in) over
the sub-window's wall time, as a share of the card's bf16 peak."""

from portbench.layer_metrics import mfu


def read(r):
    return mfu(r)
