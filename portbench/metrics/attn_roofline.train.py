"""attn_roofline.train: the least time the traced sub-window's attention
needs (its operations at the bf16 peak or its bytes at the memory's
peak, whichever is longer) against the device time of the port's
attention kernels in the trace."""

from portbench.layer_metrics import attn_roofline


def read(r):
    return attn_roofline(r)
