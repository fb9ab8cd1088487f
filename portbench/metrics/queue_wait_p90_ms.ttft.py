"""queue_wait_p90_ms.ttft: the 90th percentile, over every request due
in the window, of the time from its due time to the start of the
``step()`` in which its prefill began (host clock; a request that never
began counts as a miss)."""

from portbench.layer_metrics import p90


def read(r):
    return p90(r["queue_waits_ms"]) if r else None
