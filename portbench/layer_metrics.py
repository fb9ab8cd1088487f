"""Arithmetic shared by the per-layer readers in ``metrics/``.

A reader gets the readings of a traced run's sub-window (a dict: the
device's operations as (name, start, end) host seconds, ``window_s``,
``busy_s``, the operations and bytes of the work the sub-window held)
and returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import math

from portbench import counts, e2e

# the port's attention kernels, by the names the trace gives them:
# row 1 (paged decode, which runs chunked prefill spans), row 4 (the
# forward) and row 5 (the backward), bf16 instances and fp32 cores
ATTN_KERNELS = ("decode_mma_kernel", "fwd_mma_kernel", "dq_mma_kernel",
                "dkv_mma_kernel", "attn_rows_kernel", "dq_kernel<",
                "dkv_kernel<")


def idle_pct(r) -> float | None:
    if not r or r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])


def mfu(r) -> float | None:
    """The model's operations in the sub-window against the card's bf16
    peak over the sub-window's wall time."""
    if not r or r["model_flops"] <= 0:
        return None
    return 100.0 * r["model_flops"] / (r["window_s"]
                                       * counts.PEAKS["bf16_flops"])


def attn_roofline(r) -> float | None:
    """The least time the sub-window's attention needs against the
    device time of the port's attention kernels."""
    if not r:
        return None
    t = sum(b - a for name, a, b in r["events"]
            if any(k in name for k in ATTN_KERNELS))
    if t <= 0 or r["attn_flops"] <= 0:
        return None
    return 100.0 * counts.least_seconds(r["attn_flops"], r["attn_bytes"]) / t


def p90(values) -> float | None:
    if not values:
        return None
    v = e2e.percentile(values, 90)
    return v if math.isfinite(v) else None
