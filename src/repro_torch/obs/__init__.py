"""Serving telemetry of the port: the metrics registry and the no-op
span (the tracer, DRAM ledger and profiler are later slices)."""

from repro_torch.obs.metrics import MetricsRegistry, format_metrics
from repro_torch.obs.trace import null_span

__all__ = ["MetricsRegistry", "format_metrics", "null_span"]
