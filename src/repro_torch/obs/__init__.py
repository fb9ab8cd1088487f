"""Observability of the port: metrics registry, Chrome-trace step spans,
modeled-vs-resolved DRAM accounting and the kernel profiler (the port of
``repro.obs``).

:class:`Obs` is the bundle the engines and the training loop take
(``PagedEngine(obs=...)``, ``DecodeEngine(obs=...)``,
``train(obs=...)``): a :class:`~repro_torch.obs.metrics.MetricsRegistry`
the engine, scheduler and page allocator report into; an optional
:class:`~repro_torch.obs.trace.StepTracer` writing Chrome-trace spans
(the engines fence with ``torch.cuda.synchronize`` ONLY when a tracer is
attached); and a :class:`~repro_torch.obs.dram.DramLedger` (or its
subclass :class:`~repro_torch.obs.profile.KernelProfiler`) comparing
the model's predicted DRAM bytes with what the schedule cache resolved,
per op key, while logging schedule-cache misses for ``python -m
repro_torch.tune --from-telemetry``.

An engine constructed without an ``obs`` builds a private ``Obs()``:
registry and ledger on (host-side integer arithmetic), tracer off.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs.dram import DramLedger, read_miss_log
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, format_metrics,
                                     hist_quantile)
from repro_torch.obs.profile import KernelProfiler, kernel_hbm_bytes
from repro_torch.obs.trace import NULL_SPAN, StepTracer, null_span

__all__ = [
    "Counter", "DramLedger", "Gauge", "Histogram", "KernelProfiler",
    "MetricsRegistry", "NULL_SPAN", "Obs", "StepTracer", "format_metrics",
    "hist_quantile", "kernel_hbm_bytes", "null_span", "read_miss_log",
]


class Obs:
    """One observability bundle per engine (or shared across engines).

    ``trace`` / ``miss_log`` accept paths for convenience; pass a
    constructed :class:`StepTracer` / :class:`DramLedger` /
    :class:`MetricsRegistry` to share instances.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 trace: StepTracer | str | os.PathLike | None = None,
                 dram: DramLedger | None = None,
                 miss_log: str | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        if trace is None or isinstance(trace, StepTracer):
            self.tracer = trace
        else:
            self.tracer = StepTracer(trace)
        self.dram = dram if dram is not None else DramLedger(
            registry=self.registry, miss_log=miss_log)

    def snapshot(self) -> dict:
        """Registry snapshot plus the DRAM ledger's report under
        ``"dram"`` -- JSON-safe plain data."""
        dram = self.dram.report()       # syncs the ledger's counters first
        snap = self.registry.snapshot()
        snap["dram"] = dram
        return snap

    def write_metrics(self, path: str | os.PathLike) -> None:
        d = os.path.dirname(os.fspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
            f.write("\n")

    def close(self) -> None:
        if self.tracer is not None:
            self.tracer.close()
        self.dram.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
