"""Chrome-trace step-span tracer (the port of ``repro.obs.trace``).

Emits the Trace Event Format that ``chrome://tracing`` and Perfetto
load: complete-duration events (``"ph": "X"``), instants (``"i"``) and
counter samples (``"C"``) with microsecond timestamps, written one event
per line so the file doubles as line-oriented JSONL while staying a
single valid JSON array (opened on construction, closed by
:meth:`StepTracer.close`).

The engines' side of the contract: a CUDA launch returns before the
work finishes, so a span around a kernel call times only the host's
launch unless the engine fences with ``torch.cuda.synchronize`` -- which
it does ONLY when a tracer is attached.  With tracing off every span is
the shared :data:`NULL_SPAN` and no fence runs
(``tests/test_torch_obs.py``'s zero-sync guard).
"""

from __future__ import annotations

import json
import os
import time


class _Span:
    """Context manager emitting one complete ('X') event on exit.

    Reused per-call (not pooled): creation is two attribute stores.
    """

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "StepTracer", name: str, cat: str, args):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        ev = {"name": self.name, "ph": "X", "cat": self.cat,
              "ts": (self.t0 - tr.epoch_ns) / 1000.0,
              "dur": (t1 - self.t0) / 1000.0,
              "pid": tr.pid, "tid": 0}
        if self.args:
            ev["args"] = self.args
        tr._emit(ev)
        return False


class _NullSpan:
    """Shared no-op span for the tracing-off path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def null_span(name: str, cat: str = "serve", args=None) -> _NullSpan:
    return NULL_SPAN


class StepTracer:
    """Writes Chrome-trace events to ``path``.

    Nested :meth:`span` calls produce properly-nested intervals (inner
    spans close — and therefore appear in the file — before their
    enclosing span; viewers nest by interval containment, not file
    order).  Timestamps are microseconds from a per-tracer epoch on a
    monotonic clock.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "w")
        self._f.write("[\n")
        self._first = True
        self.pid = os.getpid()
        self.epoch_ns = time.perf_counter_ns()

    def _emit(self, ev: dict) -> None:
        if self._f is None:
            return
        if self._first:
            self._first = False
        else:
            self._f.write(",\n")
        self._f.write(json.dumps(ev, separators=(",", ":")))

    def span(self, name: str, cat: str = "serve", args=None) -> _Span:
        """``with tracer.span("plan"): ...`` — one 'X' event on exit."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "serve", args=None) -> None:
        """Zero-duration marker ('i' event, thread scope)."""
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "ts": (time.perf_counter_ns() - self.epoch_ns) / 1000.0,
              "pid": self.pid, "tid": 0}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: dict) -> None:
        """Counter-track sample ('C' event): ``values`` maps series name
        to number; Perfetto renders one stacked track per name."""
        self._emit({"name": name, "ph": "C",
                    "ts": (time.perf_counter_ns() - self.epoch_ns) / 1000.0,
                    "pid": self.pid, "tid": 0, "args": dict(values)})

    def close(self) -> None:
        """Close the JSON array and the file.  Idempotent."""
        if self._f is None:
            return
        self._f.write("\n]\n")
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
