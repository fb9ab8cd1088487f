"""Chrome-trace step-span tracer (the port of ``repro.obs.trace``).

Emits the Trace Event Format that ``chrome://tracing`` and Perfetto
load: complete-duration events (``"ph": "X"``), instants (``"i"``) and
counter samples (``"C"``) with microsecond timestamps, written one event
per line so the file doubles as line-oriented JSONL while staying a
single valid JSON array (opened on construction, closed by
:meth:`StepTracer.close`).

Events are held in memory as tuples on the ``time.perf_counter_ns``
clock: recording a span costs two clock reads and a list append.  A
tracer with a path writes what it holds every :data:`FLUSH_EVERY` events
and at :meth:`StepTracer.close`, so a run that stops early leaves the
events written so far; a tracer made with no path writes nothing and
keeps every event, so it belongs to a bounded run.
:meth:`StepTracer.spans` hands the held complete spans back in
``time.perf_counter`` seconds, the clock a caller can tie to a device
trace.

The engines' side of the contract: a CUDA launch returns before the
work finishes, so a span around a kernel call times only the host's
launch unless the engine fences with ``torch.cuda.synchronize``.  That
is ``Obs.fence``'s choice, apart from the tracer: by default an engine
fences exactly when a tracer is attached; ``Obs(fence=False)`` records
spans of the launches alone, with no fence.  With tracing off every span
is the shared :data:`NULL_SPAN` (``tests/test_torch_obs.py``'s zero-sync
guard).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple

#: events a tracer with a path holds before it writes them to its file
FLUSH_EVERY = 4096


class Span(NamedTuple):
    """One recorded complete span, its ends in ``time.perf_counter``
    seconds."""
    name: str
    start: float
    end: float
    args: dict | None
    cat: str


class _Span:
    """Context manager recording one complete ('X') event on exit.

    Reused per-call (not pooled): creation is two attribute stores.
    """

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "StepTracer", name: str, cat: str, args):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.tracer._add(("X", self.name, self.cat, self.t0,
                          time.perf_counter_ns(), self.args))
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
    """Records Chrome-trace events and writes them to ``path`` (``path``
    None: memory only).

    Nested :meth:`span` calls produce properly-nested intervals (inner
    spans close — and therefore appear in the file — before their
    enclosing span; viewers nest by interval containment, not file
    order).  The file's timestamps are microseconds from a per-tracer
    epoch on the monotonic ``perf_counter`` clock.  A tracer with a
    path writes its held events every :data:`FLUSH_EVERY` events and at
    :meth:`close`, and holds none it has written.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = None if path is None else os.fspath(path)
        self._f = None
        self._first = True
        if self.path is not None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "w")
            self._f.write("[\n")
            self._f.flush()
        self._flush_at = FLUSH_EVERY if self._f is not None else sys.maxsize
        # (ph, name, cat, t0_ns, t1_ns, args), in emission order
        self._events: list[tuple] = []
        self.pid = os.getpid()
        self.epoch_ns = time.perf_counter_ns()

    def _add(self, rec: tuple) -> None:
        self._events.append(rec)
        if len(self._events) >= self._flush_at:
            self._write()

    def span(self, name: str, cat: str = "serve", args=None) -> _Span:
        """``with tracer.span("plan"): ...`` — one 'X' event on exit."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "serve", args=None) -> None:
        """Zero-duration marker ('i' event, thread scope)."""
        t = time.perf_counter_ns()
        self._add(("i", name, cat, t, t, args))

    def counter(self, name: str, values: dict) -> None:
        """Counter-track sample ('C' event): ``values`` maps series name
        to number; Perfetto renders one stacked track per name."""
        t = time.perf_counter_ns()
        self._add(("C", name, None, t, t, dict(values)))

    def spans(self) -> list[Span]:
        """The complete ('X') spans held, in the order they closed, their
        ends in ``time.perf_counter`` seconds: every one recorded for a
        tracer with no path; a tracer with a path holds those it has not
        written yet."""
        return [Span(n, a * 1e-9, b * 1e-9, args, c)
                for ph, n, c, a, b, args in self._events if ph == "X"]

    def _chrome(self, rec: tuple) -> dict:
        ph, name, cat, t0, t1, args = rec
        ts = (t0 - self.epoch_ns) / 1000.0
        base = {"pid": self.pid, "tid": 0}
        if ph == "C":
            return {"name": name, "ph": "C", "ts": ts, **base, "args": args}
        if ph == "X":
            ev = {"name": name, "ph": "X", "cat": cat, "ts": ts,
                  "dur": (t1 - t0) / 1000.0, **base}
        else:
            ev = {"name": name, "ph": "i", "s": "t", "cat": cat, "ts": ts,
                  **base}
        if args:
            ev["args"] = args
        return ev

    def _write(self) -> None:
        """Append the held events to the file, one per line, and drop
        them; a run that stops before :meth:`close` leaves every event
        written so far.  Past :meth:`close` events are dropped."""
        if self._f is None:
            self._events.clear()
            return
        if not self._events:
            return
        body = ",\n".join(json.dumps(self._chrome(rec), separators=(",", ":"))
                          for rec in self._events)
        self._f.write(body if self._first else ",\n" + body)
        self._f.flush()
        self._first = False
        self._events.clear()

    def close(self) -> None:
        """Write what is held and close the JSON array and the file (a
        tracer with no path keeps its events).  Idempotent."""
        if self._f is None:
            return
        self._write()
        self._f.write("\n]\n")
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
