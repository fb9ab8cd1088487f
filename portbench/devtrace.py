"""The device trace of a traced run's sub-window, reduced to what the
per-layer readers and the breakdown need.

Only the card's activity is traced (``torch.profiler`` with the CUDA
activity alone): the host's own operator events would cost more to
collect than the sub-window lasts.  The host side comes from the
harness's spans instead, taken on the host clock.  The two clocks are
tied by a marker kernel launched right after a synchronise at each end
of the sub-window, whose device start is taken as that host instant
(off by the launch latency, some microseconds).

The profiler is started before the measured loop and stopped after it:
the loop itself only places the two markers (a synchronise and a
launch each), and the profiler's start, its stop and the parse of its
trace all fall outside the window.  The markers then lie well inside
the profiled span; the profiler drops operations at the very edges of
its span, and a trace that lacks either marker is refused, not guessed
at.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER_CYCLES = 2000


class Spans:
    """The harness's host spans: (name, start, end) on ``time.perf_counter``."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))


class Window:
    """One profiled sub-window: ``open()`` before the loop, ``mark_start()``
    and ``mark_end()`` at quiet points inside it, ``close()`` after it."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def mark_start(self) -> None:
        self.t0 = self._mark()

    def mark_end(self) -> None:
        self.t1 = self._mark()

    def close(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.stop()

    def _mark(self) -> float:
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.torch.cuda._sleep(MARKER_CYCLES)
        return t

    def events(self) -> list[tuple[str, float, float]]:
        """The device's operations as (name, start, end) in host-clock
        seconds, clipped to the sub-window, markers left out."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        ops = sorted((e for e in trace.get("traceEvents", [])
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda e: float(e["ts"]))
        return clip(ops, self.t0, self.t1)


def _is_marker(e) -> bool:
    return "sleep" in e["name"] or "spin" in e["name"]


def clip(ops, t0: float, t1: float) -> list[tuple[str, float, float]]:
    """``ops`` (trace events, microseconds, in order) on the host clock,
    clipped to [t0, t1], markers left out.  The clocks are tied by the
    start marker, the first of the trace's two; a trace without both
    is refused."""
    marks = [e for e in ops if _is_marker(e)]
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} of its 2 marker "
                           f"kernels ({len(ops)} operations)")
    base = float(marks[0]["ts"]) * 1e-6 - t0
    out = []
    for e in ops:
        if _is_marker(e):
            continue
        a = float(e["ts"]) * 1e-6 - base
        b = a + float(e["dur"]) * 1e-6
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((e["name"], a, b))
    return sorted(out, key=lambda x: x[1])


def union(intervals) -> list[tuple[float, float]]:
    """The merged cover of (start, end) intervals, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(events) -> float:
    return sum(b - a for a, b in union((a, b) for _, a, b in events))


def idle_gaps(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] that no device operation covers."""
    gaps, cur = [], t0
    for a, b in union((a, b) for _, a, b in events):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def label(spans, t: float) -> str:
    """The innermost harness span around host instant ``t``."""
    inside = [(e - s, n) for n, s, e in spans if s <= t <= e]
    return min(inside)[1] if inside else "untraced"


def breakdown(events, spans, t0: float, t1: float, top: int = 10) -> dict:
    """The device operations that took most time (by name) and the
    longest idle gaps, each named by what the host was doing."""
    by_name: dict[str, float] = {}
    for name, a, b in events:
        key = name if len(name) <= 160 else name[:157] + "..."
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(events, t0, t1), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(spans, (a + b) / 2), b - a]
                          for a, b in gaps]}
