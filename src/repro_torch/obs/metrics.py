"""Zero-dependency metrics registry: counters, gauges, histograms.

The port's copy of ``repro.obs.metrics`` (the port imports nothing of
``repro``).  The serving hot path reports into a
:class:`MetricsRegistry` — plain Python ints/floats behind attribute
access, no locks, no I/O — and anything that wants the numbers takes a
:meth:`~MetricsRegistry.snapshot` (a nested plain-dict tree, grouped by
the dotted metric-name prefixes) or serializes it with
:meth:`~MetricsRegistry.to_json`; :func:`format_metrics` renders any
such tree as aligned text.

Histograms use fixed upper-bound buckets (Prometheus-style ``le``
semantics, implicit ``+inf`` tail) so ``observe`` is a bisect + add;
:func:`hist_quantile` recovers approximate percentiles by linear
interpolation inside the containing bucket.
"""

from __future__ import annotations

import bisect
import json

# default step-latency bucket bounds, in microseconds: ~100us (one host
# dispatch) up to 1s, roughly x2.5 per step
DEFAULT_US_BUCKETS = (100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0,
                      10_000.0, 25_000.0, 50_000.0, 100_000.0,
                      250_000.0, 1_000_000.0)


class Counter:
    """Monotonic counter.  ``inc`` is the hot-path call."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (pool occupancy, queue depth)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` semantics.

    ``bounds`` are the finite upper bounds, strictly increasing; every
    observation lands in the first bucket whose bound is >= the value,
    or in the implicit ``+inf`` tail.  ``counts`` has
    ``len(bounds) + 1`` entries.
    """

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds=DEFAULT_US_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram bounds must be strictly increasing: {bounds}")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    def snapshot(self) -> dict:
        buckets = {f"{b:g}": c for b, c in zip(self.bounds, self.counts)}
        buckets["+inf"] = self.counts[-1]
        return {"count": self.count, "sum": round(self.total, 3),
                "buckets": buckets}

    def quantile(self, q: float) -> float:
        return hist_quantile(self.snapshot(), q)


def hist_quantile(snap: dict, q: float) -> float:
    """Approximate quantile from a histogram *snapshot* (linear
    interpolation inside the containing bucket; the open ``+inf`` tail
    reports its lower bound).  ``q`` in [0, 1]."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    count = snap["count"]
    if count == 0:
        return 0.0
    items = list(snap["buckets"].items())
    rank = q * count
    seen = 0.0
    lo = 0.0
    for name, c in items:
        hi = float("inf") if name == "+inf" else float(name)
        if seen + c >= rank and c > 0:
            if hi == float("inf"):
                return lo
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += c
        lo = hi if hi != float("inf") else lo
    return lo


class MetricsRegistry:
    """Name -> metric map with dotted-prefix grouping in snapshots.

    Names are dotted paths (``"prefix_cache.hits"``); a name can never
    be both a leaf and a group (``"a"`` and ``"a.b"`` conflict), which
    keeps the snapshot tree unambiguous.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _register(self, name: str, kind, **kwargs):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m
        for other in self._metrics:
            if other.startswith(name + ".") or name.startswith(other + "."):
                raise ValueError(
                    f"metric name {name!r} conflicts with existing "
                    f"{other!r}: a name cannot be both leaf and group")
        m = kind(**kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._register(name, Gauge)

    def histogram(self, name: str,
                  bounds=DEFAULT_US_BUCKETS) -> Histogram:
        return self._register(name, Histogram, bounds=bounds)

    def snapshot(self) -> dict:
        """Nested plain-dict tree: dotted names split into groups,
        counters/gauges as numbers, histograms as their snapshot dict."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            node = out
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = (m.snapshot() if isinstance(m, Histogram)
                          else m.value)
        return out

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent)


def _is_hist_snap(v) -> bool:
    return isinstance(v, dict) and set(v) == {"count", "sum", "buckets"}


def format_metrics(tree: dict, sections=None, indent: str = "") -> str:
    """Render any nested dict-of-numbers tree as aligned text lines.

    The ONE formatter every serve-mode summary goes through: registry
    snapshots, the engines' ``spec_stats()``/``prefix_stats()`` view
    dicts, and the DRAM ledger report all print here.  ``sections``
    optionally restricts the top-level groups rendered (in the given
    order).  Histogram snapshots render as p50/p95/p99 + count; float
    values in [0, 1] under names ending in ``rate`` render as percents.
    """
    lines: list[str] = []
    keys = list(sections) if sections is not None else sorted(tree)

    def walk(node: dict, prefix: str) -> None:
        flat = []
        for k in sorted(node):
            v = node[k]
            name = f"{prefix}{k}"
            if _is_hist_snap(v):
                flat.append((name, f"p50={hist_quantile(v, 0.5):.0f} "
                                   f"p95={hist_quantile(v, 0.95):.0f} "
                                   f"p99={hist_quantile(v, 0.99):.0f} "
                                   f"count={v['count']}"))
            elif isinstance(v, dict):
                walk(v, f"{name}.")
            elif isinstance(v, float):
                if k.endswith("rate") and 0.0 <= v <= 1.0:
                    flat.append((name, f"{v:.1%}"))
                else:
                    flat.append((name, f"{v:g}"))
            else:
                flat.append((name, str(v)))
        if flat:
            width = max(len(n) for n, _ in flat)
            for n, s in flat:
                lines.append(f"{indent}{n:<{width}}  {s}")

    for key in keys:
        if key not in tree:
            continue
        v = tree[key]
        walk(v if isinstance(v, dict) and not _is_hist_snap(v)
             else {key: v}, f"{key}." if isinstance(v, dict)
             and not _is_hist_snap(v) else "")
    return "\n".join(lines)
