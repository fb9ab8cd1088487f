"""Modeled-vs-resolved DRAM accounting and schedule-cache telemetry (the
port of ``repro.obs.dram``).

The paper's contribution is an analytical model that *predicts* memory
traffic; this module closes the loop at serving time.  Every schedule
resolution that flows through ``repro_torch.tune.best_schedule`` inside
a :meth:`DramLedger.scope` is observed by that ledger, which records per
op key:

* **model said X** -- ``predicted_dram_bytes`` of the analytic top
  candidate for the spec (what the paper's search picks today);
* **schedule cache says Y** -- ``predicted_dram_bytes`` of the tiles
  the op actually ran with (a cache hit's persisted winner, or the same
  analytic tiles on a miss), and the ratio **Z = Y / X**;
* **cache hit or miss** -- misses (resolutions that fell back to the
  analytic default instead of a persisted schedule) are counted in the
  registry and appended, once per key, to a JSONL *miss log* that
  ``python -m repro_torch.tune --from-telemetry <log>`` replays as
  tuning targets.

Attribution is eager, a deliberate difference from JAX's.  JAX resolves
a schedule once per jit trace, so its ledger learns a scope tag's bytes
on the tag's first execution and adds that fixed sum at every later one.
Here ``kernels.ops`` resolves on every call, so a scope's bytes are what
resolved inside that execution, ``dispatches`` are real kernel calls (a
GEMM in a 40-layer model counts 40 times a step, where JAX counts it
once per trace), and ``per_tag`` reports executions and the mean bytes
per execution.

The per-call cost is kept small, because serving is host-bound: a
repeat resolution is one dict hit on the resolved schedule object (the
tuner's memo returns the same one each time; another object with the
same ``(spec, tiles)`` takes a second lookup) and two increments, with
no string formatting and no model evaluation; the scope's
bytes and the hit and miss counters are summed at scope exit and at
:meth:`DramLedger.end_step`.  A scope installs its ledger as the tuner's
observer (``tune.set_schedule_observer``) for its duration, so code
outside every scope is unobserved and ``best_schedule`` pays one
``None`` check.
"""

from __future__ import annotations

import contextlib
import json
import os

from repro_torch import tune
from repro_torch.tune.schedule import OpSpec, Schedule


class _Entry:
    """One resolved ``(spec, tiles)``: its report key, how its tiles were
    sourced, its byte counts (computed once) and its resolution counts.
    The profiler fills the ``kernel_*``, ``min_bytes``, ``flops``,
    ``bound_s`` and ``energy`` fields."""

    __slots__ = ("key", "spec", "tiles", "source", "schedule", "n",
                 "scope_n",
                 "used_bytes", "modeled_bytes", "kernel_bytes",
                 "kernel_analytic_bytes", "min_bytes", "flops", "bound_s",
                 "energy")

    def __init__(self, key: str, spec: OpSpec, schedule: Schedule):
        self.key, self.spec = key, spec
        self.tiles, self.source = schedule.tiles, schedule.source
        self.schedule = schedule    # pinned: its id keys the fast path
        self.n = self.scope_n = 0
        self.used_bytes = self.modeled_bytes = None
        self.kernel_bytes = self.kernel_analytic_bytes = None
        self.min_bytes = self.flops = self.bound_s = self.energy = None


def model_bytes(spec: OpSpec, tiles) -> int | None:
    """The blocking model's predicted DRAM bytes of ``tiles``, or None
    where the model cannot score them (tiles that do not divide: the
    kernels run them masked)."""
    try:
        return int(tune.predicted_dram_bytes(spec, tuple(tiles)))
    except ValueError:
        return None


class DramLedger:
    """Per-op-key modeled-vs-resolved DRAM byte accounting.

    ``registry`` (optional) receives ``schedule_cache.hits`` /
    ``schedule_cache.misses`` counters; ``miss_log`` (optional path)
    receives one JSONL line per distinct missed op key.
    """

    def __init__(self, registry=None, miss_log: str | None = None):
        self._device: str | None = None     # resolved on first record
        self._tag: str | None = None        # active scope tag
        self._res: dict[tuple, _Entry] = {}     # (spec, tiles) -> entry
        self._by_id: dict[int, _Entry] = {}     # id(entry.schedule) -> it
        self._ops: dict[str, _Entry] = {}       # report key -> entry
        self._tag_ops: dict[str, dict[str, int]] = {}  # tag -> key -> n
        self._tag_bytes: dict[str, int] = {}    # tag -> bytes, all execs
        self._execs: dict[str, int] = {}        # tag -> executions
        self._step_hist: list[int] = []         # bytes attributed per step
        self._req_bytes: dict[int, float] = {}  # rid -> attributed bytes
        self._pending = 0                       # bytes since last end_step
        self._logged: set[str] = set()
        self._miss_log_path = miss_log
        self._miss_f = None
        if registry is not None:
            self._m_hits = registry.counter("schedule_cache.hits")
            self._m_misses = registry.counter("schedule_cache.misses")
        else:
            self._m_hits = self._m_misses = None

    # -- observation ----------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, tag: str):
        """Make this ledger the tuner's observer, attributing every
        schedule resolution inside to ``tag``, and count one execution
        of it.  A nested scope takes the resolutions made inside it."""
        outer = [(e, e.scope_n) for e in self._res.values() if e.scope_n]
        for e, _ in outer:
            e.scope_n = 0
        prev_obs = tune.set_schedule_observer(self.record)
        prev_tag, self._tag = self._tag, tag
        try:
            yield self
        finally:
            tune.set_schedule_observer(prev_obs)
            self._tag = prev_tag
            self._close_scope(tag)
            for e, n in outer:
                e.scope_n += n

    def record(self, spec: OpSpec, schedule: Schedule) -> None:
        """Observer callback from ``tune.best_schedule``: one kernel
        call's resolution."""
        ent = self._by_id.get(id(schedule))
        if ent is None or ent.schedule is not schedule:
            ent = self._res.get((spec, schedule.tiles))
            if ent is None:
                ent = self._first(spec, schedule)
        ent.n += 1
        ent.scope_n += 1

    def _first(self, spec: OpSpec, schedule: Schedule) -> _Entry:
        """The first resolution of ``(spec, tiles)``: its key, bytes and
        miss-log line."""
        if self._device is None:
            self._device = tune.device_kind()
        key = spec.key(self._device)
        if key in self._ops:        # the same key at other tiles
            key = f"{key}@{'x'.join(map(str, schedule.tiles))}"
        ent = _Entry(key, spec, schedule)
        ent.used_bytes = model_bytes(spec, schedule.tiles)
        ent.modeled_bytes = (
            ent.used_bytes if schedule.source == "analytic"
            else model_bytes(spec, tune.analytic_schedule(spec).tiles))
        self._res[(spec, schedule.tiles)] = self._ops[key] = ent
        self._by_id[id(schedule)] = ent
        if schedule.source != "cache" and key not in self._logged:
            self._logged.add(key)
            self._log_miss(spec, schedule)
        return ent

    def _close_scope(self, tag: str) -> None:
        counts = self._tag_ops.setdefault(tag, {})
        b = 0
        for e in self._res.values():
            n = e.scope_n
            if n:
                counts[e.key] = counts.get(e.key, 0) + n
                if e.used_bytes is not None:
                    b += e.used_bytes * n
                e.scope_n = 0
        self._execs[tag] = self._execs.get(tag, 0) + 1
        self._tag_bytes[tag] = self._tag_bytes.get(tag, 0) + b
        self._pending += b

    def _log_miss(self, spec: OpSpec, schedule: Schedule) -> None:
        if self._miss_log_path is None:
            return
        if self._miss_f is None:
            d = os.path.dirname(self._miss_log_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._miss_f = open(self._miss_log_path, "a")
        self._miss_f.write(json.dumps({
            "op": spec.op, "dims": list(spec.dims), "dtype": spec.dtype,
            "stride": spec.stride, "device": self._device,
            "fallback_tiles": list(schedule.tiles),
            "source": schedule.source,
        }) + "\n")
        self._miss_f.flush()

    def _sync_counters(self) -> None:
        if self._m_hits is None:
            return
        hits = sum(e.n for e in self._res.values() if e.source == "cache")
        self._m_hits.value = hits
        self._m_misses.value = sum(e.n for e in self._res.values()) - hits

    # -- aggregation ----------------------------------------------------------

    def end_step(self, rids=()) -> int:
        """Close one engine step: bank the bytes its scopes accumulated
        into the per-step history and split them evenly across the step's
        active request ids.  Returns the step's byte total."""
        bytes_this_step = self._pending
        self._pending = 0
        self._step_hist.append(bytes_this_step)
        rids = list(rids)
        if rids and bytes_this_step:
            share = bytes_this_step / len(rids)
            for rid in rids:
                self._req_bytes[rid] = self._req_bytes.get(rid, 0.0) + share
        self._sync_counters()
        return bytes_this_step

    def report(self) -> dict:
        """JSON-safe modeled-vs-resolved report.

        ``per_op[key]`` holds the "model said X, schedule cache says Y,
        ratio Z" triple, how the tiles were sourced and how many calls
        resolved them; ``per_tag`` maps each scope tag to its executions,
        the mean bytes of one and the keys it saw; ``per_step`` /
        ``per_request`` summarize attribution."""
        self._sync_counters()
        per_op = {}
        for key, ent in sorted(self._ops.items()):
            X, Y = ent.modeled_bytes, ent.used_bytes
            per_op[key] = {
                "tiles": list(ent.tiles),
                "source": ent.source,
                "resolved": ent.n,
                "modeled_bytes": X,
                "used_bytes": Y,
                "ratio": (round(Y / X, 4) if X and Y is not None else None),
            }
        per_tag = {tag: {"executions": n,
                         "bytes_per_execution": round(
                             self._tag_bytes.get(tag, 0) / n, 1),
                         "ops": sorted(self._tag_ops.get(tag, ()))}
                   for tag, n in sorted(self._execs.items())}
        steps = self._step_hist
        return {
            "device": self._device,
            "attribution": "eager: each execution's own resolutions",
            "per_op": per_op,
            "per_tag": per_tag,
            "total_bytes": sum(self._tag_bytes.values()),
            "per_step": {
                "steps": len(steps),
                "bytes_mean": (round(sum(steps) / len(steps), 1)
                               if steps else 0.0),
                "bytes_max": max(steps) if steps else 0,
            },
            "per_request": {
                "requests": len(self._req_bytes),
                "bytes_mean": (round(sum(self._req_bytes.values())
                                     / len(self._req_bytes), 1)
                               if self._req_bytes else 0.0),
                "by_rid": {str(r): round(v, 1)
                           for r, v in sorted(self._req_bytes.items())},
            },
        }

    def close(self) -> None:
        if self._miss_f is not None:
            self._miss_f.close()
            self._miss_f = None


def read_miss_log(path: str) -> list[dict]:
    """Parse a miss-log JSONL file into deduplicated tuning targets.

    Tolerates blank and corrupt lines (a crashed run truncates mid-line);
    each target dict has ``op``, ``dims``, ``dtype``, ``stride`` and is
    unique by that identity.
    """
    targets: list[dict] = []
    seen: set[tuple] = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                ident = (d["op"], tuple(d["dims"]),
                         d.get("dtype", "float32"), int(d.get("stride", 1)))
            except (ValueError, KeyError, TypeError):
                continue
            if ident in seen:
                continue
            seen.add(ident)
            targets.append({"op": ident[0], "dims": list(ident[1]),
                            "dtype": ident[2], "stride": ident[3]})
    return targets
