"""Request lifecycle and graceful degradation (the port of
``repro.serve.lifecycle``, host code copied whole).

Everything the serving stack needs to give a request a definite terminal
outcome lives here, shared by the scheduler, the engine, the chaos
harness and the launcher:

* :class:`RequestStatus`: the five terminal states every request ends
  in; the engine counts each under ``lifecycle.<status>`` in the
  metrics registry.
* :func:`replay_cost_tokens`: the preempt-and-recompute price.  With the
  prefix cache on, a preempted request's complete pages go into the
  radix tree, so restoring it replays only the tail past the last page
  boundary (the boundary-slack term ``(p - 1) / 2`` of
  :func:`repro_torch.serve.kv_cache.reuse_priced_page` is its expected
  value).  The scheduler ranks equal-priority victims by it.
* :class:`DegradationController`: the pressure ladder.  It reads the
  metrics registry (p99 step latency, free-page watermark, queue depth)
  and steps through ``no_spec`` (speculative decode off) ->
  ``small_chunk`` (half the decode chunk) -> ``preempt`` (preemption
  even when the config flag is off), with hysteresis both ways.  Each
  transition is a trace instant and a counter tick; the current rung is
  the ``degrade.level`` gauge.
"""

from __future__ import annotations

import dataclasses
import enum


class RequestStatus(enum.Enum):
    """Terminal outcome of one serving request.

    ``OK``                 — full token budget emitted, never disturbed.
    ``TRUNCATED``          — cancelled mid-flight; ``output`` holds the
                             tokens emitted so far (a byte-exact prefix
                             of the undisturbed run).
    ``DEADLINE_EXCEEDED``  — wall deadline or TTL expired (queued or
                             running); partial output like TRUNCATED.
    ``PREEMPTED_RETRIED``  — full budget emitted, but the request was
                             preempted and restored at least once on
                             the way (tokens still byte-exact).
    ``FAILED``             — admission retries exhausted, or the NaN/Inf
                             guard caught poisoned logits for this slot;
                             output holds only tokens emitted before the
                             fault.
    """

    OK = "ok"
    TRUNCATED = "truncated"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    PREEMPTED_RETRIED = "preempted_retried"
    FAILED = "failed"


#: statuses whose output must be a byte-exact prefix of (or equal to)
#: the fault-free run's tokens — the chaos runner's correctness bar
EXACT_STATUSES = (RequestStatus.OK, RequestStatus.PREEMPTED_RETRIED)
PREFIX_STATUSES = (RequestStatus.TRUNCATED,
                   RequestStatus.DEADLINE_EXCEEDED,
                   RequestStatus.FAILED)


def replay_cost_tokens(cached_positions: int, page_size: int,
                       shared: bool) -> int:
    """Model-call tokens a preempted request re-runs when restored.

    ``cached_positions`` is the number of K/V positions written for the
    victim (its device length).  With the prefix cache (``shared``),
    complete pages survive in the radix tree and only the tail past the
    last page boundary replays, plus the one position whose sampled
    token never had its K/V written.  Without a tree every position
    replays.  This is the recompute side of the store-vs-recompute
    tradeoff ``reuse_priced_page`` prices analytically (expected tail
    = ``(page_size - 1) / 2``); here the *actual* tail ranks victims.
    """
    if shared:
        return cached_positions - (cached_positions // page_size) \
            * page_size + 1
    return cached_positions + 1


@dataclasses.dataclass
class DegradeThresholds:
    """Pressure signals that push the ladder up a rung.

    Any one signal firing counts as pressure for that update; pressure
    must persist ``sustain`` consecutive updates to escalate, and
    ``recover`` consecutive clear updates to de-escalate (hysteresis —
    one noisy step never flips the ladder).
    """

    p99_step_us: float = 0.0        # 0 -> ignore the latency signal
    free_page_frac: float = 0.125   # free/capacity watermark
    queue_depth: int = 8            # waiting requests
    sustain: int = 2
    recover: int = 8


class DegradationController:
    """Steps the serving engine down a ladder of cheaper modes.

    Rungs (``LEVELS`` index = severity): ``normal`` → ``no_spec``
    (speculative decode off: verify calls waste full-span model work
    exactly when the batch is saturated) → ``small_chunk`` (halve the
    decode chunk: finished requests leave, and admission re-checks,
    twice as often) → ``preempt`` (reclaim pages from the lowest-
    priority running request via preempt-with-restore).

    Reads only the shared metrics registry — the same numbers the
    operator sees — so the ladder is reproducible from a metrics
    snapshot.  The engine calls :meth:`update` once per step *before*
    planning and applies the rung's overrides for that step.
    """

    LEVELS = ("normal", "no_spec", "small_chunk", "preempt")

    def __init__(self, registry, thresholds: DegradeThresholds | None = None,
                 tracer=None):
        self.thresholds = thresholds or DegradeThresholds()
        self.tracer = tracer
        self.level = 0
        self._hot = 0
        self._cool = 0
        # share the engine/scheduler/allocator metric objects: _register
        # returns the existing instance for a known name
        self._step_us = registry.histogram("engine.step_us")
        self._queue_depth = registry.gauge("sched.queue_depth")
        self._pages_in_use = registry.gauge("pages.in_use")
        self._pages_capacity = registry.gauge("pages.capacity")
        self._m_level = registry.gauge("degrade.level")
        self._m_escalations = registry.counter("degrade.escalations")
        self._m_recoveries = registry.counter("degrade.recoveries")

    def _pressure(self) -> str | None:
        """Name of the first firing signal, or None when clear."""
        thr = self.thresholds
        cap = self._pages_capacity.value
        if cap and self._queue_depth.value > 0:
            free_frac = 1.0 - self._pages_in_use.value / cap
            if free_frac < thr.free_page_frac:
                return "free_pages"
        if self._queue_depth.value >= thr.queue_depth:
            return "queue_depth"
        if thr.p99_step_us and self._step_us.count:
            if self._step_us.quantile(0.99) > thr.p99_step_us:
                return "p99_step_us"
        return None

    def update(self) -> int:
        """One control tick; returns the (possibly new) ladder level."""
        signal = self._pressure()
        if signal is not None:
            self._hot += 1
            self._cool = 0
        else:
            self._cool += 1
            self._hot = 0
        thr = self.thresholds
        if self._hot >= thr.sustain and self.level < len(self.LEVELS) - 1:
            self._transition(self.level + 1, signal)
            self._hot = 0
        elif self._cool >= thr.recover and self.level > 0:
            self._transition(self.level - 1, "recovered")
            self._cool = 0
        self._m_level.set(self.level)
        return self.level

    def _transition(self, new_level: int, signal: str | None) -> None:
        up = new_level > self.level
        old = self.LEVELS[self.level]
        self.level = new_level
        (self._m_escalations if up else self._m_recoveries).inc()
        if self.tracer is not None:
            self.tracer.instant(
                f"degrade.{'up' if up else 'down'}", cat="lifecycle",
                args={"from": old, "to": self.LEVELS[new_level],
                      "signal": signal})

    # rung -> engine overrides ------------------------------------------------

    @property
    def spec_disabled(self) -> bool:
        return self.level >= 1

    @property
    def shrink_chunk(self) -> bool:
        return self.level >= 2

    @property
    def allow_preempt(self) -> bool:
        return self.level >= 3
