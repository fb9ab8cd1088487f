"""Fault injectors for the serving stack (the port of
``repro.chaos.inject``; host code).

Each injector lives at a seam the real system already has, so chaos runs
exercise the production failure paths rather than test doubles:

* :class:`FlakyAllocator` -- a
  :class:`~repro_torch.serve.kv_cache.PageAllocator` whose ``alloc`` may
  renege even though ``available()`` said yes (the disagreement
  ``Scheduler._admit_one`` must roll back from without leaking), and
  which can take pages hostage (a co-tenant holding device memory) to
  force genuine exhaustion, retries and preemption.
* :class:`PlanChaos` -- wraps ``Scheduler.plan_step`` and duplicates or
  drops plan entries; the engine's plan validation must make duplicates
  idempotent and dropped entries merely late, never wrong.
* :class:`CorruptScheduleCache` -- a schedule cache whose hits are
  deliberately pessimal tiles, exercising the profiler's model-fidelity
  gate.

NaN/Inf logit poisoning needs the device's cooperation and so lives on
the engine itself (``PagedEngine.inject_logit_fault``, under
``nan_guard=True``); the chaos runner drives it from there.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hopper_adapter import default_smem_budget
from repro_torch.serve.kv_cache import PageAllocator
from repro_torch.serve.scheduler import StepPlan


class FlakyAllocator(PageAllocator):
    """Page allocator with injectable allocation failures.

    Two fault modes, composable:

    * **lie** — with probability ``lie_rate`` an ``alloc()`` raises
      ``MemoryError`` even though the free list is not empty.  The
      scheduler probes ``available()`` before attaching references, so
      a lie lands mid-admission and must trigger the rollback path
      (``sched.admit_rollbacks``) with zero leaked pages and the
      request still queued.
    * **hostages** — :meth:`take_hostages` really allocates pages and
      parks them (an external tenant squeezing the pool); the runner
      releases them later.  Hostage pages are owned by the injector, so
      invariant checks must count ``len(self.hostages)`` among the
      legitimate holders.

    ``fail_next`` forces the next ``n`` allocs to fail regardless of
    ``lie_rate`` — deterministic single-shot faults for unit tests.
    """

    def __init__(self, n_pages: int, rng=None, lie_rate: float = 0.0,
                 metrics=None):
        super().__init__(n_pages, metrics=metrics)
        self.rng = rng
        self.lie_rate = lie_rate
        self.fail_next = 0
        self.lies = 0
        self.hostages: list[int] = []

    def alloc(self) -> int:
        if self.fail_next > 0:
            self.fail_next -= 1
            self.lies += 1
            raise MemoryError("page pool exhausted (injected)")
        if self.lie_rate and self.rng is not None \
                and self.rng.random() < self.lie_rate:
            self.lies += 1
            raise MemoryError("page pool exhausted (injected)")
        return super().alloc()

    def take_hostages(self, n: int) -> int:
        """Genuinely allocate up to ``n`` pages and hold them; returns
        how many were taken (the pool may run dry first)."""
        took = 0
        for _ in range(n):
            try:
                self.hostages.append(PageAllocator.alloc(self))
            except MemoryError:
                break
            took += 1
        return took

    def release_hostages(self) -> int:
        """Free every hostage page; returns how many were released."""
        n = len(self.hostages)
        self.free_many(self.hostages)
        self.hostages = []
        return n


class PlanChaos:
    """Duplicate/drop corruption at the ``plan_step`` seam.

    The engine treats a :class:`~repro_torch.serve.scheduler.StepPlan` as a
    *suggestion* it validates — a duplicated decode slot must not
    double-advance a request, and a dropped slot only delays it (decode
    priority re-lists it next step).  This wrapper makes both happen on
    purpose; install it in place of the scheduler for planning only::

        chaos = PlanChaos(scheduler, rng, dup_rate=.2, drop_rate=.2)
        plan = chaos.plan_step(decode_chunk, prefill_chunk)
    """

    def __init__(self, sched, rng, dup_rate: float = 0.0,
                 drop_rate: float = 0.0):
        self.sched = sched
        self.rng = rng
        self.dup_rate = dup_rate
        self.drop_rate = drop_rate
        self.dups = 0
        self.drops = 0

    def _mangle(self, slots: list[int]) -> list[int]:
        out: list[int] = []
        for s in slots:
            if self.drop_rate and self.rng.random() < self.drop_rate:
                self.drops += 1
                continue
            out.append(s)
            if self.dup_rate and self.rng.random() < self.dup_rate:
                self.dups += 1
                out.append(s)
        return out

    def plan_step(self, decode_chunk: int, prefill_chunk: int) -> StepPlan:
        plan = self.sched.plan_step(decode_chunk, prefill_chunk)
        return StepPlan(self._mangle(plan.decode_slots),
                        self._mangle(plan.prefill_slots))


def _halvings(t: int) -> list[int]:
    """``t``, and its half where that is whole and at least 8."""
    return [t, t // 2] if t % 2 == 0 and t >= 16 else [t]


class CorruptScheduleCache:
    """A schedule cache whose hits are deliberately pessimal.

    For ops whose name contains ``match`` it returns the analytic winner
    with its tiles replaced by the variant that requests the most bytes
    (``obs.profile.kernel_hbm_bytes``) among the winner's tiles, each
    kept or halved (down to 8), that its kernel still runs: the key's own footprint and
    instance checks (``tune.fits_smem``; for the bf16 GEMM keys the
    tensor-core instances' warp grids and, at M <= 16, the decode
    instance's bn), which ``best_schedule`` applies to cached tiles too.
    JAX halves every tile, which its kernels' DMA elision turns into more
    traffic; here a plain halving may be refused, or move no more bytes
    (a bk only changes the staging step).  Specs with no such variant are
    not corrupted (the lookup misses).  Installed with
    ``tune.set_default_cache`` by ``python -m repro_torch.profile
    --corrupt`` to exercise the profiler's fidelity gate end to end.
    """

    def __init__(self, match: str):
        self.match = match

    def lookup(self, spec):
        from repro_torch import tune
        from repro_torch.obs.profile import kernel_hbm_bytes
        if self.match not in spec.op:
            return None
        top = tune.analytic_schedule(spec)
        budget = default_smem_budget()
        best, best_bytes = None, kernel_hbm_bytes(spec, top.tiles)
        variants = [()]
        for t in top.tiles:
            variants = [v + (h,) for v in variants for h in _halvings(t)]
        for tiles in variants:
            if tiles == top.tiles or not tune.fits_smem(spec, tiles, budget):
                continue
            b = kernel_hbm_bytes(spec, tiles)
            if b > best_bytes:
                best, best_bytes = tiles, b
        if best is None:
            return None
        return dataclasses.replace(top, tiles=best, source="cache")

    def store(self, schedule):
        pass
