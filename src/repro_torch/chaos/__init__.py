"""Chaos/fault-injection harness for the paged serving stack (the port of
``repro.chaos``).

    # fast lane: one seeded engine schedule + 8 scheduler schedules
    PYTHONPATH=src python -m repro_torch.chaos --smoke [--device cpu]

    # the acceptance bar: 200 randomized fault schedules
    PYTHONPATH=src python -m repro_torch.chaos --schedules 200

Injectors (:mod:`repro_torch.chaos.inject`) sit at seams the production
code already has -- the page allocator, the step planner, the schedule
cache, the engine's NaN guard -- and the runner
(:mod:`repro_torch.chaos.runner`) drives randomized fault schedules
while asserting the serving invariants: zero page leaks, refcount =
owners + tree references, every request terminal, survivors byte-exact.
"""

from repro_torch.chaos.inject import (CorruptScheduleCache, FlakyAllocator,
                                      PlanChaos)
from repro_torch.chaos.runner import (engine_smoke, run_schedule,
                                      run_schedules)

__all__ = [
    "CorruptScheduleCache",
    "FlakyAllocator",
    "PlanChaos",
    "engine_smoke",
    "run_schedule",
    "run_schedules",
]
