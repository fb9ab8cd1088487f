"""Fault injection of the port (the part of ``repro.chaos`` ported so
far: :class:`~repro_torch.chaos.inject.CorruptScheduleCache`, the
profiler's ``--corrupt``).  The allocator and planner injectors and the
randomized-schedule runner are ``ROADMAP.md`` queue 1, item 15."""

from repro_torch.chaos.inject import CorruptScheduleCache

__all__ = ["CorruptScheduleCache"]
