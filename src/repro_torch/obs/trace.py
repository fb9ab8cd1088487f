"""The tracing-off span of ``repro.obs.trace``.

The engines open a span around each phase of a step; with no tracer
attached every span is this shared no-op, so the hot path pays one
call.  The Chrome-trace writer itself is a later slice
(``ROADMAP.md``, queue 1, item 14).
"""

from __future__ import annotations


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
