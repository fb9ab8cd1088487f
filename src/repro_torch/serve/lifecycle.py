"""Request lifecycle: the port's copy of :class:`RequestStatus` and
:func:`replay_cost_tokens` from ``repro.serve.lifecycle`` (the
degradation ladder is a later slice)."""

from __future__ import annotations

import enum


class RequestStatus(enum.Enum):
    """Terminal outcome of one serving request.

    ``OK``                 — full token budget emitted, never disturbed.
    ``TRUNCATED``          — cancelled mid-flight; ``output`` holds the
                             tokens emitted so far.
    ``DEADLINE_EXCEEDED``  — wall deadline or TTL expired (queued or
                             running); partial output like TRUNCATED.
    ``PREEMPTED_RETRIED``  — full budget emitted, but the request was
                             preempted and restored at least once.
    ``FAILED``             — admission retries exhausted, or the NaN/Inf
                             guard caught poisoned logits for this slot.
    """

    OK = "ok"
    TRUNCATED = "truncated"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    PREEMPTED_RETRIED = "preempted_retried"
    FAILED = "failed"


def replay_cost_tokens(cached_positions: int, page_size: int,
                       shared: bool) -> int:
    """Model-call tokens a preempted request re-runs when restored.

    ``cached_positions`` is the number of K/V positions written for the
    victim (its device length).  With the prefix cache (``shared``),
    complete pages survive in the radix tree and only the tail past the
    last page boundary replays, plus the one position whose sampled
    token never had its K/V written.  Without a tree every position
    replays.
    """
    if shared:
        return cached_positions - (cached_positions // page_size) \
            * page_size + 1
    return cached_positions + 1
