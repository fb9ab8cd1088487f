"""Decode-priority continuous-batching scheduler (host code, copied
whole from ``repro.serve.scheduler`` and re-pointed at the port's page
allocator, prefix cache, lifecycle and metrics).

Policy layer of the serving subsystem (layout lives in ``kv_cache``,
model math in ``engine``).  Two decisions live here, both pure host-side
bookkeeping so the hypothesis suite (``tests/test_serve_invariants.py``)
can drive them with random traces:

**Admission** (:meth:`Scheduler.admit`) is backfill-with-aging.  A
request is admitted when (a) a batch slot is free and (b) the page pool
can cover its whole lifetime — ``ceil((prompt_len + max_new_tokens) /
page_size)`` pages are reserved up front, so a running request can never
stall mid-decode waiting for a page (no admission deadlock, at the cost
of tail-page slack).  Unlike the original strict-FIFO rule, a younger
request that fits may be admitted past a head that doesn't
(head-of-line backfill keeps slots busy) — bounded by an anti-starvation
aging rule: every admission round a waiting request stays queued
increments its ``age``, and once the head's age reaches ``age_limit``
admission becomes head-only until the head gets in.  Because running
requests have bounded token budgets and whole-lifetime reservations,
their pages always return, so a starving head is eventually admitted —
the property the invariant suite checks.

With a :class:`~repro.serve.kv_cache.PrefixCache` attached, admission
first matches the prompt's longest cached full-page prefix: matched
pages are *shared* (refcount bump) instead of allocated, the page
budget counts only the unshared tail, and the request's prefill starts
at the matched boundary.  An exact full-page match CoW-forks its last
page (the final prompt token must re-run for the first-sample logits,
and its K/V write would otherwise land in the shared page).  When the
free list alone cannot cover the unshared tail, admission reclaims LRU
leaves from the tree — pages only the tree references, never one a
live request owns — so a full cache degrades to a smaller cache, not
to an admission stall (the aging liveness guarantee survives sharing).

**Step planning** (:meth:`Scheduler.plan_step`) is decode-priority:
every decode-ready slot decodes every step (a decode-ready slot is never
skipped in favor of prefill — the no-starvation invariant), and prefill
chunks backfill the remaining per-step token budget
(``max_batch * decode_chunk`` tokens), round-robin across prefilling
slots so one long prompt cannot monopolize the backfill.  At least one
chunk runs whenever any slot is prefilling, so prefill always makes
progress even at full decode load.

Finished requests are evicted at the step boundary, their pages return
to the pool, and the freed slot joins the next admission round.

**Lifecycle hardening** (docs/robustness.md) rides on the same
bookkeeping: every admission probe failure counts against an optional
retry budget with aging-aware backoff (a backed-off request probes
less often, but never so rarely it can't reach the head-only aging
guarantee), waiting requests expire against a wall deadline or a TTL
in scheduler steps (:meth:`Scheduler.expire`), and under sustained
pressure the engine may :meth:`Scheduler.preempt` the lowest-priority
running request: its *complete* pages are registered into the prefix
tree before eviction, so the replacement — requeued directly behind
the starving head — re-admits via prefix match and replays only the
unshared tail (``lifecycle.replay_cost_tokens`` ranks victims by
exactly that tail).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.kv_cache import PageAllocator, num_blocks
from repro_torch.serve.lifecycle import replay_cost_tokens


@dataclasses.dataclass
class Request:
    """One generation request (host-side bookkeeping)."""

    rid: int
    prompt: np.ndarray              # (L,) int32
    max_new_tokens: int
    pages: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    prefilled: int = 0              # prompt tokens already in the KV cache
    generated: int = 0              # tokens sampled so far
    age: int = 0                    # admission rounds spent waiting
    output: np.ndarray | None = None   # set at eviction
    cached_tokens: int = 0          # prompt tokens matched in the prefix tree
    cow_fork: tuple[int, int] | None = None   # (src, dst) page fork to apply
    # -- lifecycle (docs/robustness.md) --------------------------------------
    priority: int = 0               # higher survives preemption longer
    deadline_ns: int | None = None  # absolute engine-clock ns, None = none
    expire_step: int | None = None  # absolute scheduler step, None = none
    retries: int = 0                # admission probe failures so far
    preempt_count: int = 0          # times preempted-and-restored
    prior_tokens: np.ndarray | None = None   # emitted before preemption(s)
    orig_prompt_len: int = -1       # prompt length at first submission
    orig_max_new: int = -1          # token budget at first submission
    cancelled: bool = False         # cooperative cancel -> TRUNCATED
    failed: bool = False            # NaN guard / retry exhaustion -> FAILED
    status: object = None           # lifecycle.RequestStatus, terminal
    backoff: int = 0                # admission rounds until the next probe
    # -- host stamps, time.perf_counter_ns (the engine's module docstring)
    t_submit: int | None = None     # submitted
    t_admit: int | None = None      # first admitted
    t_first_token: int | None = None   # first token on the host

    def __post_init__(self):
        if self.orig_prompt_len < 0:
            self.orig_prompt_len = self.prompt_len
        if self.orig_max_new < 0:
            self.orig_max_new = self.max_new_tokens

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prompt_len

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    @property
    def decode_ready(self) -> bool:
        """Admitted, fully prefilled, budget left — decodes this step."""
        return self.slot >= 0 and self.prefill_done and not self.done

    @property
    def emitted_total(self) -> int:
        """Tokens emitted across every admission of this request."""
        prior = 0 if self.prior_tokens is None else len(self.prior_tokens)
        return prior + self.generated

    def expired(self, now_ns: int, step: int) -> bool:
        return ((self.deadline_ns is not None
                 and now_ns >= self.deadline_ns)
                or (self.expire_step is not None
                    and step >= self.expire_step))


@dataclasses.dataclass
class StepPlan:
    """One step's work, in execution order: decode first, then chunks.

    ``prefill_slots`` may name a slot more than once (several chunks of
    the same prompt in one otherwise-idle step); the engine executes
    them in order.
    """

    decode_slots: list[int]
    prefill_slots: list[int]


class Scheduler:
    """Decode-priority continuous batching over ``max_batch`` slots and
    a refcounted page pool."""

    def __init__(self, max_batch: int, page_size: int,
                 allocator: PageAllocator, max_seq: int,
                 age_limit: int = 8, prefix_cache=None, metrics=None,
                 max_retries: int | None = None):
        self.max_batch = max_batch
        self.page_size = page_size
        self.allocator = allocator
        self.max_seq = max_seq
        self.age_limit = age_limit
        self.max_retries = max_retries   # probe failures before FAILED
        self.prefix_cache = prefix_cache       # kv_cache.PrefixCache | None
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}          # slot -> Request
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self._rr = 0                                   # backfill round-robin
        self._rejected: list[Request] = []     # retry budget exhausted
        # a private registry when none is shared keeps the report paths
        # branch-free (same cost either way: one int op per event)
        m = metrics if metrics is not None else MetricsRegistry()
        self._m_admitted = m.counter("sched.admitted")
        self._m_evicted = m.counter("sched.evicted")
        self._m_queue_depth = m.gauge("sched.queue_depth")
        self._m_head_age = m.gauge("sched.head_age")
        self._m_preemptions = m.counter("sched.preemptions")
        self._m_rejected = m.counter("sched.rejected")
        self._m_expired = m.counter("sched.expired")
        self._m_rollbacks = m.counter("sched.admit_rollbacks")

    # -- queue ----------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.total_len > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"{req.max_new_tokens} new > max_seq {self.max_seq}")
        if self.pages_needed(req) > self.allocator.capacity:
            # would wait forever: even an empty pool can't cover it
            raise ValueError(
                f"request {req.rid}: needs {self.pages_needed(req)} pages "
                f"but the pool holds {self.allocator.capacity}")
        self.waiting.append(req)

    def pages_needed(self, req: Request) -> int:
        return num_blocks(req.total_len, self.page_size)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission / eviction -------------------------------------------------

    def _fresh_needed(self, req: Request, matched: int) -> int:
        """Unshared pages a request must allocate given ``matched``
        prefix tokens from the tree — shared pages don't count against
        the budget, but an exact full-prompt match costs one extra page
        for the CoW fork of its last block."""
        shared = matched // self.page_size
        fork = 1 if (matched and matched == req.prompt_len) else 0
        return self.pages_needed(req) - shared + fork

    def _prepare(self, req: Request) -> list[int] | None:
        """Try to make ``req`` admittable right now.

        Probes the prefix tree for the longest cached full-page prefix,
        reclaims LRU tree leaves if the free list can't cover the
        unshared tail (never a page a live request owns), and — if even
        that falls short — gives the match up entirely and retries as a
        full re-prefill.  Returns the matched pages in block order
        (``[]`` for no match) when the request fits, else ``None``.
        No references are taken here; :meth:`_admit_one` attaches them.
        """
        matched_pages: list[int] = []
        if self.prefix_cache is not None:
            matched_pages = self.prefix_cache.match(req.prompt)
        need = self._fresh_needed(req,
                                  len(matched_pages) * self.page_size)
        if self.allocator.available() < need \
                and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.allocator.available(),
                                    protect=frozenset(matched_pages))
        if self.allocator.available() < need and matched_pages:
            # sharing can't fit (the matched path pins pages eviction
            # must not touch): drop the match and admit as a plain
            # full re-prefill if the pool allows it
            matched_pages = []
            need = self._fresh_needed(req, 0)
            if self.allocator.available() < need:
                self.prefix_cache.evict(need - self.allocator.available())
        if self.allocator.available() < need:
            return None
        return matched_pages

    def _admit_one(self, req: Request,
                   matched_pages: list[int]) -> Request | None:
        """Attach references and admit, or roll back *completely* and
        return None when the allocator reneges mid-admission (fault
        injection, or any future source of ``available()``/``alloc()``
        disagreement): no page may leak and the request must keep its
        queue position — chaos-harness invariants."""
        shared: list[int] = []
        fresh: list[int] = []
        fork = None
        try:
            for p in matched_pages:
                shared.append(self.allocator.share(p))
            matched = len(shared) * self.page_size
            start = matched
            if matched and matched == req.prompt_len:
                # exact full-page hit: the last prompt token must re-run
                # for the first-sample logits, and its K/V write lands in
                # the final matched page — CoW-fork it (the engine copies
                # the page contents device-side before the re-run)
                dst = self.allocator.alloc()
                src = shared[-1]
                fork = (src, dst)
                self.allocator.free(src)    # drop our ref on the original
                shared[-1] = dst
                start = matched - 1
            for _ in range(self.pages_needed(req) - len(shared)):
                fresh.append(self.allocator.alloc())
        except MemoryError:
            self.allocator.free_many(shared + fresh)
            self._m_rollbacks.inc()
            return None
        self.waiting.remove(req)
        req.slot = self._free_slots.pop()
        req.cow_fork = fork
        req.pages = shared + fresh
        req.cached_tokens = matched
        req.prefilled = start               # prefill resumes at the boundary
        self.running[req.slot] = req
        return req

    def _probe_failed(self, req: Request) -> bool:
        """Bookkeeping for one failed admission probe: bump the retry
        count, set the aging-aware backoff (doubles per failure, but
        shrinks to nothing as ``age`` approaches ``age_limit`` so a
        backed-off request still reaches the head-only aging guarantee),
        and — when a retry budget is set — reject the request outright
        once it is exhausted.  Returns True when the request was
        rejected (caller must not probe it again)."""
        req.retries += 1
        if self.max_retries is not None and req.retries > self.max_retries:
            self.waiting.remove(req)
            req.failed = True
            self._rejected.append(req)
            self._m_rejected.inc()
            return True
        req.backoff = max(0, min(1 << min(req.retries, 3),
                                 self.age_limit - req.age) - 1)
        return False

    def take_rejected(self) -> list[Request]:
        """Drain requests whose admission retry budget ran out (the
        engine fails them out with a terminal status)."""
        out, self._rejected = self._rejected, []
        return out

    def admit(self) -> list[Request]:
        """One admission round: backfill past a head that doesn't fit,
        unless the head is starving (``age >= age_limit``), in which
        case admission is head-only until it gets in.  Each admitted
        request leaves with its slot and its whole page reservation
        (block table order = logical block order), the leading entries
        shared from the prefix tree on a hit.  Backfill candidates in
        backoff are skipped without a probe; the head is always probed
        (head-of-line liveness is what the aging rule protects)."""
        admitted = []
        while self.waiting and self._free_slots:
            head = self.waiting[0]
            plan = self._prepare(head)
            got = self._admit_one(head, plan) if plan is not None else None
            if got is not None:
                admitted.append(got)
                continue
            if self._probe_failed(head):
                continue        # rejected: the next head gets its turn
            if head.age >= self.age_limit:
                break           # starving head blocks younger admissions
            for req in list(self.waiting)[1:]:
                if req.backoff > 0:
                    continue
                plan = self._prepare(req)
                got = self._admit_one(req, plan) if plan is not None \
                    else None
                if got is not None:
                    admitted.append(got)
                    break
                self._probe_failed(req)
            else:
                break           # nobody fits
        for req in self.waiting:
            req.age += 1
            if req.backoff > 0:
                req.backoff -= 1
        self._m_admitted.inc(len(admitted))
        self._m_queue_depth.set(len(self.waiting))
        self._m_head_age.set(self.waiting[0].age if self.waiting else 0)
        return admitted

    # -- lifecycle: expiry, cancellation, preemption --------------------------

    def cancel(self, rid: int) -> bool:
        """Cooperative cancel: the request finishes TRUNCATED at the
        next step boundary (queued requests drain via :meth:`expire`)."""
        for req in self.waiting:
            if req.rid == rid:
                req.cancelled = True
                return True
        for req in self.running.values():
            if req.rid == rid:
                req.cancelled = True
                return True
        return False

    def expire(self, now_ns: int, step: int) -> list[Request]:
        """Remove waiting requests whose deadline/TTL passed or that
        were cancelled while queued; the engine assigns their terminal
        status.  Running requests are handled at the engine's step
        boundary (their partial output needs the device readback)."""
        out = [r for r in self.waiting
               if r.expired(now_ns, step) or r.cancelled]
        for r in out:
            self.waiting.remove(r)
            if not r.cancelled:
                self._m_expired.inc()
        return out

    def preempt_candidate(self, force: bool = False) -> int | None:
        """Slot worth preempting so the waiting head can make progress,
        or None.

        Fires only when the head is starving (``age >= age_limit``,
        bypassed by ``force`` — the degradation ladder's top rung) and
        genuinely cannot be admitted right now.  The victim is the
        lowest-priority running request with budget left (never one
        above the head's priority), ties broken by the cheapest restore
        (fewest replayed tokens, per ``replay_cost_tokens``), then by
        youth (largest rid keeps long-running work).
        """
        if not self.waiting or not self.running:
            return None
        head = self.waiting[0]
        if not force and head.age < self.age_limit:
            return None
        if self._free_slots and self._prepare(head) is not None:
            return None         # head fits as-is: no victim needed
        shared = self.prefix_cache is not None
        cands = [r for r in self.running.values()
                 if r.priority <= head.priority
                 and r.max_new_tokens - r.generated > 0]
        if not cands:
            return None
        victim = min(cands, key=lambda r: (
            r.priority,
            replay_cost_tokens(r.prefilled + max(r.generated - 1, 0),
                               self.page_size, shared),
            -r.rid))
        return victim.slot

    def preempt(self, slot: int, emitted: np.ndarray) -> Request:
        """Preempt the running request in ``slot`` and requeue a
        replacement that restores it exactly.

        ``emitted`` is the slot's sampled-token readback (length
        ``generated``).  Every *complete* page of written K/V — the
        device length is ``prefilled + generated - 1``: the latest
        sampled token's K/V is only written when it is fed back — goes
        into the prefix tree before eviction, so the tree keeps those
        pages alive (refcount = tree ref) while the victim's owner refs
        are dropped.  The replacement carries prompt + emitted tokens as
        its new prompt and the remaining budget, so on re-admission it
        prefix-matches the registered pages and replays only the
        unshared tail; greedy decoding makes the continuation
        byte-exact.  It is queued directly *behind* the current head:
        preemption exists to unblock the starving head, so the victim
        must not race it for the freed pages.
        """
        req = self.running[slot]
        emitted = np.asarray(emitted, np.int32).reshape(-1)
        full_seq = np.concatenate([req.prompt, emitted])
        cached = req.prefilled + max(req.generated - 1, 0)
        if self.prefix_cache is not None:
            nc = cached // self.page_size
            if nc:
                self.prefix_cache.insert(full_seq[:nc * self.page_size],
                                         req.pages[:nc])
        self.evict(slot)
        prior = (emitted if req.prior_tokens is None
                 else np.concatenate([req.prior_tokens, emitted]))
        new = Request(
            req.rid, full_seq, req.orig_max_new - len(prior),
            priority=req.priority, deadline_ns=req.deadline_ns,
            expire_step=req.expire_step, age=req.age,
            preempt_count=req.preempt_count + 1, prior_tokens=prior,
            orig_prompt_len=req.orig_prompt_len,
            orig_max_new=req.orig_max_new, cancelled=req.cancelled,
            t_submit=req.t_submit, t_admit=req.t_admit,
            t_first_token=req.t_first_token)
        self.waiting.insert(min(1, len(self.waiting)), new)
        self._m_preemptions.inc()
        return new

    def register_prefix(self, req: Request) -> None:
        """Cache a fully-prefilled request's full prompt pages in the
        tree (the engine calls this once prefill completes, when the
        pages are frozen — decode writes strictly past them)."""
        if self.prefix_cache is None:
            return
        nb = req.prompt_len // self.page_size
        if nb:
            self.prefix_cache.insert(req.prompt[:nb * self.page_size],
                                     req.pages[:nb])

    def evict(self, slot: int) -> Request:
        """Release a finished (or cancelled) request's slot and pages."""
        req = self.running.pop(slot)
        self.allocator.free_many(req.pages)
        req.pages = []
        req.slot = -1
        self._free_slots.append(slot)
        self._m_evicted.inc()
        return req

    # -- step planning --------------------------------------------------------

    def plan_step(self, decode_chunk: int, prefill_chunk: int) -> StepPlan:
        """Decode-priority plan for one engine step.

        Every decode-ready slot is in ``decode_slots`` — unconditionally,
        which is the whole no-starvation guarantee.  Prefill chunks then
        backfill the leftover of a ``max_batch * decode_chunk`` token
        budget (minimum one chunk whenever anything is prefilling, so
        prefill progresses even at full decode load), assigned
        round-robin over the prefilling slots.
        """
        decode_slots = sorted(
            s for s, r in self.running.items() if r.decode_ready)
        prefilling = sorted(
            s for s, r in self.running.items() if not r.prefill_done)
        if not prefilling:
            return StepPlan(decode_slots, [])
        budget = self.max_batch * decode_chunk
        budget -= len(decode_slots) * decode_chunk
        n_chunks = max(1, budget // max(prefill_chunk, 1))
        remaining = {
            s: num_blocks(self.running[s].prompt_len
                          - self.running[s].prefilled, prefill_chunk)
            for s in prefilling}
        chosen: list[int] = []
        i = self._rr
        while len(chosen) < n_chunks and any(remaining.values()):
            s = prefilling[i % len(prefilling)]
            i += 1
            if remaining[s] > 0:
                chosen.append(s)
                remaining[s] -= 1
        self._rr = i % len(prefilling)
        return StepPlan(decode_slots, chosen)
