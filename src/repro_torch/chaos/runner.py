"""Randomized chaos runner (the port of ``repro.chaos.runner``): the real
scheduler and prefix tree under fault schedules, with every serving
invariant asserted at every step.

Two layers:

* :func:`run_schedule` drives the production
  :class:`~repro_torch.serve.scheduler.Scheduler` and
  :class:`~repro_torch.serve.kv_cache.PrefixCache` over a
  :class:`~repro_torch.chaos.inject.FlakyAllocator` and
  :class:`~repro_torch.chaos.inject.PlanChaos`, with random cancellations,
  TTLs and preemptions layered on.  Tokens come from a deterministic
  per-request oracle, so the fault-free run never has to execute: a
  survivor is byte-exact iff its output equals the oracle stream —
  which it only can be if the preempt/restore bookkeeping (prompt
  extension, ``prior_tokens`` accumulation, replay resume point) is
  exact.  Each fault *storm* eventually passes (injectors disabled,
  hostage pages released), after which the drain must terminate — the
  aging-liveness guarantee under transient faults.
* :func:`engine_smoke` runs the real
  :class:`~repro_torch.serve.engine.PagedEngine` on a reduced model, on
  the card by default, with NaN poisoning, preemption, cancellation and
  TTL expiry in one schedule, differential against a fault-free run --
  the byte-exactness bar with actual device tokens.

Invariants asserted (under faults):

* **no page leak** — ``in_use`` equals exactly the pages held by
  running requests, the prefix tree, and hostages, every step;
* **refcount accounting** — every page's refcount equals its running
  owners plus its tree reference (plus one if held hostage);
* **terminal status** — every submitted request ends in exactly one
  :class:`~repro_torch.serve.lifecycle.RequestStatus`;
* **byte-exactness** — OK / PREEMPTED_RETRIED outputs equal the
  fault-free stream; TRUNCATED / DEADLINE_EXCEEDED / FAILED outputs
  are byte-exact *prefixes* of it;
* **liveness** — once the storm passes, the system drains in bounded
  steps.
"""

from __future__ import annotations

import numpy as np

from repro_torch.chaos.inject import FlakyAllocator, PlanChaos
from repro_torch.serve import kv_cache as KV
from repro_torch.serve.lifecycle import EXACT_STATUSES, RequestStatus
from repro_torch.serve.scheduler import Request, Scheduler


def oracle(rid: int, start: int, stop: int) -> np.ndarray:
    """Deterministic emitted-token stream for request ``rid``; the
    fault-free run by construction (greedy decode of a fixed model is a
    pure function of the prompt, which the rid stands in for)."""
    j = np.arange(start, stop, dtype=np.int64)
    return ((rid * 1009 + j * 31 + 7) % 97).astype(np.int32)


class ChaosSim:
    """One fault schedule over the production scheduler/tree/allocator.

    Mirrors the engine's step loop — expire sweep, admission, plan
    validation (dedupe + skip dead slots), advance, terminal sweep —
    with the model replaced by :func:`oracle` and faults injected
    between phases.  ``stats`` accumulates what was injected so the CLI
    can prove the schedule was not vacuously clean.
    """

    def __init__(self, rng, max_batch=3, page_size=4, n_pages=16,
                 max_seq=24, decode_chunk=2, prefill_chunk=4,
                 age_limit=4, max_retries=None, use_tree=True,
                 dup_rate=0.2, drop_rate=0.2, lie_rate=0.15):
        self.rng = rng
        self.alloc = FlakyAllocator(n_pages, rng, lie_rate=lie_rate)
        self.tree = KV.PrefixCache(self.alloc, page_size) if use_tree \
            else None
        self.sched = Scheduler(max_batch, page_size, self.alloc, max_seq,
                               age_limit=age_limit, prefix_cache=self.tree,
                               max_retries=max_retries)
        self.plan_chaos = PlanChaos(self.sched, rng, dup_rate=dup_rate,
                                    drop_rate=drop_rate)
        self.decode_chunk = decode_chunk
        self.prefill_chunk = prefill_chunk
        self.steps = 0
        self.prompts: dict[int, np.ndarray] = {}      # rid -> original
        self.budgets: dict[int, int] = {}             # rid -> orig_max_new
        self.terminal: dict[int, Request] = {}        # rid -> final req
        self.stats = {"preempts": 0, "cancels": 0, "ttl": 0,
                      "hostage_rounds": 0, "lies": 0, "dups": 0,
                      "drops": 0, "rollbacks": 0, "rejected": 0}

    # -- workload -------------------------------------------------------------

    def submit_random(self, rid: int, pool) -> None:
        """Prompt drawn from a template pool (so the tree really
        shares), with a random tail; sometimes a TTL, sometimes a
        priority — preemption needs both classes present."""
        rng = self.rng
        pre = pool[int(rng.integers(len(pool)))]
        tail = rng.integers(100, 197,
                            (int(rng.integers(0, self.sched.page_size)),))
        prompt = np.concatenate([pre, tail.astype(np.int32)])
        max_seq = self.sched.max_seq
        if len(prompt) >= max_seq:
            prompt = prompt[:max_seq - 1]
        n = int(rng.integers(1, max_seq - len(prompt) + 1))
        req = Request(rid, prompt, n,
                      priority=int(rng.integers(0, 2)))
        if rng.random() < 0.15:
            req.expire_step = self.steps + int(rng.integers(1, 40))
            self.stats["ttl"] += 1
        self.prompts[rid] = prompt
        self.budgets[rid] = n
        self.sched.submit(req)

    # -- engine-mirror helpers ------------------------------------------------

    def _prior_len(self, req: Request) -> int:
        return 0 if req.prior_tokens is None else len(req.prior_tokens)

    def _finish(self, req: Request) -> None:
        if req.failed:
            req.status = RequestStatus.FAILED
        elif req.done:
            req.status = (RequestStatus.PREEMPTED_RETRIED
                          if req.preempt_count else RequestStatus.OK)
        elif req.cancelled:
            req.status = RequestStatus.TRUNCATED
        else:
            req.status = RequestStatus.DEADLINE_EXCEEDED
        tail = oracle(req.rid, self._prior_len(req),
                      self._prior_len(req) + req.generated)
        req.output = tail if req.prior_tokens is None \
            else np.concatenate([req.prior_tokens, tail])
        assert req.rid not in self.terminal, \
            f"rid {req.rid} reached two terminal states"
        self.terminal[req.rid] = req

    def _inject(self) -> None:
        """One round of fault decisions (the storm)."""
        rng = self.rng
        if rng.random() < 0.1:
            self.alloc.take_hostages(int(rng.integers(1, 4)))
            self.stats["hostage_rounds"] += 1
        if self.alloc.hostages and rng.random() < 0.3:
            self.alloc.release_hostages()
        if rng.random() < 0.08:
            live = [r.rid for r in self.sched.waiting] + \
                   [r.rid for r in self.sched.running.values()]
            if live:
                self.sched.cancel(int(rng.choice(live)))
                self.stats["cancels"] += 1
        if rng.random() < 0.15 and self.sched.running:
            cands = [(s, r) for s, r in self.sched.running.items()
                     if r.max_new_tokens - r.generated > 0]
            if cands:
                slot, victim = cands[int(rng.integers(len(cands)))]
                emitted = oracle(victim.rid, self._prior_len(victim),
                                 self._prior_len(victim) + victim.generated)
                new = self.sched.preempt(slot, emitted)
                # restore identity: the replacement's prompt is the
                # original prompt plus everything emitted so far
                orig = self.prompts[new.rid]
                assert np.array_equal(new.prompt[:len(orig)], orig)
                assert np.array_equal(
                    new.prompt[len(orig):],
                    oracle(new.rid, 0, len(new.prior_tokens)))
                self.stats["preempts"] += 1

    def step(self, storm: bool = True) -> None:
        self.steps += 1
        for req in self.sched.expire(0, self.steps):
            self._finish(req)
        if storm:
            self._inject()
        for req in self.sched.admit():
            assert req.slot >= 0
            assert len(req.pages) == self.sched.pages_needed(req)
        for req in self.sched.take_rejected():
            self.stats["rejected"] += 1
            self._finish(req)
        planner = self.plan_chaos if storm else self.sched
        plan = planner.plan_step(self.decode_chunk, self.prefill_chunk)
        # the engine's plan validation: dedupe, skip dead/finished slots
        seen: set[int] = set()
        for s in plan.decode_slots:
            r = self.sched.running.get(s)
            if r is None or s in seen or not r.decode_ready \
                    or r.cancelled or r.expired(0, self.steps):
                continue
            seen.add(s)
            r.generated += min(self.decode_chunk,
                               r.max_new_tokens - r.generated)
        seen.clear()
        for s in plan.prefill_slots:
            r = self.sched.running.get(s)
            if r is None or r.prefill_done or r.cancelled \
                    or r.expired(0, self.steps):
                continue
            r.prefilled += min(self.prefill_chunk,
                               r.prompt_len - r.prefilled)
            if r.prefill_done:
                if r.generated == 0:
                    r.generated = 1
                self.sched.register_prefix(r)
        for s in [s for s, r in self.sched.running.items()
                  if r.done or r.cancelled or r.failed
                  or r.expired(0, self.steps)]:
            self._finish(self.sched.evict(s))
        self.check_pages()

    # -- invariants -----------------------------------------------------------

    def check_pages(self) -> None:
        from collections import Counter
        owners = Counter(pg for r in self.sched.running.values()
                         for pg in r.pages)
        hostages = Counter(self.alloc.hostages)
        tree_pages = self.tree.pages() if self.tree is not None else set()
        assert KV.SCRATCH_PAGE not in owners, "scratch page owned"
        assert KV.SCRATCH_PAGE not in tree_pages, "scratch page cached"
        for page in set(owners) | tree_pages | set(hostages):
            assert self.alloc.refcount(page) == \
                owners[page] + hostages[page] + (page in tree_pages), (
                    f"page {page}: refcount {self.alloc.refcount(page)} "
                    f"!= {owners[page]} owners + {hostages[page]} "
                    f"hostages + {int(page in tree_pages)} tree refs")
        held = set(owners) | tree_pages | set(hostages)
        assert self.alloc.in_use() == len(held), "page leak"
        assert len(self.sched.running) <= self.sched.max_batch

    def finalize(self) -> None:
        """End-of-schedule assertions: terminal coverage, byte-exact
        survivors, prefix-exact casualties, zero leaked pages."""
        missing = set(self.prompts) - set(self.terminal)
        assert not missing, f"rids never reached a terminal state: {missing}"
        for rid, req in self.terminal.items():
            full = oracle(rid, 0, self.budgets[rid])
            if req.status in EXACT_STATUSES:
                assert len(req.output) == self.budgets[rid], \
                    f"rid {rid}: short output with status {req.status}"
                assert np.array_equal(req.output, full), \
                    f"rid {rid}: survivor tokens diverged"
            else:
                assert np.array_equal(req.output,
                                      full[:len(req.output)]), \
                    f"rid {rid}: casualty tokens not a prefix"
        tree_pages = len(self.tree) if self.tree is not None else 0
        assert self.alloc.in_use() == tree_pages, "leak at drain"
        if self.tree is not None and len(self.tree):
            self.tree.evict(len(self.tree))
            assert len(self.tree) == 0
        assert self.alloc.available() == self.alloc.capacity, \
            "leak after tree drop"
        self.stats["lies"] = self.alloc.lies
        self.stats["dups"] = self.plan_chaos.dups
        self.stats["drops"] = self.plan_chaos.drops


def run_schedule(seed: int) -> dict:
    """One complete randomized fault schedule; returns its stats."""
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([2, 4]))
    sim = ChaosSim(
        rng,
        max_batch=int(rng.integers(1, 4)),
        page_size=page_size,
        # capacity must cover one max_seq request (8 pages + scratch)
        n_pages=int(rng.integers(9, 20)),
        max_seq=page_size * 8,
        decode_chunk=int(rng.integers(1, 4)),
        prefill_chunk=page_size,
        age_limit=int(rng.integers(2, 6)),
        max_retries=int(rng.integers(6, 12)) if rng.random() < 0.3
        else None,
        use_tree=bool(rng.random() < 0.8),
    )
    pool = [rng.integers(0, 97, (page_size * int(k),)).astype(np.int32)
            for k in (1, 2, 3)]
    n_requests = int(rng.integers(6, 20))
    for rid in range(n_requests):
        sim.submit_random(rid, pool)
        if rng.random() < 0.7:
            sim.step(storm=True)
    # the storm keeps raging a while with everything queued...
    for _ in range(int(rng.integers(0, 10))):
        if not sim.sched.has_work:
            break
        sim.step(storm=True)
    # ...then passes: injectors off, hostages home, drain must end
    sim.alloc.lie_rate = 0.0
    sim.alloc.release_hostages()
    budget = 80 * max(n_requests, 1)
    while sim.sched.has_work:
        sim.step(storm=False)
        budget -= 1
        assert budget > 0, (
            f"no drain after the storm passed: "
            f"waiting={[r.rid for r in sim.sched.waiting]} "
            f"running={sorted(sim.sched.running)}")
    sim.finalize()
    sim.stats["rollbacks"] = \
        sim.sched._m_rollbacks.value
    return sim.stats


def run_schedules(n: int, seed: int = 0) -> dict:
    """Run ``n`` independent schedules; returns aggregate stats."""
    total: dict[str, int] = {}
    for i in range(n):
        for k, v in run_schedule(seed + i).items():
            total[k] = total.get(k, 0) + v
    total["schedules"] = n
    return total


def engine_smoke(seed: int = 0, arch: str = "granite-3-8b",
                 device: str = "cuda") -> dict:
    """Real-engine chaos schedule: NaN poisoning, preemption, cancellation
    and TTL expiry in one run, on the reduced ``arch`` in fp32 with random
    weights, differential against the fault-free engine.  Heavy imports
    stay local so ``repro_torch.chaos`` imports without a device."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig

    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (11, 17, 9, 13)]

    def mk(**kw):
        return PagedEngine(cfg, params, PagedServeConfig(
            max_seq=64, max_batch=2, page_size=8, decode_chunk=4,
            device=device, **kw))

    ref = mk().generate(prompts, 8)
    eng = mk(prefix_cache=True, nan_guard=True, preempt=True)
    rids = [eng.submit(p, 8) for p in prompts[:3]]
    rid_ttl = eng.submit(prompts[3], 8, ttl_steps=2)
    done: dict[int, object] = {}
    steps, poisoned, preempted = 0, False, False
    while eng.has_work:
        steps += 1
        for r in eng.step():
            done[r.rid] = r
        running = list(eng.scheduler.running.values())
        if not poisoned and any(r.rid == rids[0] and r.decode_ready
                                for r in running):
            eng.inject_logit_fault(rids[0])
            poisoned = True
        if not preempted and steps >= 2:
            cands = [r for r in running if r.rid != rids[0]
                     and r.max_new_tokens - r.generated > 0]
            if cands:
                assert eng.preempt(max(cands, key=lambda r: r.rid).rid)
                preempted = True
        assert steps < 200, "engine chaos schedule failed to drain"
    assert poisoned and preempted, "schedule missed a fault arm"
    statuses = {}
    for i, rid in enumerate(rids + [rid_ttl]):
        req = done[rid]
        assert req.status is not None, f"rid {rid} not terminal"
        statuses[rid] = req.status
        if req.status in EXACT_STATUSES:
            assert np.array_equal(req.output, ref[i]), \
                f"rid {rid}: survivor tokens diverged"
        else:
            assert np.array_equal(req.output, ref[i][:len(req.output)]), \
                f"rid {rid}: casualty tokens not a prefix"
    assert statuses[rids[0]] is RequestStatus.FAILED
    assert any(s is RequestStatus.PREEMPTED_RETRIED
               for s in statuses.values())
    assert eng.scheduler.allocator.in_use() == len(eng.prefix_cache), \
        "pages leaked past the prefix tree"
    eng.shutdown()
    assert eng.scheduler.allocator.in_use() == 0, "leak after shutdown"
    return {"steps": steps,
            "statuses": {r: s.value for r, s in statuses.items()},
            "nan_trips":
                eng.obs.registry.counter("lifecycle.nan_guard_trips").value}
