"""Port vs JAX: the chaos harness (``repro_torch.chaos``).

The injectors (``FlakyAllocator``, ``PlanChaos``) over the port's
``PageAllocator`` and ``StepPlan``, the randomized fault schedules
(``run_schedule``/``run_schedules``: the production scheduler and prefix
tree under allocator lies, hostage pages, plan duplicates and drops,
cancellations, TTLs and preemptions, every serving invariant asserted at
every step) with stats equal to JAX's for the same seeds, the
real-engine schedule (``engine_smoke``) on the CPU with JAX's statuses,
the 200-schedule acceptance bar and the CLI.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.chaos import engine_smoke as j_engine_smoke
from repro.chaos import run_schedule as j_run_schedule
from repro.chaos import run_schedules as j_run_schedules
from repro.chaos.runner import oracle as j_oracle
from repro_torch.chaos import (FlakyAllocator, PlanChaos, engine_smoke,
                               run_schedule, run_schedules)
from repro_torch.chaos.runner import ChaosSim, oracle
from repro_torch.serve import kv_cache as KV
from repro_torch.serve.scheduler import Request, Scheduler, StepPlan

ROOT = Path(__file__).resolve().parents[1]


# -- injector units ----------------------------------------------------------


def test_oracle_streams_compose_and_equal_jax():
    whole = oracle(5, 0, 10)
    split = np.concatenate([oracle(5, 0, 4), oracle(5, 4, 10)])
    np.testing.assert_array_equal(whole, split)
    assert not np.array_equal(oracle(5, 0, 10), oracle(6, 0, 10))
    for rid in range(4):
        np.testing.assert_array_equal(oracle(rid, 3, 40),
                                      j_oracle(rid, 3, 40))


def test_flaky_allocator_lie_triggers_rollback():
    """An alloc that reneges mid-admission rolls back completely: zero
    leaked pages, the request still queued, admitted the next round."""
    alloc = FlakyAllocator(6, np.random.default_rng(0))
    assert isinstance(alloc, KV.PageAllocator)
    sched = Scheduler(2, 2, alloc, 8)
    sched.submit(Request(0, np.zeros(3, np.int32), 2))
    alloc.fail_next = 1
    assert sched.admit() == []
    assert alloc.lies == 1
    assert alloc.in_use() == 0, "rollback leaked pages"
    assert sched._m_rollbacks.value == 1
    assert [r.rid for r in sched.waiting] == [0]
    assert [r.rid for r in sched.admit()] == [0]


def test_flaky_allocator_lie_rate_and_prefix_share_roll_back():
    """A lie after the prefix tree's pages were shared drops those
    references too: every refcount returns to the tree's own."""
    alloc = FlakyAllocator(12, np.random.default_rng(0))
    tree = KV.PrefixCache(alloc, 2)
    sched = Scheduler(2, 2, alloc, 16, prefix_cache=tree)
    prompt = np.arange(6, dtype=np.int32)
    pages = alloc.alloc_many(3)
    tree.insert(prompt, pages)
    alloc.free_many(pages)                    # only the tree holds them
    sched.submit(Request(0, np.concatenate([prompt, [9]]).astype(np.int32),
                         3))
    alloc.fail_next = 1
    assert sched.admit() == []
    assert [alloc.refcount(p) for p in pages] == [1, 1, 1]
    assert alloc.in_use() == 3
    got = sched.admit()
    assert got and got[0].cached_tokens == 6
    assert [alloc.refcount(p) for p in pages] == [2, 2, 2]


def test_flaky_allocator_hostages_really_hold_pages():
    alloc = FlakyAllocator(6, np.random.default_rng(0))
    assert alloc.take_hostages(3) == 3
    assert alloc.in_use() == 3 and len(alloc.hostages) == 3
    assert alloc.take_hostages(99) == 2          # pool runs dry first
    assert alloc.release_hostages() == 5
    assert alloc.in_use() == 0 and not alloc.hostages
    assert alloc.available() == alloc.capacity


def test_plan_chaos_duplicates_and_drops():
    alloc = KV.PageAllocator(8)
    sched = Scheduler(2, 2, alloc, 8)
    for rid in range(2):
        sched.submit(Request(rid, np.zeros(2, np.int32), 4))
    assert len(sched.admit()) == 2
    for r in sched.running.values():             # force decode-ready
        r.prefilled = r.prompt_len
        r.generated = 1
    dup = PlanChaos(sched, np.random.default_rng(0), dup_rate=1.0)
    plan = dup.plan_step(2, 2)
    assert isinstance(plan, StepPlan)
    assert dup.dups == 2 and len(plan.decode_slots) == 4
    drop = PlanChaos(sched, np.random.default_rng(0), drop_rate=1.0)
    plan = drop.plan_step(2, 2)
    assert drop.drops == 2 and plan.decode_slots == []


def test_chaos_sim_checks_catch_a_leak():
    """The invariant check is not vacuous: a page taken behind the
    scheduler's back fails it."""
    sim = ChaosSim(np.random.default_rng(0))
    sim.check_pages()
    KV.PageAllocator.alloc(sim.alloc)
    with pytest.raises(AssertionError, match="leak"):
        sim.check_pages()


# -- randomized schedules ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 17, 123, 1000, 4242])
def test_run_schedules_equal_jax(seed):
    """``run_schedules(8, seed)``: the same faults injected and the same
    outcomes as JAX's, counter for counter."""
    assert run_schedules(8, seed) == j_run_schedules(8, seed)


@pytest.mark.parametrize("seed", range(6))
def test_run_schedule_equal_jax(seed):
    assert run_schedule(seed) == j_run_schedule(seed)


def test_chaos_schedules_fast_batch():
    """A batch of 30 schedules; each asserts the invariant set itself,
    and the batch is not vacuously clean: every injector fired."""
    stats = run_schedules(30, seed=1000)
    assert stats["schedules"] == 30
    for arm in ("lies", "preempts", "cancels", "dups", "drops",
                "hostage_rounds", "rollbacks"):
        assert stats[arm] > 0, f"fault arm {arm!r} never fired"


@pytest.mark.slow
def test_chaos_schedules_acceptance_bar():
    """The acceptance bar: 200 randomized fault schedules with zero page
    leaks, every request terminal and survivors byte-exact (asserted in
    each schedule), every arm fired, the stats equal to JAX's."""
    stats = run_schedules(200, seed=0)
    assert stats["schedules"] == 200
    for arm in ("lies", "preempts", "cancels", "ttl", "dups", "drops",
                "hostage_rounds", "rejected", "rollbacks"):
        assert stats[arm] > 0, f"fault arm {arm!r} never fired"
    assert stats == j_run_schedules(200, seed=0)


# -- the real engine ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_smoke_statuses_equal_jax(seed):
    """The real-engine schedule on the CPU (NaN poisoning, a forced
    preemption, a TTL, differential against the fault-free engine): the
    same statuses, steps and guard trips as JAX's; its weights are the
    port's own random ones, which decide no status."""
    got = engine_smoke(seed=seed, device="cpu")
    want = j_engine_smoke(seed=seed)
    assert got["statuses"] == {r: s.value if hasattr(s, "value") else s
                               for r, s in want["statuses"].items()}
    assert (got["steps"], got["nan_trips"]) == (want["steps"],
                                                want["nan_trips"])
    assert "failed" in got["statuses"].values()
    assert "preempted_retried" in got["statuses"].values()


def test_engine_smoke_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_smoke()


def test_engine_plan_chaos_is_idempotent():
    """``PlanChaos`` on the engine's planning seam: duplicated decode and
    prefill entries run once, dropped ones run late, and the tokens equal
    the clean run's."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    cfg = dataclasses.replace(get_reduced("granite-3-8b"),
                              dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 19, 11, 26)]

    def mk():
        return PagedEngine(cfg, params, PagedServeConfig(
            max_seq=64, max_batch=3, page_size=8, prefill_chunk=8,
            decode_chunk=2, device="cpu"))
    ref = mk().generate(prompts, 7)
    eng = mk()
    # the wrapper plans through the scheduler's own method, and the
    # engine plans through the wrapper
    inner = types.SimpleNamespace(plan_step=eng.scheduler.plan_step)
    chaos = PlanChaos(inner, np.random.default_rng(0), dup_rate=0.4,
                      drop_rate=0.3)
    eng.scheduler.plan_step = chaos.plan_step
    np.testing.assert_array_equal(eng.generate(prompts, 7), ref)
    assert chaos.dups > 0 and chaos.drops > 0
    assert eng.scheduler.allocator.in_use() == 0


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("args", [["--smoke", "--device", "cpu"],
                                  ["--schedules", "200", "--device", "cpu"]],
                         ids=["smoke", "schedules-200"])
def test_chaos_cli(args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.chaos", *args],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.rstrip().endswith("CHAOS PASS")
    assert "zero page leaks" in res.stdout
    if "--smoke" in args:
        assert "rid 0: failed" in res.stdout
        assert "preempted_retried" in res.stdout
    else:
        assert "200 randomized fault schedules passed" in res.stdout
