"""Port vs JAX: the paged engine's serving features.

The host pieces -- ``PageAllocator.refcount`` and ``PrefixCache`` under
one drawn op sequence, ``reuse_priced_page``, the
``DegradationController`` ladder -- are held to JAX's step by step.  The
engine runs on ``test_torch_serve.py``'s fixture (the reduced
granite-3-8b at fp32, the embedding scaled by 1/10, page 8, prefill
chunk 8) beside JAX's ``PagedEngine`` on the same weights: speculative
decode at k = 2 and 3, the prefix cache (an exact full-page match
forking its page), preempt-and-restore, each unfused, fused, ``w8`` and
``fp8kv``; TTLs, a deadline on an injected clock, cancel,
``max_retries``, the NaN guard, the degradation ladder and
``shutdown``.  Greedy tokens must be identical, and ``spec_stats``,
``prefix_stats`` and ``lifecycle_stats`` equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.quant import QuantizedTensor as JQuantizedTensor
from repro.quant import quantize_params as j_quantize_params
from repro.serve import kv_cache as JKV
from repro.serve import lifecycle as JLC
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import PagedServeConfig as JPagedServeConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import kv_cache as KV
from repro_torch.serve import lifecycle as LC
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from repro_torch.serve.lifecycle import RequestStatus

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
SETTINGS = dict(max_seq=64, max_batch=2, page_size=8, prefill_chunk=8,
                decode_chunk=4)
MODES = ["unfused", "fused", "w8", "fp8kv"]


# ------------------------------ host pieces ---------------------------------


def _tree_ops(kv, alloc_cls, ops, page=2, n_pages=12):
    """Run ``ops`` on an allocator and prefix tree of package ``kv``;
    returns the trace of every op's result and the pool's state after
    it.  Arguments are resolved against the state (owner lists), so one
    op list drives both packages alike."""
    alloc = alloc_cls(n_pages)
    tree = kv.PrefixCache(alloc, page)
    owners: list[tuple[np.ndarray, list[int]]] = []
    trace = []
    for op, a, b in ops:
        if op == "admit":
            toks = np.asarray(a, np.int32)
            matched = tree.match(toks)
            need = kv.num_blocks(len(toks), page) - len(matched)
            if need > alloc.available():
                res = ("full", matched)
            else:
                pages = [alloc.share(p) for p in matched] + \
                    alloc.alloc_many(need)
                owners.append((toks, pages))
                res = ("admitted", pages)
        elif op == "register" and owners:
            toks, pages = owners[a % len(owners)]
            nb = len(toks) // page
            res = tree.insert(toks[:nb * page], pages[:nb])
        elif op == "release" and owners:
            _, pages = owners.pop(a % len(owners))
            alloc.free_many(pages)
            res = "released"
        elif op == "evict":
            protect = (frozenset(owners[b % len(owners)][1])
                       if owners and b % 2 else frozenset())
            res = tree.evict(a, protect=protect)
        else:
            res = None
        trace.append((op, res, alloc.in_use(), alloc.available(),
                      [alloc.refcount(p) for p in range(n_pages)],
                      sorted(tree.pages()), len(tree)))
    return trace


_OP = st.one_of(
    st.tuples(st.just("admit"),
              st.lists(st.integers(0, 2), min_size=1, max_size=9),
              st.just(0)),
    st.tuples(st.sampled_from(["register", "release"]),
              st.integers(0, 7), st.just(0)),
    st.tuples(st.just("evict"), st.integers(0, 4), st.integers(0, 7)))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_OP, min_size=1, max_size=40))
def test_prefix_cache_and_refcount_trace_equal_jax(ops):
    """One drawn sequence of admissions (match, share, allocate),
    registrations, releases and evictions: every result, refcount,
    free count and cached page equal to JAX's, op by op."""
    want = _tree_ops(JKV, JKV.PageAllocator, ops)
    got = _tree_ops(KV, KV.PageAllocator, ops)
    assert got == want
    # no page is both free and referenced, and scratch is never cached
    assert all(0 not in pages for *_, pages, _ in got)


def test_prefix_cache_refusals_equal_jax():
    """The scratch page, unaligned spans, a page under two spans and a
    live owner's page: refused or pinned as in JAX."""
    for kv in (JKV, KV):
        alloc = kv.PageAllocator(4)
        tree = kv.PrefixCache(alloc, 2)
        with pytest.raises(ValueError, match="share"):
            alloc.share(kv.SCRATCH_PAGE)
        page = alloc.alloc()
        with pytest.raises(ValueError, match="scratch"):
            tree.insert(np.array([1, 2], np.int32), [kv.SCRATCH_PAGE])
        with pytest.raises(ValueError, match="aligned"):
            tree.insert(np.array([1, 2, 3], np.int32), [page, page])
        with pytest.raises(ValueError, match="pages"):
            tree.insert(np.array([1, 2], np.int32), [page, page])
        tree.insert(np.array([5, 6], np.int32), [page])
        with pytest.raises(ValueError, match="another span"):
            tree.insert(np.array([7, 8], np.int32), [page])
        assert alloc.refcount(page) == 2 and alloc.refcount(0) == 0
        assert tree.evict(1) == 0           # the live owner pins the page
        alloc.free(page)
        assert tree.evict(1) == 1 and len(tree) == 0
        assert alloc.available() == alloc.capacity


@pytest.mark.parametrize("max_seq", [8, 24, 64, 96, 512, 4096])
@pytest.mark.parametrize("tuned", [1, 8, 16, 32, 64, 128])
def test_reuse_priced_page_equals_jax(tuned, max_seq):
    assert KV.PAGE_OVERHEAD_TOKENS == JKV.PAGE_OVERHEAD_TOKENS
    for rate in (0.0, 0.1, 0.25, 0.5, 0.75, 1.0, 4.0):
        assert KV.reuse_priced_page(tuned, max_seq, rate) == \
            JKV.reuse_priced_page(tuned, max_seq, rate), rate


def test_choose_page_size_prices_the_reuse_hint():
    """``reuse_rate`` re-prices the tuned page: 0 keeps it, 0.5 gives
    ``reuse_priced_page`` of it, and an engine with the prefix cache on
    sizes its page so (``reuse_hint``)."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    base = KV.choose_page_size(cfg, 256)
    assert KV.choose_page_size(cfg, 256, reuse_rate=0.0) == base
    shared = KV.choose_page_size(cfg, 256, reuse_rate=0.5)
    assert shared == KV.reuse_priced_page(base, 256, 0.5) <= base
    assert 256 % shared == 0
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=0, device="cpu")
    eng = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=256, max_batch=2, prefill_chunk=64, prefix_cache=True,
        reuse_hint=0.5, device="cpu"))
    assert eng.page_size == shared


class _Instants:
    def __init__(self):
        self.events = []

    def instant(self, name, cat="serve", args=None):
        self.events.append((name, cat, args))


@pytest.mark.parametrize("seed", range(4))
def test_degradation_controller_levels_equal_jax(seed):
    """The ladder on the same registry inputs -- queue depth, pages in
    use, step latencies -- climbs and recovers exactly as JAX's: level
    by level, counters, gauge and trace instants."""
    rng = np.random.default_rng(seed)
    thr = dict(p99_step_us=2000.0, free_page_frac=0.25, queue_depth=5,
               sustain=2, recover=3)
    regs, ctls, tracers = [], [], []
    for reg_cls, lc in ((JMetricsRegistry, JLC), (MetricsRegistry, LC)):
        reg, tr = reg_cls(), _Instants()
        ctls.append(lc.DegradationController(
            reg, lc.DegradeThresholds(**thr), tracer=tr))
        regs.append(reg)
        tracers.append(tr)
        reg.gauge("pages.capacity").set(32)
    levels = [[], []]
    for _ in range(120):
        q = int(rng.integers(0, 9)) if rng.random() < 0.6 else 0
        use = int(rng.integers(0, 33))
        us = float(rng.choice([10.0, 500.0, 3000.0, 90000.0]))
        for i, (reg, ctl) in enumerate(zip(regs, ctls)):
            reg.gauge("sched.queue_depth").set(q)
            reg.gauge("pages.in_use").set(use)
            reg.histogram("engine.step_us").observe(us)
            levels[i].append(ctl.update())
    assert levels[1] == levels[0]
    assert len(set(levels[1])) > 2, "the inputs never moved the ladder"
    for name in ("degrade.escalations", "degrade.recoveries"):
        assert regs[1].counter(name).value == regs[0].counter(name).value
    assert regs[1].gauge("degrade.level").value == \
        regs[0].gauge("degrade.level").value
    assert tracers[1].events == tracers[0].events
    assert (ctls[1].spec_disabled, ctls[1].shrink_chunk,
            ctls[1].allow_preempt) == (ctls[0].spec_disabled,
                                       ctls[0].shrink_chunk,
                                       ctls[0].allow_preempt)


def test_lifecycle_constants_equal_jax():
    assert [s.value for s in LC.EXACT_STATUSES] == \
        [s.value for s in JLC.EXACT_STATUSES]
    assert [s.value for s in LC.PREFIX_STATUSES] == \
        [s.value for s in JLC.PREFIX_STATUSES]
    assert [s.value for s in RequestStatus] == \
        [s.value for s in JLC.RequestStatus]
    assert dataclasses.asdict(LC.DegradeThresholds()) == \
        dataclasses.asdict(JLC.DegradeThresholds())
    assert LC.DegradationController.LEVELS == \
        JLC.DegradationController.LEVELS


# --------------------------------- engine -----------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    # as in test_torch_serve.py: a smaller embedding lets the blocks
    # steer the argmax, so every decode step carries information
    tree["embed"] = {"embedding": tree["embed"]["embedding"] / 10}
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(cfg, tree, device="cpu")
    jq = j_quantize_params(jparams)

    def leaf(x):
        if isinstance(x, JQuantizedTensor):
            return {"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
        return np.asarray(x)
    qparams = params_from_numpy(cfg, jax.tree.map(
        leaf, jq, is_leaf=lambda x: isinstance(x, JQuantizedTensor)),
        device="cpu")
    return jcfg, jparams, jq, cfg, params, qparams


def engines(model, mode="unfused", **kw):
    """JAX's and the port's engine for a mode, on the same weights."""
    jcfg, jparams, jq, cfg, params, qparams = model
    if mode == "fp8kv":
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=jnp.float8_e4m3fn)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    if mode == "w8":
        jparams, params = jq, qparams
    kw = {**SETTINGS, "fuse": mode == "fused", **kw}
    return (JPagedEngine(jcfg, jparams, JPagedServeConfig(**kw)),
            PagedEngine(cfg, params, PagedServeConfig(**kw, device="cpu")))


def drive(eng, prompts, n_tokens, hook=None, submit_kw=None):
    """Submit, step to the end (``hook(eng, steps, rids)`` after every
    step), and return the finished requests in submission order."""
    submit_kw = submit_kw or [{}] * len(prompts)
    rids = [eng.submit(p, n_tokens, **kw)
            for p, kw in zip(prompts, submit_kw)]
    done, steps = {}, 0
    while eng.has_work:
        steps += 1
        for r in eng.step():
            done[r.rid] = r
        if hook is not None:
            hook(eng, steps, rids)
        assert steps < 400, "the schedule failed to drain"
    return [done[r] for r in rids]


def same(want, got, jeng, eng):
    """Tokens, statuses and every stats view equal to JAX's."""
    for w, g in zip(want, got):
        assert g.status.value == w.status.value, (g.rid, g.status)
        np.testing.assert_array_equal(g.output, w.output)
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.lifecycle_stats() == jeng.lifecycle_stats()
    assert eng.scheduler.allocator.in_use() == \
        jeng.scheduler.allocator.in_use()


def prompts_for(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lens]


def reuse_prompts(cfg, seed=7):
    """A 16-token shared prefix with distinct tails, and two prompts of
    exactly that prefix (2 full pages): the second is an exact full-page
    match, which forks its last page."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab, (16,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab, (k,)).astype(np.int32)
             for k in (5, 3, 7)]
    return [np.concatenate([pre, t]) for t in tails] + [pre.copy(),
                                                        pre.copy()]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [2, 3])
def test_spec_decode_token_identical_to_jax(model, k, mode):
    """Speculative decode at k drafts: tokens, verify calls and accepted
    tokens equal to JAX's, and the tokens equal to plain decode's; the
    prompts repeat their own n-grams, so drafts are accepted."""
    cfg = model[3]
    rng = np.random.default_rng(k)
    motif = rng.integers(0, cfg.vocab, (5,)).astype(np.int32)
    prompts = [np.tile(motif, 4)[:n] for n in (20, 11)] + \
        prompts_for(cfg, k, (9, 30))
    jeng, eng = engines(model, mode, spec_decode=k)
    want, got = drive(jeng, prompts, 12), drive(eng, prompts, 12)
    same(want, got, jeng, eng)
    st = eng.spec_stats()
    assert st["verify_calls"] > 0 and st["tokens"] >= st["verify_calls"]
    _, plain = engines(model, mode)
    for g, p in zip(got, drive(plain, prompts, 12)):
        np.testing.assert_array_equal(g.output, p.output)


@pytest.mark.parametrize("mode", MODES)
def test_prefix_cache_token_identical_to_jax(model, mode, monkeypatch):
    """The prefix cache on a shared-prefix workload: tokens and
    ``prefix_stats`` equal to JAX's (hits, tokens saved), a copy-on-
    write fork for each of the two exact full-page matches, and the
    tokens of the cache off."""
    cfg = model[3]
    forks = []
    real = KV.fork_page
    monkeypatch.setattr(KV, "fork_page",
                        lambda cache, s, d: (forks.append((s, d)),
                                             real(cache, s, d)))
    prompts = reuse_prompts(cfg)
    jeng, eng = engines(model, mode, prefix_cache=True)
    want, got = drive(jeng, prompts, 10), drive(eng, prompts, 10)
    same(want, got, jeng, eng)
    st = eng.prefix_stats()
    assert st["hits"] > 0 and st["tokens_saved"] > 0
    assert len(forks) == 2 and all(s != d for s, d in forks)
    _, off = engines(model, mode)
    for g, p in zip(got, drive(off, prompts, 10)):
        np.testing.assert_array_equal(g.output, p.output)


@pytest.mark.parametrize("mode", MODES)
def test_prefix_cache_with_spec_decode_matches_jax(model, mode):
    """Both at once: a prefix hit's history row must hold the cached
    prefix the span path never fed, or the drafts (and the stats)
    differ from JAX's."""
    cfg = model[3]
    prompts = reuse_prompts(cfg, seed=8)
    jeng, eng = engines(model, mode, prefix_cache=True, spec_decode=2)
    same(drive(jeng, prompts, 10), drive(eng, prompts, 10), jeng, eng)
    assert eng.prefix_stats()["hits"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("at_step", [1, 3])
def test_preempt_restore_token_identical_to_jax(model, mode, at_step):
    """A forced preemption at a step: the victim is restored through the
    prefix cache and finishes PREEMPTED_RETRIED with the undisturbed
    tokens, exactly as in JAX; the pool holds only the tree's pages."""
    cfg = model[3]
    prompts = prompts_for(cfg, 11, (11, 7, 14))
    target = []

    def hook(eng, steps, rids):
        if steps >= at_step and len(target) < 2:
            cands = [r for r in eng.scheduler.running.values()
                     if r.max_new_tokens - r.generated > 0]
            if cands:
                target.append(max(cands, key=lambda r: r.rid).rid)
                assert eng.preempt(target[-1])
    jeng, eng = engines(model, mode, preempt=True, prefix_cache=True)
    want = drive(jeng, prompts, 10, hook)
    target.clear()
    got = drive(eng, prompts, 10, hook)
    same(want, got, jeng, eng)
    assert got[target[0]].status is RequestStatus.PREEMPTED_RETRIED
    assert eng.lifecycle_stats()["preemptions"] >= 1
    assert eng.scheduler.allocator.in_use() == len(eng.prefix_cache)
    _, plain = engines(model, mode)
    for g, p in zip(got, drive(plain, prompts, 10)):
        np.testing.assert_array_equal(g.output, p.output)


def test_preempt_under_pressure_matches_jax(model):
    """The pressure path: a pool too small for the queue preempts the
    starving head's victim itself (``preempt=True``, no forced call),
    as in JAX, victims restored byte-exact.  (At 6 or 8 pools pages both
    engines preempt the same two requests in turn and never drain.)"""
    cfg = model[3]
    prompts = prompts_for(cfg, 12, (20, 9, 15, 12, 8))
    jeng, eng = engines(model, preempt=True, prefix_cache=True, n_pages=10,
                        age_limit=2)
    pr = [{"priority": p} for p in (0, 1, 0, 1, 0)]
    want = drive(jeng, prompts, 14, submit_kw=pr)
    got = drive(eng, prompts, 14, submit_kw=pr)
    same(want, got, jeng, eng)
    assert eng.lifecycle_stats()["preemptions"] > 0


class _Clock:
    """A deterministic engine clock: 1 ms a reading."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        self.ns += 1_000_000
        return self.ns


def test_ttl_deadline_and_cancel_match_jax(model):
    """One run, four outcomes, on an injected clock: an undisturbed
    request OK; a cancelled one TRUNCATED with a prefix of its tokens;
    a deadline that passes mid-run, a TTL'd request queued behind the
    full batch and a deadline already past DEADLINE_EXCEEDED -- each as
    in JAX."""
    cfg = model[3]
    prompts = prompts_for(cfg, 0, (9, 12, 7, 10, 13))
    cancelled = []

    def hook(eng, steps, rids):
        if not cancelled and any(r.rid == rids[1] and r.decode_ready
                                 for r in eng.scheduler.running.values()):
            assert eng.cancel(rids[1])
            cancelled.append(steps)
    kw = [{"deadline_s": 0.006}, {}, {"ttl_steps": 1}, {"deadline_s": 0.0},
          {}]
    runs = []
    for eng in engines(model):
        eng._clock = _Clock()
        cancelled.clear()
        runs.append(drive(eng, prompts, 8, hook, submit_kw=kw))
    want, got = runs
    statuses = [r.status for r in got]
    assert statuses[4] is RequestStatus.OK
    assert statuses[1] is RequestStatus.TRUNCATED
    assert 0 < len(got[1].output) < 8
    assert [statuses[i] for i in (0, 2, 3)] == \
        [RequestStatus.DEADLINE_EXCEEDED] * 3
    assert 0 < len(got[0].output) < 8, "the deadline did not pass mid-run"
    for w, g in zip(want, got):
        assert g.status.value == w.status.value
        np.testing.assert_array_equal(g.output, w.output)


def test_ttl_deadline_cancel_stats_match_jax(model):
    """The same schedule's ``lifecycle_stats`` equal to JAX's."""
    cfg = model[3]
    prompts = prompts_for(cfg, 1, (9, 12, 7))
    kw = [{"ttl_steps": 3}, {"deadline_s": 0.002}, {}]
    stats = []
    for eng in engines(model, nan_guard=True):
        eng._clock = _Clock()
        drive(eng, prompts, 8, submit_kw=kw)
        assert eng.cancel(99) is False
        stats.append(eng.lifecycle_stats())
    assert stats[1] == stats[0]
    assert stats[1]["deadline_exceeded"] >= 1


def test_max_retries_fail_hopeless_requests_as_jax(model):
    """With ``max_retries``, requests that keep losing the admission
    probe to a page hog go FAILED with no tokens; the hog is untouched."""
    cfg = model[3]
    rng = np.random.default_rng(4)
    hog = rng.integers(0, cfg.vocab, (8,)).astype(np.int32)
    prompts = [hog] + [rng.integers(0, cfg.vocab, (9,)).astype(np.int32)
                       for _ in range(3)]
    runs = []
    for eng in engines(model, n_pages=9, max_retries=2):
        rids = [eng.submit(hog, 48)] + [eng.submit(p, 8)
                                        for p in prompts[1:]]
        done = {}
        while eng.has_work:
            for r in eng.step():
                done[r.rid] = r
        runs.append(([done[r] for r in rids], eng))
    (want, jeng), (got, eng) = runs
    same(want, got, jeng, eng)
    assert got[0].status is RequestStatus.OK
    assert [r.status for r in got[1:]] == [RequestStatus.FAILED] * 3
    assert all(len(r.output) == 0 and r.retries > 2 for r in got[1:])


@pytest.mark.parametrize("spec", [0, 2])
@pytest.mark.parametrize("mode", ["unfused", "fused"])
def test_nan_guard_isolates_the_poisoned_request_as_jax(model, mode, spec):
    """A NaN injected into one request's logits fails it alone (its
    clean tokens a prefix of the undisturbed run), the others finish OK
    and byte-exact, and the trips count as in JAX; through the plain and
    the verify decode."""
    cfg = model[3]
    prompts = prompts_for(cfg, 3, (10, 13, 8))
    poisoned = []

    def hook(eng, steps, rids):
        if not poisoned and any(r.rid == rids[0] and r.decode_ready
                                for r in eng.scheduler.running.values()):
            eng.inject_logit_fault(rids[0])
            poisoned.append(steps)
    jeng, eng = engines(model, mode, nan_guard=True, spec_decode=spec)
    want = drive(jeng, prompts, 8, hook)
    poisoned.clear()
    got = drive(eng, prompts, 8, hook)
    same(want, got, jeng, eng)
    assert got[0].status is RequestStatus.FAILED and len(got[0].output) < 8
    assert [r.status for r in got[1:]] == [RequestStatus.OK] * 2
    assert eng.lifecycle_stats()["nan_guard_trips"] >= 1
    _, plain = engines(model, mode)
    ref = drive(plain, prompts, 8)
    np.testing.assert_array_equal(got[0].output,
                                  ref[0].output[:len(got[0].output)])


def test_nan_guard_fails_a_poisoned_join_and_chunk(model):
    """Poison already on the slot when the next request joins (a
    whole-prompt join) or prefills in chunks: the guard reads the flag
    after the call and fails that request with no tokens, as JAX's."""
    cfg = model[3]
    prompts = prompts_for(cfg, 5, (6, 20, 5))
    outs = []
    for eng in engines(model, nan_guard=True, max_batch=1):
        rids = [eng.submit(p, n) for p, n in zip(prompts, (12, 4, 4))]
        eng.step()                          # the first request joins
        eng.inject_logit_fault(rids[0], float("inf"))
        eng._poison_host[0] = 0.0           # the slot keeps its poison
        done = {}
        while eng.has_work:
            for r in eng.step():
                done[r.rid] = r
        outs.append([(done[r].status.value, done[r].output.tolist())
                     for r in rids] + [eng.lifecycle_stats()])
    assert outs[1] == outs[0]
    assert [s for s, _ in outs[1][:3]] == ["failed"] * 3
    assert outs[1][3]["nan_guard_trips"] >= 3


def test_inject_logit_fault_needs_the_guard(model):
    _, eng = engines(model)
    with pytest.raises(RuntimeError, match="nan_guard"):
        eng.inject_logit_fault(0)
    _, eng = engines(model, nan_guard=True)
    with pytest.raises(KeyError):
        eng.inject_logit_fault(5)


@pytest.mark.parametrize("option", ["spec_decode", "preempt"])
def test_greedy_only_options_refuse_sampling(model, option):
    cfg, params = model[3], model[4]
    with pytest.raises(ValueError, match="greedy"):
        PagedEngine(cfg, params, PagedServeConfig(
            max_seq=32, max_batch=1, temperature=0.5, device="cpu",
            **{option: 2 if option == "spec_decode" else True}))


def test_nan_guard_under_sampling_keeps_the_draw_order(model):
    """The guard works under sampling: a clean run with the guard on
    draws the same tokens as with it off (the generator's order is
    kept), and a poisoned request fails alone."""
    cfg, params = model[3], model[4]
    prompts = prompts_for(cfg, 9, (10, 13))

    def mk(**kw):
        return PagedEngine(cfg, params, PagedServeConfig(
            **SETTINGS, temperature=0.8, seed=3, device="cpu", **kw))
    off = drive(mk(), prompts, 8)
    on = drive(mk(nan_guard=True), prompts, 8)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.output, b.output)
    poisoned = []

    def hook(eng, steps, rids):
        if not poisoned and eng.scheduler.running.get(0) is not None \
                and eng.scheduler.running[0].decode_ready:
            eng.inject_logit_fault(eng.scheduler.running[0].rid)
            poisoned.append(eng.scheduler.running[0].rid)
    got = drive(mk(nan_guard=True), prompts, 8, hook)
    by = {r.rid: r.status for r in got}
    assert by[poisoned[0]] is RequestStatus.FAILED
    assert list(by.values()).count(RequestStatus.OK) == 1


@pytest.mark.parametrize("spec", [0, 2])
def test_degradation_ladder_matches_jax(model, spec):
    """A queue-heavy workload pushes the ladder up: tokens, statuses,
    the level, escalations and (with speculative decode, which the
    first rung turns off) the verify counters equal to JAX's."""
    cfg = model[3]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rng.integers(6, 12, 14)]
    jeng, eng = engines(model, degrade=True, spec_decode=spec)
    want, got = drive(jeng, prompts, 8), drive(eng, prompts, 8)
    same(want, got, jeng, eng)
    st = eng.lifecycle_stats()
    assert st["degrade_escalations"] >= 1
    assert st["ok"] + st["preempted_retried"] == len(prompts)


def test_shutdown_drains_and_frees_everything_as_jax(model):
    """The Ctrl-C path: after a few steps, ``shutdown`` cancels all
    in-flight work, every request ends TRUNCATED (or OK) with JAX's
    tokens, and the pool returns to empty."""
    cfg = model[3]
    prompts = prompts_for(cfg, 6, (9, 11, 30))
    outs = []
    for eng in engines(model, prefix_cache=True):
        for p in prompts:
            eng.submit(p, 16)
        for _ in range(3):
            eng.step()
        reqs = sorted(eng.shutdown(), key=lambda r: r.rid)
        assert not eng.has_work
        assert eng.scheduler.allocator.in_use() == 0, "pages leaked"
        outs.append([(r.rid, r.status.value, r.output.tolist())
                     for r in reqs] + [eng.lifecycle_stats()])
    assert outs[1] == outs[0]
    assert {s for _, s, _ in outs[1][:-1]} <= {"truncated", "ok"}


def test_generate_takes_priorities_deadline_and_ttl(model):
    """``generate(priorities=, deadline_s=, ttl_steps=)`` as JAX's: a TTL
    of 2 steps over four requests in two slots cuts the queued ones."""
    cfg = model[3]
    prompts = prompts_for(cfg, 2, (9, 10, 11, 12))
    res = [eng.generate(prompts, 6, priorities=[1, 0, 1, 0],
                        deadline_s=60.0, ttl_steps=2, return_requests=True)
           for eng in engines(model, preempt=True)]
    for w, g in zip(*res):
        assert g.status.value == w.status.value and g.priority == w.priority
        np.testing.assert_array_equal(g.output, w.output)
    assert RequestStatus.DEADLINE_EXCEEDED in {r.status for r in res[1]}


def test_last_step_tokens_match_jax(model):
    """The benchmark counter: tokens emitted a step, step by step."""
    cfg = model[3]
    prompts = prompts_for(cfg, 13, (9, 20, 5))
    seqs = []
    for eng in engines(model, spec_decode=2, prefix_cache=True):
        for p in prompts:
            eng.submit(p, 9)
        seq = []
        while eng.has_work:
            eng.step()
            seq.append(eng.last_step_tokens)
        seqs.append(seq)
    assert seqs[1] == seqs[0] and sum(seqs[1]) == 27


def test_serve_cli_takes_every_new_flag(tmp_path):
    """The launcher with JAX's serving-feature flags on the CPU: the
    spec, prefix-cache and lifecycle sections print, every request
    ends OK."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--dtype", "float32",
         "--requests", "4", "--prompt-len", "20", "--gen", "6",
         "--max-seq", "64", "--batch", "2", "--prefill-chunk", "8",
         "--spec", "2", "--prefix-cache", "--reuse-hint", "0.5",
         "--deadline", "600", "--preempt", "--nan-guard", "--degrade"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "spec=2 " in out
    for key in ("spec.verify_calls", "prefix_cache.lookups",
                "lifecycle.ok", "lifecycle.nan_guard_trips",
                "lifecycle.degrade_level"):
        assert key in out, key
    assert "statuses: ok" in out
