"""Serving engines: the static-batch baseline and paged continuous
batching (the port of ``repro.serve.engine``).

:class:`DecodeEngine` is the static batch (JAX's default engine): one
prefill of the whole ``(B, S0)`` batch into the dense per-layer caches
(a ring buffer of ``window`` slots for a local layer), then a Python
loop of ``transformer.decode_step`` over those caches, one token for
every row a step, sampled on the device from an explicit generator
seeded with ``seed``; the tokens reach the host once, at the end.
``fuse=True`` runs both under ``ops.fused_ops``, as in JAX: the QKV
projection as one ``qkv_fused`` pass, the MLP as ``matmul_fused``
GEMMs, ``wo`` through ``ops.linear``.  Quantized weights and an fp8
cache compose (``layers.attention_decode`` widens the cache to fp32).

:class:`PagedEngine` is the paged path.  A prompt enters through
:meth:`PagedEngine.submit`; each :meth:`PagedEngine.step` runs one
decode-priority iteration of the scheduler's plan:

* **admission** — a request that fits one prefill chunk (or every
  request, with ``prefill_chunk=0``) joins whole: ``transformer.prefill``
  at its power-of-two bucket, K/V scattered into its reserved pages,
  first token sampled (the flash-attention kernel);
* **decode** — ONE chunk of up to ``decode_chunk`` steps over every
  decode-ready slot, with per-slot activity masked inside the chunk and
  inactive slots' block-table rows and lengths masked to the scratch page
  (the flash-decode kernel, one token per request);
* **chunked prefill** — longer prompts advance ``prefill_chunk`` tokens
  at a time as one multi-position span over the paged cache (the
  flash-decode kernel with ``q_span`` = the span's pow2 width);
* **eviction** — finished requests read back their tokens and free
  their pages.

All device state (pools, block tables, lengths, current tokens, output
buffer) lives on the engine's device and is updated in place; the host
reads the output buffer back only when a request finishes.

The page size and the prefill chunk come from the blocking model when
left unset (``kv_cache.choose_page_size`` / ``choose_prefill_chunk``).

``fuse=True`` runs every model call under ``ops.fused_ops``: the QKV
projection as one ``qkv_fused`` pass, the MLP as epilogue-fused
``matmul_fused`` GEMMs and single-token decode as ``flash_decode_oproj``
(attention with the output projection fused in), with the page sized
under that kernel's key.

The paged engine ports every option of JAX's:

* **prefix cache** (``prefix_cache=True``) -- a radix tree over
  full-page token spans (``kv_cache.PrefixCache``) is threaded through
  admission: a request whose prompt prefix is cached shares the matched
  pages and prefills only the tail from the matched boundary through
  the span path (a tail that fits one chunk prefills inline, at
  admission); an exact full-page match copies its final page first
  (``kv_cache.fork_page``, copy on write) and re-runs the last prompt
  token for the first-sample logits.  Prefilled prompts register their
  full pages in the tree;
* **speculative decode** (``spec_decode=k``, greedy only) -- each step
  drafts ``k`` tokens by n-gram lookup over the slot's own history on
  the device (the ``(max_batch, max_seq)`` history buffer), scores the
  current token and the drafts in ONE span ``decode_step`` at
  B = max_batch, ``q_span`` = k + 1 (the flash-decode kernel), and
  accepts the longest prefix that matches the argmax chain, so the
  tokens are those of plain greedy decode;
* **lifecycle** -- every request ends with a terminal
  :class:`~repro_torch.serve.lifecycle.RequestStatus`: deadlines
  (``submit(deadline_s=)``, on the injectable ``_clock``) and TTLs
  (``ttl_steps``) expire it, :meth:`PagedEngine.cancel` truncates it,
  exhausted admission retries (``max_retries``) or the NaN/Inf guard
  (``nan_guard=True``: a per-slot ``isfinite`` inside the decode chunk
  that freezes only the poisoned slot, read back once a chunk) fail it,
  and under page pressure (``preempt=True``, greedy only) the scheduler
  preempts it and restores it later through the prefix cache with
  byte-exact tokens; a
  :class:`~repro_torch.serve.lifecycle.DegradationController`
  (``degrade=True``) turns speculative decode off, halves the decode
  chunk and finally enables preemption as pressure mounts.

Every family of decoder-only token models serves here (the
encoder-decoder and vision-prefix families only through
:class:`DecodeEngine`, as in JAX).  A stack with RG-LRU or SSD mixers
keeps their O(1) states per slot beside the pools; it prefills at exact
lengths (:func:`default_buckets` is None: a right-padded prompt would
fold its pad into the state), and chunked prefill, speculative decode
and the prefix cache are off for it (spans over the cache are
attention-only), as JAX gates them; a preempted request is then
restored by replaying it in full.  Each decode step advances every
slot's state, idle slots too, as JAX's body does, and an MoE layer
routes all ``max_batch`` slots' tokens together, so its capacity is the
whole batch's: the tokens stay JAX's.

None of these has a kernel of its own (in JAX neither): the fork is one
page copied in every layer's pools, the drafting and the guard are
tensor ops on the engine's device, and the verify span and the prefix
tails run the flash-decode kernel (row 1, or row 2 over an fp8 pool).

Both engines take an ``obs`` bundle (:class:`repro_torch.obs.Obs`; a
private one when none is given, tracer off): the metrics registry
(:attr:`metrics`), the DRAM ledger, whose scopes tag every device
dispatch with JAX's tags (``static_prefill[S0]``,
``static_generate[n]``, ``setup``, ``join[bucket]``, ``prefill[C]``,
``decode[chunk]``, ``spec_decode[iters]``, ``cow_fork``) and whose
``end_step`` closes each step, and an optional Chrome-trace tracer.
With a tracer attached the step's phases emit spans and each dispatch
scope ends with :func:`device_fence` (``torch.cuda.synchronize``), so
spans and the profiler's scopes time the device's work; with none, no
fence runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Obs
from repro_torch.obs.trace import null_span
from repro_torch.serve import kv_cache as KV
from repro_torch.serve.lifecycle import DegradationController, RequestStatus
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.util import resolve_device


def device_fence(device: torch.device) -> None:
    """Wait for the device's queued work (a CPU device has none): the
    engines call it only with a tracer attached."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample_tokens(cfg: ModelConfig, logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Greedy (temperature <= 0) or categorical sampling; masks the
    padded-vocab tail.  logits: (B, V_padded) -> (B,) int32."""
    logits = logits[:, :cfg.vocab]
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


# ========================= static-batch baseline ===========================


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    temperature: float = 0.0   # 0 -> greedy
    seed: int = 0
    fuse: bool = False         # the cross-op fused kernels
    use_kernel: bool = True    # False: the plain versions, on purpose
    device: str = "cuda"       # "cpu" runs the plain versions


class DecodeEngine:
    """Static batch: every request prefills together (the prompts share
    one length S0) and decodes in lock-step for a fixed token budget.
    Counters ``engine.prefill_tokens`` and ``engine.decode_tokens`` in
    :attr:`metrics` (``obs.registry``)."""

    def __init__(self, cfg: ModelConfig, params: Any, sc: ServeConfig,
                 obs: Obs | None = None):
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = resolve_device(sc.device)
        _check_params_device(params, self.device)
        self.obs = obs if obs is not None else Obs()
        self.metrics = reg = self.obs.registry
        self._m_prefill_tokens = reg.counter("engine.prefill_tokens")
        self._m_decode_tokens = reg.counter("engine.decode_tokens")

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 enc_embeds=None, prefix_embeds=None) -> np.ndarray:
        """prompts: (B, S0) int32.  Returns (B, n_tokens) int32: the
        first token sampled from the prefill's logits, each later one
        from a decode step at positions P + S0, P + S0 + 1, ..., P the
        prefix's length.  ``enc_embeds`` (B, Se, D), the
        encoder-decoder's frontend embeddings, and ``prefix_embeds`` (B,
        P, D), the vision-prefix family's, are numpy arrays or tensors,
        taken in the model dtype.  The global layers' caches hold
        ``max_seq`` positions, so P + S0 + n_tokens - 1 must not exceed
        it."""
        cfg, sc = self.cfg, self.sc
        prompts = np.asarray(prompts, np.int32)
        b, s0 = prompts.shape
        extras = {k: torch.as_tensor(v).to(self.device, cfg.dtype)
                  for k, v in (("enc_embeds", enc_embeds),
                               ("prefix_embeds", prefix_embeds))
                  if v is not None}
        start = s0 + (extras["prefix_embeds"].shape[1]
                      if "prefix_embeds" in extras else 0)
        if n_tokens < 1 or start + n_tokens - 1 > sc.max_seq:
            raise ValueError(f"{start} prompt positions and {n_tokens} new "
                             f"tokens do not fit max_seq {sc.max_seq}")
        gen = torch.Generator(device=self.device).manual_seed(sc.seed)
        kw = dict(use_kernel=sc.use_kernel)
        tr = self.obs.tracer
        sp = tr.span if tr is not None else null_span
        with torch.no_grad(), ops.fused_ops(sc.fuse):
            with sp("prefill", cat="static"), \
                    self.obs.dram.scope(f"static_prefill[{s0}]"):
                logits, cache = T.prefill(
                    cfg, self.params,
                    torch.from_numpy(prompts).to(self.device),
                    max_seq=sc.max_seq, **extras, **kw)
                tok = sample_tokens(cfg, logits, sc.temperature, gen)
                if tr is not None:
                    device_fence(self.device)
            out = [tok]
            with sp("decode", cat="static"), \
                    self.obs.dram.scope(f"static_generate[{n_tokens}]"):
                for pos in range(start, start + n_tokens - 1):
                    logits, cache = T.decode_step(cfg, self.params, tok,
                                                  cache, pos, **kw)
                    tok = sample_tokens(cfg, logits, sc.temperature, gen)
                    out.append(tok)
                if tr is not None:
                    device_fence(self.device)
        with sp("readback", cat="static"):
            host = torch.stack(out, dim=1).cpu().numpy()
        self._m_prefill_tokens.inc(b * s0)
        self._m_decode_tokens.inc(b * n_tokens)
        self.obs.dram.end_step(range(b))
        return host


def _check_params_device(params: Any, device: torch.device) -> None:
    if params["embed"]["embedding"].device.type != device.type:
        raise ValueError(
            f"params are on {params['embed']['embedding'].device}, the "
            f"engine on {device}")


# ======================== paged continuous batching ========================




@dataclasses.dataclass
class PagedServeConfig:
    max_seq: int = 1024            # per-request prompt + generation cap
    max_batch: int = 8             # decode batch slots
    page_size: int | None = None   # None -> tuned ("flash_decode" key)
    n_pages: int | None = None     # None -> max_batch full sequences + 1
    temperature: float = 0.0
    seed: int = 0
    buckets: tuple[int, ...] | None = None   # prefill padding lengths
    decode_chunk: int = 8          # decode steps per scheduler visit
    prefill_chunk: int | None = None   # None -> auto-sized; 0 -> whole-
    #                                    prompt joins
    spec_decode: int = 0           # draft tokens per verify step (0 = off;
    #                                greedy only, attention-only stacks)
    prefix_cache: bool = False     # radix-tree prefix sharing across
    #                                requests (attention-only stacks with
    #                                chunked prefill)
    reuse_hint: float = 0.5        # expected prompt-reuse rate: prices the
    #                                share-against-stream page size when
    #                                the prefix cache is on
    age_limit: int = 8             # admission rounds before a waiting head
    #                                suspends backfill (anti-starvation)
    use_kernel: bool = True        # False: the plain versions, on purpose
    device: str = "cuda"           # "cpu" runs the plain versions
    fuse: bool = False             # the cross-op fused kernels
    # -- lifecycle -----------------------------------------------------------
    nan_guard: bool = False        # per-slot non-finite logit detection:
    #                                fails only the poisoned request, at the
    #                                cost of one readback per decode chunk
    preempt: bool = False          # preempt-with-restore when the waiting
    #                                head starves (greedy only; rung 3 of
    #                                the degradation ladder enables it too)
    degrade: bool = False          # graceful-degradation ladder controller
    max_retries: int | None = None  # admission probe failures before a
    #                                 queued request is FAILED (None = never)


def default_buckets(cfg: ModelConfig,
                    max_seq: int) -> tuple[int, ...] | None:
    """Prefill length buckets: powers of two from 8, capped by max_seq,
    for attention-only stacks (right-padding is safe there: causal
    attention ignores the tail, and the pad positions' K/V stay masked
    by the length until decode overwrites each slot in order).  RG-LRU
    and SSD mixers fold every position into their O(1) state, so
    right-padding would corrupt it: those stacks prefill at exact
    lengths (None), as in JAX."""
    if not T.attention_only(cfg):
        return None
    out, b = [], 8
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(sorted(set(out)))


class PagedEngine:
    """Request/response serving over the paged cache.

    ``submit()`` enqueues a prompt; ``step()`` runs one scheduler
    iteration and returns the requests that finished; ``generate()`` is
    the batch convenience wrapper.  Page reservations are made in full
    at admission, which keeps block tables stable across a decode chunk.
    """

    def __init__(self, cfg: ModelConfig, params: Any, sc: PagedServeConfig,
                 obs: Obs | None = None):
        if cfg.is_encdec or cfg.prefix_tokens:
            raise NotImplementedError(
                "paged serving covers decoder-only token models")
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = resolve_device(sc.device)
        _check_params_device(params, self.device)
        self.obs = obs if obs is not None else Obs()
        # chunked prefill, speculative decode and the prefix cache are
        # spans over the cache: attention-only stacks (the RG-LRU and SSD
        # updates are one-token), as in JAX
        has_attn = bool(T.attention_layers(cfg))
        attn_only = T.attention_only(cfg)
        reuse = ((sc.reuse_hint or None) if sc.prefix_cache and attn_only
                 else None)
        with self.obs.dram.scope("setup"):
            # the page choice resolves the decode key once, here --
            # attributed to "setup", not to a step
            self.page_size = sc.page_size or (
                KV.choose_page_size(cfg, sc.max_seq, fused=sc.fuse,
                                    reuse_rate=reuse) if has_attn
                else min(sc.max_seq, 128))   # attention-free: pages unused
        self.max_blocks = KV.num_blocks(sc.max_seq, self.page_size)
        n_pages = sc.n_pages or sc.max_batch * self.max_blocks + 1
        self.cache = KV.init_paged_cache(cfg, sc.max_batch, n_pages,
                                         self.page_size, self.device)
        self.buckets = (sc.buckets if sc.buckets is not None
                        else default_buckets(cfg, sc.max_seq))
        if sc.prefill_chunk is None:
            self.prefill_chunk = (KV.choose_prefill_chunk(
                cfg, sc.max_seq, self.page_size) if attn_only else 0)
        elif sc.prefill_chunk and attn_only:
            # snap an explicit chunk to a whole number of pages
            self.prefill_chunk = min(sc.max_seq, KV.num_blocks(
                sc.prefill_chunk, self.page_size) * self.page_size)
        else:
            self.prefill_chunk = 0
        if sc.page_size is None or sc.prefill_chunk is None:
            print(f"PagedEngine: page {self.page_size}, prefill chunk "
                  f"{self.prefill_chunk} (blocking model, max_seq "
                  f"{sc.max_seq}{', fused' if sc.fuse else ''})")
        self.spec = int(sc.spec_decode or 0) if attn_only else 0
        if self.spec and sc.temperature > 0:
            raise ValueError(
                "spec_decode is greedy-only: draft acceptance compares "
                "against the argmax chain, which sampling would break")
        if sc.preempt and sc.temperature > 0:
            raise ValueError(
                "preempt is greedy-only: restoring a preempted request "
                "replays its tail deterministically, which sampling "
                "would break (byte-exactness is the correctness bar)")
        # the prefix cache resumes prefill at the matched boundary through
        # the span path, so prefill_chunk=0 turns it off
        self.prefix_caching = (bool(sc.prefix_cache) and attn_only
                               and self.prefill_chunk > 0)

        self.metrics = reg = self.obs.registry
        reg.gauge("engine.page_size").set(self.page_size)
        reg.gauge("engine.prefill_chunk").set(self.prefill_chunk)
        allocator = KV.PageAllocator(n_pages, metrics=reg)
        self.prefix_cache = (KV.PrefixCache(allocator, self.page_size,
                                            metrics=reg)
                             if self.prefix_caching else None)
        self.scheduler = Scheduler(sc.max_batch, self.page_size, allocator,
                                   sc.max_seq, age_limit=sc.age_limit,
                                   prefix_cache=self.prefix_cache,
                                   metrics=reg, max_retries=sc.max_retries)
        self.degrade = (DegradationController(reg, tracer=self.obs.tracer)
                        if sc.degrade else None)

        b, dev = sc.max_batch, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._block_tables = torch.zeros((b, self.max_blocks), **i32)
        self._lengths = torch.zeros(b, **i32)      # cached tokens per slot
        self._cur_tok = torch.zeros(b, **i32)
        # the output and history (prompt + tokens) rows take one column
        # past max_seq: the writes JAX drops land there
        self._out_buf = torch.zeros((b, sc.max_seq + 1), **i32)
        self._hist = torch.zeros((b, sc.max_seq + 1), **i32)
        self._gen = torch.Generator(device=dev).manual_seed(sc.seed)
        # chaos seam: added to every logit a slot produces (nan_guard
        # reads it; the host mirror skips no-op device updates)
        self._poison = torch.zeros(b, dtype=torch.float32, device=dev)
        self._poison_host = np.zeros(b, np.float64)
        self._clock = time.monotonic_ns    # injectable for deterministic tests
        self._sched_steps = 0              # TTL / expiry step counter
        self._next_rid = 0
        self.last_step_tokens = 0          # tokens emitted by the last step
        self._m_steps = reg.counter("engine.steps")
        self._m_step_us = reg.histogram("engine.step_us")
        self._m_decode_tokens = reg.counter("engine.decode_tokens")
        self._m_prefill_tokens = reg.counter("engine.prefill_tokens")
        # model calls by kind: each runs every layer's attention kernel
        # once (joins: flash_attention; prefill chunks and verify steps:
        # flash_decode; decode steps: flash_decode, or flash_decode_oproj
        # under fuse)
        self._m_joins = reg.counter("engine.joins")
        self._m_decode_steps = reg.counter("engine.decode_steps")
        self._m_prefill_chunks = reg.counter("engine.prefill_chunks")
        self._m_verify_steps = reg.counter("engine.verify_steps")
        # registry-backed counters (spec_stats/prefix_stats are views)
        self._m_spec_calls = reg.counter("spec.verify_calls")
        self._m_spec_tokens = reg.counter("spec.tokens")
        self._m_prefix_lookups = reg.counter("prefix_cache.lookups")
        self._m_prefix_hits = reg.counter("prefix_cache.hits")
        self._m_prefix_saved = reg.counter("prefix_cache.tokens_saved")
        self._m_status = {s: reg.counter(f"lifecycle.{s.value}")
                          for s in RequestStatus}
        self._m_nan_trips = reg.counter("lifecycle.nan_guard_trips")

    # -- request API ----------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               priority: int = 0, deadline_s: float | None = None,
               ttl_steps: int | None = None) -> int:
        """Enqueue one prompt; returns the request id.

        ``deadline_s`` is a wall budget from now (engine clock),
        ``ttl_steps`` a budget in scheduler steps; whichever passes
        first expires the request to DEADLINE_EXCEEDED with whatever
        tokens it has.  ``priority`` orders preemption victims (lower
        goes first)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        deadline_ns = (None if deadline_s is None
                       else self._clock() + int(deadline_s * 1e9))
        expire_step = (None if ttl_steps is None
                       else self._sched_steps + int(ttl_steps))
        self.scheduler.submit(Request(rid, prompt, int(max_new_tokens),
                                      priority=int(priority),
                                      deadline_ns=deadline_ns,
                                      expire_step=expire_step))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cooperative cancel: the request finishes TRUNCATED (partial
        output) at the next step boundary.  False if rid is unknown."""
        return self.scheduler.cancel(rid)

    def preempt(self, rid: int) -> bool:
        """Force-preempt a running request (the pressure path calls this
        itself; exposed for tests and the chaos harness).  Its tokens so
        far are kept and it is re-admitted -- through the prefix cache
        when there is one -- to finish with byte-exact output and status
        PREEMPTED_RETRIED."""
        for slot, r in self.scheduler.running.items():
            if r.rid == rid:
                self._preempt_slot(slot, self.obs.tracer)
                return True
        return False

    def inject_logit_fault(self, rid: int,
                           value: float = float("nan")) -> None:
        """Chaos seam: add ``value`` to every logit ``rid``'s slot
        produces from now on.  With ``nan_guard`` on, a non-finite
        ``value`` fails exactly this request and no other."""
        if not self.sc.nan_guard:
            raise RuntimeError(
                "inject_logit_fault needs PagedServeConfig(nan_guard="
                "True): without the guard a poisoned slot would decode "
                "garbage forever instead of failing fast")
        for slot, r in self.scheduler.running.items():
            if r.rid == rid:
                self._poison[slot] = value
                self._poison_host[slot] = value
                return
        raise KeyError(f"rid {rid} is not running")

    def shutdown(self) -> list[Request]:
        """Cancel all in-flight work and drain to terminal statuses.

        Frees every request-owned page and drops the prefix tree's
        references, so the pool returns to empty (the launcher's Ctrl-C
        path).  Returns the requests the drain finished."""
        for r in list(self.scheduler.waiting):
            r.cancelled = True
        for r in self.scheduler.running.values():
            r.cancelled = True
        out = []
        while self.has_work:
            out.extend(self.step())
        if self.prefix_cache is not None:
            while len(self.prefix_cache):
                if not self.prefix_cache.evict(len(self.prefix_cache)):
                    break
        return out

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def spec_stats(self) -> dict:
        """Draft-verify counters: verify calls (slots a verify step ran
        for), the tokens they emitted, and the mean accepted span (1.0 =
        plain decode); a view over the registry's ``spec.*``."""
        calls, toks = self._m_spec_calls.value, self._m_spec_tokens.value
        return {"verify_calls": calls, "tokens": toks,
                "mean_accepted": toks / calls if calls else 0.0}

    def prefix_stats(self) -> dict:
        """Prefix-cache counters: admissions probed, admissions that
        matched, prompt tokens served from shared pages instead of being
        re-prefilled, and the tree's current page count; a view over the
        registry's ``prefix_cache.*``."""
        lookups = self._m_prefix_lookups.value
        hits = self._m_prefix_hits.value
        return {"lookups": lookups, "hits": hits,
                "hit_rate": hits / lookups if lookups else 0.0,
                "tokens_saved": self._m_prefix_saved.value,
                "cached_pages": (len(self.prefix_cache)
                                 if self.prefix_cache is not None else 0)}

    def lifecycle_stats(self) -> dict:
        """Terminal-status counts and the pressure and fault counters; a
        view over the registry's ``lifecycle.*`` and ``sched.*``."""
        reg = self.obs.registry
        out = {s.value: self._m_status[s].value for s in RequestStatus}
        out["preemptions"] = reg.counter("sched.preemptions").value
        out["admit_rollbacks"] = reg.counter("sched.admit_rollbacks").value
        out["nan_guard_trips"] = self._m_nan_trips.value
        if self.degrade is not None:
            out["degrade_level"] = self.degrade.level
            out["degrade_escalations"] = \
                reg.counter("degrade.escalations").value
        return out

    def step(self) -> list[Request]:
        """One continuous-batching iteration; returns finished requests
        (with ``.output`` and ``.status`` filled).

        With a tracer attached, the step and its phases (host prep,
        ``plan_step``, device dispatches, readback) emit Chrome-trace
        spans, and each dispatch ends with :func:`device_fence`, so
        span durations include the device's work.  With no tracer,
        ``sp`` is the shared no-op span and NO fence runs (guarded by
        ``tests/test_torch_obs.py``)."""
        t0 = time.perf_counter_ns()
        tr = self.obs.tracer
        sp = tr.span if tr is not None else null_span
        self.last_step_tokens = 0
        step_rids: set[int] = set()
        with sp("step", cat="engine", args={"step": self._m_steps.value}):
            finished = self._step_inner(sp, tr, step_rids)
        self._m_steps.inc()
        self._m_step_us.observe((time.perf_counter_ns() - t0) / 1000.0)
        self.obs.dram.end_step(sorted(step_rids))
        return finished

    def _step_inner(self, sp, tr, step_rids: set[int]) -> list[Request]:
        self._sched_steps += 1
        now = self._clock()
        finished: list[Request] = []
        # lifecycle sweep: queued deadline/TTL expiry and cancellation
        # drain before admission, so a dead request never takes pages
        for req in self.scheduler.expire(now, self._sched_steps):
            self._finish(req, finished)
        # the degradation ladder: one control tick a step, applied to THIS
        # step's spec, chunk and preemption decisions
        decode_chunk = self.sc.decode_chunk
        use_spec = self.spec
        allow_preempt = self.sc.preempt
        force_preempt = False
        if self.degrade is not None:
            self.degrade.update()
            if self.degrade.spec_disabled:
                use_spec = 0
            if self.degrade.shrink_chunk:
                decode_chunk = max(1, decode_chunk // 2)
            if self.degrade.allow_preempt and self.sc.temperature <= 0:
                allow_preempt = force_preempt = True
        if allow_preempt:
            victim = self.scheduler.preempt_candidate(force=force_preempt)
            if victim is not None:
                with sp("preempt", cat="sched"):
                    self._preempt_slot(victim, tr)
        with sp("host_prep", cat="engine"):
            for req in self.scheduler.admit():
                step_rids.add(req.rid)
                self._admit(req, sp)
        for req in self.scheduler.take_rejected():
            self._finish(req, finished)
        with sp("plan_step", cat="sched"):
            plan = self.scheduler.plan_step(decode_chunk,
                                            self.prefill_chunk or 1)
        # the plan is validated and deduped before dispatch: a duplicated
        # decode slot would double-count ``generated``, and a stale or
        # dropped entry is skipped (the next plan recomputes it from the
        # scheduler's state) -- the chaos harness's seam
        running = self.scheduler.running
        decode_rs: list[Request] = []
        seen: set[int] = set()
        for s in plan.decode_slots:
            r = running.get(s)
            if r is None or s in seen or not r.decode_ready \
                    or r.cancelled or r.expired(now, self._sched_steps):
                continue            # dead slots stop decoding at once
            seen.add(s)
            decode_rs.append(r)
        step_rids.update(r.rid for r in decode_rs)
        # decode first: decode-ready slots are never stalled by prefill
        if decode_rs:
            with sp("dispatch.decode", cat="device"):
                self._decode_once(decode_rs, decode_chunk, use_spec)
        for slot in plan.prefill_slots:
            r = running.get(slot)
            if r is None or r.prefill_done or r.cancelled \
                    or r.expired(now, self._sched_steps):
                continue
            step_rids.add(r.rid)
            with sp("dispatch.prefill", cat="device"):
                self._prefill_one_chunk(r)
        done_slots = [s for s, r in running.items()
                      if r.done or r.failed or r.cancelled
                      or r.expired(now, self._sched_steps)]
        if done_slots:
            # one host transfer covers every request finishing now; the
            # device state is not reset (the decode masks unoccupied slots
            # to the scratch page, and admission rewrites the row)
            with sp("readback", cat="engine"):
                host_out = self._out_buf.cpu().numpy()
            for slot in done_slots:
                req = running[slot]
                tail = host_out[slot, :req.generated].copy()
                req.output = (tail if req.prior_tokens is None else
                              np.concatenate([req.prior_tokens, tail]))
                self._clear_poison(slot)
                self._finish(self.scheduler.evict(slot), finished)
        return finished

    def _admit(self, req: Request, sp) -> None:
        """Write an admitted request's block-table row, then start its
        prefill: on a prefix hit, fork the shared page an exact match
        writes into, fill its history row and prefill a one-chunk tail
        inline; on a miss that fits one chunk (or with
        ``prefill_chunk=0``), join the whole prompt.  Longer prefills
        run later, a chunk at a time, as the plan schedules them."""
        row = np.full(self.max_blocks, KV.SCRATCH_PAGE, np.int32)
        row[:len(req.pages)] = req.pages
        self._block_tables[req.slot] = torch.from_numpy(row).to(self.device)
        if self.prefix_caching:
            self._m_prefix_lookups.inc()
        if req.cached_tokens:
            # the shared pages already hold the matched K/V; prefill
            # resumes at the boundary through the span path
            self._m_prefix_hits.inc()
            self._m_prefix_saved.inc(req.prefilled)
            if req.cow_fork is not None:
                with sp("dispatch.fork", cat="device"), \
                        self.obs.dram.scope("cow_fork"):
                    KV.fork_page(self.cache, *req.cow_fork)
                    self._fence()
            # the draft history must cover the cached prefix the span
            # path never feeds
            n = min(req.prompt_len, self.sc.max_seq)
            self._hist[req.slot].zero_()
            self._hist[req.slot, :n] = torch.from_numpy(
                req.prompt[:n]).to(self.device)
            # a tail that fits one chunk prefills here, where a miss
            # would join: the hit is decode-ready this very step
            if req.prompt_len - req.prefilled <= self.prefill_chunk:
                with sp("dispatch.prefill", cat="device"):
                    self._prefill_one_chunk(req)
            return
        if not self.prefill_chunk or req.prompt_len <= self.prefill_chunk:
            # whole-prompt join at the prompt's pow2 bucket; only
            # multi-chunk prompts take the chunk path
            with sp("dispatch.join", cat="device"):
                self._join(req)
            req.prefilled = req.prompt_len
            if not req.failed:          # poisoned pages are never cached
                self.scheduler.register_prefix(req)
                self.last_step_tokens += 1         # the prefill token

    def _finish(self, req: Request, out: list[Request]) -> None:
        """Assign the terminal status, count it and hand the request
        back.  Precedence: a tripped fault always FAILs; a request that
        finished its budget is OK (or PREEMPTED_RETRIED) even if a
        cancel or deadline raced the last step; else cancel beats the
        deadline."""
        if req.output is None:     # never ran: expired/rejected in queue
            req.output = (req.prior_tokens if req.prior_tokens is not None
                          else np.zeros(0, np.int32))
        if req.failed:
            status = RequestStatus.FAILED
        elif req.done:
            status = (RequestStatus.PREEMPTED_RETRIED if req.preempt_count
                      else RequestStatus.OK)
        elif req.cancelled:
            status = RequestStatus.TRUNCATED
        else:
            status = RequestStatus.DEADLINE_EXCEEDED
        req.status = status
        self._m_status[status].inc()
        out.append(req)

    def _preempt_slot(self, slot: int, tr=None) -> None:
        """Preempt one running slot: read back its sampled tokens (the
        one sync a preemption pays), hand them to the scheduler -- which
        registers the complete pages in the prefix tree and requeues the
        replacement -- and clear any injected poison with the slot."""
        req = self.scheduler.running[slot]
        # a copy: on the CPU the array would share the buffer's memory
        emitted = self._out_buf[slot, :req.generated].cpu().numpy().copy()
        new = self.scheduler.preempt(slot, emitted)
        self._clear_poison(slot)
        if tr is not None:
            tr.instant("preempt", cat="lifecycle",
                       args={"rid": req.rid, "slot": slot,
                             "kept_tokens": int(len(new.prior_tokens))})

    def _clear_poison(self, slot: int) -> None:
        if self._poison_host[slot]:
            self._poison[slot] = 0.0
            self._poison_host[slot] = 0.0

    def generate(self, prompts, n_tokens: int, *, priorities=None,
                 deadline_s: float | None = None,
                 ttl_steps: int | None = None,
                 return_requests: bool = False):
        """Batch convenience: submit all, run to completion, return
        (B, n_tokens) in submission order.  ``prompts`` may be a 2-D
        array or a list of 1-D arrays of ragged lengths.  With
        ``return_requests=True`` the finished :class:`Request` objects
        come back instead (``.output`` and the terminal ``.status``), the
        only safe form when deadlines, TTLs or faults can cut outputs
        short."""
        pr = (list(priorities) if priorities is not None
              else [0] * len(prompts))
        rids = [self.submit(p, n_tokens, priority=q, deadline_s=deadline_s,
                            ttl_steps=ttl_steps)
                for p, q in zip(prompts, pr)]
        done: dict[int, Request] = {}
        while self.has_work:
            for req in self.step():
                done[req.rid] = req
        if return_requests:
            return [done[r] for r in rids]
        return np.stack([done[r].output for r in rids])

    # -- internals ------------------------------------------------------------

    def _bucket(self, length: int) -> int:
        for b in self.buckets or ():
            if b >= length:
                return b
        return length

    def _guard(self, logits: torch.Tensor, poison: torch.Tensor,
               dims) -> tuple[torch.Tensor, torch.Tensor]:
        """``nan_guard``: ``poison`` added to ``logits``; returns the
        poisoned logits with their non-finite entries zeroed (sampling
        draws as it would, from logits that are then thrown away) and
        the per-row flag, True where every vocab logit over ``dims`` is
        finite."""
        logits = logits + poison
        fin = torch.isfinite(logits[..., :self.cfg.vocab])
        ok = fin.all(dim=dims) if dims is not None else fin.all()
        return torch.where(torch.isfinite(logits), logits, 0.0), ok

    def _join(self, req: Request) -> None:
        """Prefill an admitted request at its bucketed length, scatter its
        K/V into the reserved pages, sample its first token."""
        slot, n = req.slot, req.prompt_len
        bucket = self._bucket(n)
        prompt = np.zeros((1, bucket), np.int32)
        prompt[0, :n] = req.prompt
        nb = KV.num_blocks(bucket, self.page_size)
        pages = np.full(nb, KV.SCRATCH_PAGE, np.int64)
        pages[:min(nb, len(req.pages))] = req.pages[:nb]
        tokens = torch.from_numpy(prompt).to(self.device)
        ok = None
        # the scope tag carries the bucket, as JAX's jit variant
        with self.obs.dram.scope(f"join[{bucket}]"):
            with ops.fused_ops(self.sc.fuse):
                logits, dense = T.prefill(
                    self.cfg, self.params, tokens, max_seq=bucket,
                    full_kv=True, logits_at=n - 1,
                    use_kernel=self.sc.use_kernel)
            KV.write_prefill(self.cfg, self.cache, dense, slot,
                             torch.from_numpy(pages).to(self.device),
                             self.page_size)
            if self.sc.nan_guard:
                logits, ok = self._guard(logits, self._poison[slot], None)
            tok = sample_tokens(self.cfg, logits, self.sc.temperature,
                                self._gen)[0]
            self._lengths[slot] = n
            self._cur_tok[slot] = tok
            self._out_buf[slot, 0] = tok
            self._hist[slot, :bucket] = tokens[0]
            self._hist[slot, n] = tok
            self._fence()
        self._m_prefill_tokens.inc(n)
        self._m_joins.inc()
        if ok is not None and not bool(ok):   # the guard's one readback
            req.failed = True
            self._m_nan_trips.inc()
            return
        req.generated = 1

    def _prefill_one_chunk(self, req: Request) -> None:
        """Advance one request's prefill by one chunk: a batch-1 span
        ``decode_step`` over the paged cache.  The span width is the pow2
        bucket of the real remainder (the final partial chunk, and the
        short tail after a prefix hit, pay for the tokens they carry);
        the final chunk samples the first token exactly as a join
        would, and registers the prompt's full pages in the prefix
        tree."""
        start, n = req.prefilled, req.prompt_len
        c_real = min(self.prefill_chunk, n - start)
        width = 1
        while width < c_real:
            width *= 2
        final = start + c_real >= n
        tokens = np.zeros((1, width), np.int32)
        tokens[0, :c_real] = req.prompt[start:start + c_real]
        slot, max_seq = req.slot, self.sc.max_seq
        ok = None
        with self.obs.dram.scope(f"prefill[{width}]"):
            attn = KV.make_paged_span_step(
                self.cfg, self._block_tables[slot:slot + 1], self.page_size,
                max_seq, self.sc.use_kernel)
            pos = torch.full((1,), start, dtype=torch.int32,
                             device=self.device)
            feed = torch.from_numpy(tokens).to(self.device)
            with ops.fused_ops(self.sc.fuse):
                logits, _ = T.decode_step(self.cfg, self.params, feed,
                                          self.cache, pos, attn,
                                          use_kernel=self.sc.use_kernel)
            if self.sc.nan_guard:
                logits, ok = self._guard(logits, self._poison[slot], None)
            self._lengths[slot] = start + c_real
            # positions past max_seq (a padded final chunk) land in the
            # history's spare column
            idx = torch.clamp(torch.arange(start, start + width,
                                           device=self.device), max=max_seq)
            self._hist[slot, idx] = feed[0]
            if final:
                tok = sample_tokens(self.cfg, logits[:, n - 1 - start],
                                    self.sc.temperature, self._gen)[0]
                self._cur_tok[slot] = tok
                self._out_buf[slot, 0] = tok
                self._hist[slot, n] = tok
            self._fence()
        self._m_prefill_tokens.inc(c_real)
        self._m_prefill_chunks.inc()
        req.prefilled = start + c_real
        if ok is not None and not bool(ok):   # the guard's one readback
            req.failed = True
            self._m_nan_trips.inc()
            return
        if final:
            req.generated = 1
            self.scheduler.register_prefix(req)
            self.last_step_tokens += 1             # the prefill token

    def _decode_once(self, running: list[Request], decode_chunk: int,
                     use_spec: int) -> None:
        b = self.sc.max_batch
        guard = self.sc.nan_guard
        occupied = np.zeros(b, bool)
        remaining = np.zeros(b, np.int32)
        out_idx = np.zeros(b, np.int32)
        for r in running:
            occupied[r.slot] = True
            remaining[r.slot] = r.max_new_tokens - r.generated
            out_idx[r.slot] = r.generated
        # the same pow2 snapping of the chunk as the JAX engine, so both
        # engines schedule identically
        chunk = 1 << (int(remaining.max()) - 1).bit_length()
        chunk = int(min(decode_chunk, chunk))
        if use_spec:
            # each verify step emits 1..spec+1 tokens; the loop is sized
            # for the budget at full acceptance (zero acceptance spreads a
            # slot's budget over more scheduler visits instead)
            iters = -(-chunk // (self.spec + 1))
            with self.obs.dram.scope(f"spec_decode[{iters}]"):
                stats = self._decode_spec_fn(occupied, remaining, out_idx,
                                             iters)
                self._fence()
            self._m_verify_steps.inc(iters)
            # the one readback a step: how far each slot got
            stats = stats.cpu().numpy()
            emitted, calls, bad = stats[:b], int(stats[b]), stats[b + 1:]
            for r in running:
                n = int(emitted[r.slot])
                r.generated += n
                self.last_step_tokens += n
                if guard and bad[r.slot]:
                    r.failed = True
                    self._m_nan_trips.inc()
            self._m_spec_calls.inc(calls)
            self._m_spec_tokens.inc(int(emitted.sum()))
            self._m_decode_tokens.inc(int(emitted.sum()))
            return
        with self.obs.dram.scope(f"decode[{chunk}]"):
            stats = self._decode_fn(occupied, remaining, out_idx, chunk)
            self._fence()
        self._m_decode_steps.inc(chunk)
        if guard:
            stats = stats.cpu().numpy()     # the guard's one readback
            for r in running:
                n = int(stats[0, r.slot])
                r.generated += n
                self.last_step_tokens += n
                self._m_decode_tokens.inc(n)
                if stats[1, r.slot]:
                    r.failed = True
                    self._m_nan_trips.inc()
            return
        for r in running:
            steps = min(chunk, r.max_new_tokens - r.generated)
            r.generated += steps
            self.last_step_tokens += steps
            self._m_decode_tokens.inc(steps)

    def _fence(self) -> None:
        """:func:`device_fence` when a tracer is attached, else nothing."""
        if self.obs.tracer is not None:
            device_fence(self.device)

    def _decode_fn(self, occupied: np.ndarray, remaining: np.ndarray,
                   out_idx: np.ndarray, chunk: int) -> torch.Tensor | None:
        """``chunk`` decode steps over every slot, with no host sync.

        A step is active for slot b while ``occupied[b]`` and its emitted
        count is under ``remaining[b]``; inactive slots freeze their
        length, token and output row.  Unoccupied slots' block-table rows
        and lengths are masked to the scratch page / 0 here, so eviction
        never has to reset device state.

        With ``nan_guard`` on, the poison is added to the logits and a
        slot that produces a non-finite logit is frozen for the rest of
        the chunk (its tokens so far stay); returns the (2, B) stats
        ``(emitted, bad)`` the host reads back once a chunk, else
        None."""
        dev = self.device
        guard = self.sc.nan_guard
        occ = torch.from_numpy(occupied).to(dev)
        rem = torch.from_numpy(remaining).to(dev)
        out_idx = torch.from_numpy(out_idx).to(dev)
        block_tables = torch.where(occ[:, None], self._block_tables,
                                   KV.SCRATCH_PAGE)
        lengths = torch.where(occ, self._lengths, 0)
        attn = KV.make_paged_attn_step(self.cfg, block_tables,
                                       self.page_size, self.sc.use_kernel,
                                       fused=self.sc.fuse)
        rows = torch.arange(occ.shape[0], device=dev)
        cur_tok, out_buf = self._cur_tok, self._out_buf
        emitted = torch.zeros_like(rem)
        bad = torch.zeros_like(occ)
        for _ in range(chunk):
            active = occ & (emitted < rem) & ~bad
            with ops.fused_ops(self.sc.fuse):
                logits, _ = T.decode_step(self.cfg, self.params, cur_tok,
                                          self.cache, lengths, attn,
                                          use_kernel=self.sc.use_kernel)
            if guard:
                logits, finite = self._guard(logits, self._poison[:, None],
                                             -1)
                bad = bad | (active & ~finite)
                active = active & finite
            tok = sample_tokens(self.cfg, logits, self.sc.temperature,
                                self._gen)
            tok = torch.where(active, tok, cur_tok)
            out_buf[rows, out_idx] = torch.where(active, tok,
                                                 out_buf[rows, out_idx])
            out_idx = torch.where(active, out_idx + 1, out_idx)
            lengths = torch.where(active, lengths + 1, lengths)
            emitted = emitted + active.to(emitted.dtype)
            cur_tok = tok
        self._cur_tok = cur_tok
        # a still-prefilling slot keeps its length
        self._lengths = torch.where(occ, lengths, self._lengths)
        return torch.stack([emitted, bad.to(emitted.dtype)]) if guard \
            else None

    def _drafts(self, lengths: torch.Tensor) -> torch.Tensor:
        """(B, k) n-gram drafts from the history on the device
        (prompt-lookup decoding): the latest earlier occurrence of each
        slot's trailing 2-gram proposes its continuation; no match drafts
        -1, which is never accepted."""
        k, max_seq = self.spec, self.sc.max_seq
        dev = lengths.device
        hist = self._hist[:, :max_seq]
        rows = torch.arange(hist.shape[0], device=dev)
        hl = lengths.long() + 1                     # tokens in hist a slot
        last = hist[rows, (hl - 1).clamp(0, max_seq - 1)]
        prev = hist[rows, (hl - 2).clamp(0, max_seq - 1)]
        m2 = (hist[:, 1:] == last[:, None]) & (hist[:, :-1] == prev[:, None])
        p = torch.arange(1, max_seq, device=dev)
        m2 &= p[None, :] < (hl - 1)[:, None]        # strictly earlier
        j = torch.where(m2, p[None, :], -1).amax(dim=1)
        gidx = j[:, None] + 1 + torch.arange(k, device=dev)[None, :]
        valid = (j >= 0)[:, None] & (gidx < hl[:, None])
        d = hist[rows[:, None], gidx.clamp(0, max_seq - 1)]
        return torch.where(valid, d, -1)

    def _decode_spec_fn(self, occupied: np.ndarray, remaining: np.ndarray,
                        out_idx: np.ndarray, iters: int) -> torch.Tensor:
        """``iters`` draft-verify steps over every slot, with no host sync.

        Each step drafts ``k = spec_decode`` tokens (:meth:`_drafts`),
        scores the current token and the drafts in ONE span
        ``decode_step`` (B = max_batch, ``q_span`` = k + 1), and accepts
        the longest prefix of drafts that matches the argmax chain, so
        the tokens equal plain greedy decode's.  Draft rows past the
        accepted prefix leave K/V above the new length; the next span
        overwrites every such position before the length mask exposes
        it.  ``remaining`` bounds emitted tokens, not steps: a step that
        would overshoot the budget truncates its accepted span.  With
        ``nan_guard`` on, a non-finite logit anywhere in a slot's span
        freezes the slot (it emits nothing from then on).  Returns the
        per-slot emitted counts, the active verify calls and the per-slot
        guard flags, concatenated: the step's one readback."""
        cfg, k, max_seq = self.cfg, self.spec, self.sc.max_seq
        dev = self.device
        guard = self.sc.nan_guard
        occ = torch.from_numpy(occupied).to(dev)
        rem = torch.from_numpy(remaining).to(dev)
        out_idx = torch.from_numpy(out_idx).to(dev)
        block_tables = torch.where(occ[:, None], self._block_tables,
                                   KV.SCRATCH_PAGE)
        lengths = torch.where(occ, self._lengths, 0)
        attn = KV.make_paged_span_step(cfg, block_tables, self.page_size,
                                       max_seq, self.sc.use_kernel)
        rows = torch.arange(occ.shape[0], device=dev)
        t = torch.arange(k + 1, device=dev)
        cur_tok = self._cur_tok
        emitted = torch.zeros_like(rem)
        calls = torch.zeros((), dtype=torch.int64, device=dev)
        bad = torch.zeros_like(occ)
        for _ in range(iters):
            active = occ & (emitted < rem) & ~bad
            d = self._drafts(lengths)
            feed = torch.cat([cur_tok[:, None], d.clamp(min=0)], dim=1)
            with ops.fused_ops(self.sc.fuse):
                logits, _ = T.decode_step(cfg, self.params, feed, self.cache,
                                          lengths, attn,
                                          use_kernel=self.sc.use_kernel)
            if guard:
                logits, finite = self._guard(
                    logits, self._poison[:, None, None], (1, 2))
                bad = bad | (active & ~finite)
                active = active & finite
            a = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(
                torch.int32)                                  # (B, k + 1)
            prefix = torch.cumprod((d == a[:, :k]).to(torch.int32), dim=1)
            m = prefix.sum(dim=1, dtype=torch.int32)   # accepted, in [0, k]
            n_emit = torch.where(active, torch.minimum(m + 1, rem - emitted),
                                 0)
            take = t[None, :] < n_emit[:, None]
            # entries past the accepted span go to the spare column
            oidx = torch.where(take, out_idx[:, None] + t[None, :], max_seq)
            self._out_buf[rows[:, None], oidx] = a
            hidx = torch.where(take, (lengths + 1)[:, None] + t[None, :],
                               max_seq)
            self._hist[rows[:, None], hidx] = a
            new_cur = a[rows, (n_emit - 1).clamp(0, k).long()]
            cur_tok = torch.where(active, new_cur, cur_tok)
            lengths = lengths + n_emit
            out_idx = out_idx + n_emit
            emitted = emitted + n_emit
            calls = calls + active.sum()
        self._cur_tok = cur_tok
        self._lengths = torch.where(occ, lengths, self._lengths)
        return torch.cat([emitted.long(), calls.reshape(1), bad.long()])
