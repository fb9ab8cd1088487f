"""Paged continuous-batching serving engine (the port of
``repro.serve.engine.PagedEngine``).

A prompt enters through :meth:`PagedEngine.submit`; each
:meth:`PagedEngine.step` runs one decode-priority iteration of the
scheduler's plan:

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
under that kernel's key.  Not ported yet, and refused with
``NotImplementedError`` rather than ignored: ``spec_decode``,
``prefix_cache``, ``preempt``, ``degrade`` and ``nan_guard``
(``ROADMAP.md``).
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
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import null_span
from repro_torch.serve import kv_cache as KV
from repro_torch.serve.lifecycle import RequestStatus
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.util import resolve_device


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
    age_limit: int = 8             # admission rounds before a waiting head
    #                                suspends backfill (anti-starvation)
    use_kernel: bool = True        # False: the plain versions, on purpose
    device: str = "cuda"           # "cpu" runs the plain versions
    fuse: bool = False             # the cross-op fused kernels
    # -- not ported yet: each raises NotImplementedError when set --------
    spec_decode: int = 0
    prefix_cache: bool = False
    nan_guard: bool = False
    preempt: bool = False
    degrade: bool = False


_NOT_PORTED = (
    ("spec_decode", "queue 1, item 7 (speculative decode)"),
    ("prefix_cache", "queue 1, item 7 (PrefixCache)"),
    ("nan_guard", "queue 1, item 7 (lifecycle features)"),
    ("preempt", "queue 1, item 7 (lifecycle features)"),
    ("degrade", "queue 1, item 7 (lifecycle features)"),
)


def _check_ported(sc: PagedServeConfig) -> None:
    for name, item in _NOT_PORTED:
        if getattr(sc, name):
            raise NotImplementedError(
                f"PagedServeConfig.{name} is not ported yet: ROADMAP.md, "
                f"{item}")


def default_buckets(cfg: ModelConfig, max_seq: int) -> tuple[int, ...]:
    """Prefill length buckets: powers of two from 8, capped by max_seq
    (right-padding is safe for attention stacks: causal attention
    ignores the tail, and the pad positions' K/V stay masked by the
    length until decode overwrites each slot in order)."""
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

    def __init__(self, cfg: ModelConfig, params: Any, sc: PagedServeConfig):
        _check_ported(sc)
        T.model_defs(cfg)                  # refuses unported families
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = resolve_device(sc.device)
        if params["embed"]["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['embed']['embedding'].device}, the "
                f"engine on {self.device}")
        self.page_size = sc.page_size or KV.choose_page_size(
            cfg, sc.max_seq, fused=sc.fuse)
        self.max_blocks = KV.num_blocks(sc.max_seq, self.page_size)
        n_pages = sc.n_pages or sc.max_batch * self.max_blocks + 1
        self.cache = KV.init_paged_cache(cfg, n_pages, self.page_size,
                                         self.device)
        self.buckets = (sc.buckets if sc.buckets is not None
                        else default_buckets(cfg, sc.max_seq))
        if sc.prefill_chunk is None:
            self.prefill_chunk = KV.choose_prefill_chunk(
                cfg, sc.max_seq, self.page_size)
        else:   # snap an explicit chunk to a whole number of pages
            self.prefill_chunk = (min(sc.max_seq, KV.num_blocks(
                sc.prefill_chunk, self.page_size) * self.page_size)
                if sc.prefill_chunk else 0)
        if sc.page_size is None or sc.prefill_chunk is None:
            print(f"PagedEngine: page {self.page_size}, prefill chunk "
                  f"{self.prefill_chunk} (blocking model, max_seq "
                  f"{sc.max_seq}{', fused' if sc.fuse else ''})")

        self.metrics = reg = MetricsRegistry()
        reg.gauge("engine.page_size").set(self.page_size)
        reg.gauge("engine.prefill_chunk").set(self.prefill_chunk)
        allocator = KV.PageAllocator(n_pages, metrics=reg)
        self.scheduler = Scheduler(sc.max_batch, self.page_size, allocator,
                                   sc.max_seq, age_limit=sc.age_limit,
                                   metrics=reg)

        b, dev = sc.max_batch, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._block_tables = torch.zeros((b, self.max_blocks), **i32)
        self._lengths = torch.zeros(b, **i32)      # cached tokens per slot
        self._cur_tok = torch.zeros(b, **i32)
        self._out_buf = torch.zeros((b, sc.max_seq), **i32)
        self._gen = torch.Generator(device=dev).manual_seed(sc.seed)
        self._next_rid = 0
        self._m_steps = reg.counter("engine.steps")
        self._m_step_us = reg.histogram("engine.step_us")
        self._m_decode_tokens = reg.counter("engine.decode_tokens")
        self._m_prefill_tokens = reg.counter("engine.prefill_tokens")
        # model calls by kind: each runs every layer's attention kernel
        # once (joins: flash_attention; prefill chunks: flash_decode;
        # decode steps: flash_decode, or flash_decode_oproj under fuse)
        self._m_joins = reg.counter("engine.joins")
        self._m_decode_steps = reg.counter("engine.decode_steps")
        self._m_prefill_chunks = reg.counter("engine.prefill_chunks")
        self._m_ok = reg.counter(f"lifecycle.{RequestStatus.OK.value}")

    # -- request API ----------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        """Enqueue one prompt; returns the request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        self.scheduler.submit(Request(rid, prompt, int(max_new_tokens)))
        return rid

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def step(self) -> list[Request]:
        """One continuous-batching iteration; returns finished requests
        (with ``.output`` and ``.status`` filled)."""
        t0 = time.perf_counter_ns()
        sp = null_span
        finished: list[Request] = []
        with sp("step", cat="engine"):
            with sp("host_prep", cat="engine"):
                for req in self.scheduler.admit():
                    row = np.full(self.max_blocks, KV.SCRATCH_PAGE, np.int32)
                    row[:len(req.pages)] = req.pages
                    self._block_tables[req.slot] = torch.from_numpy(row).to(
                        self.device)
                    if (not self.prefill_chunk
                            or req.prompt_len <= self.prefill_chunk):
                        # whole-prompt join at the prompt's pow2 bucket;
                        # only multi-chunk prompts take the chunk path
                        with sp("dispatch.join", cat="device"):
                            self._join(req)
                        req.prefilled = req.prompt_len
            with sp("plan_step", cat="sched"):
                plan = self.scheduler.plan_step(self.sc.decode_chunk,
                                                self.prefill_chunk or 1)
            running = self.scheduler.running
            # decode first: decode-ready slots are never stalled by prefill
            decode_rs = [running[s] for s in plan.decode_slots]
            if decode_rs:
                with sp("dispatch.decode", cat="device"):
                    self._decode_once(decode_rs)
            for slot in plan.prefill_slots:
                r = running.get(slot)
                if r is None or r.prefill_done:
                    continue
                with sp("dispatch.prefill", cat="device"):
                    self._prefill_one_chunk(r)
            done_slots = [s for s, r in running.items() if r.done]
            if done_slots:
                # one host transfer covers every request finishing now
                with sp("readback", cat="engine"):
                    host_out = self._out_buf.cpu().numpy()
                for slot in done_slots:
                    req = self.scheduler.evict(slot)
                    req.output = host_out[slot, :req.generated].copy()
                    req.status = RequestStatus.OK
                    self._m_ok.inc()
                    finished.append(req)
        self._m_steps.inc()
        self._m_step_us.observe((time.perf_counter_ns() - t0) / 1000.0)
        return finished

    def generate(self, prompts, n_tokens: int, *,
                 return_requests: bool = False):
        """Batch convenience: submit all, run to completion, return
        (B, n_tokens) in submission order (``return_requests=True``: the
        finished :class:`Request` objects instead).  ``prompts`` may be a
        2-D array or a list of 1-D arrays of ragged lengths."""
        rids = [self.submit(p, n_tokens) for p in prompts]
        done: dict[int, Request] = {}
        while self.has_work:
            for req in self.step():
                done[req.rid] = req
        if return_requests:
            return [done[r] for r in rids]
        return np.stack([done[r].output for r in rids])

    # -- internals ------------------------------------------------------------

    def _bucket(self, length: int) -> int:
        for b in self.buckets:
            if b >= length:
                return b
        return length

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
        with ops.fused_ops(self.sc.fuse):
            logits, dense = T.prefill(
                self.cfg, self.params,
                torch.from_numpy(prompt).to(self.device), max_seq=bucket,
                full_kv=True, logits_at=n - 1, use_kernel=self.sc.use_kernel)
        KV.write_prefill(self.cfg, self.cache, dense,
                         torch.from_numpy(pages).to(self.device),
                         self.page_size)
        tok = sample_tokens(self.cfg, logits, self.sc.temperature,
                            self._gen)[0]
        self._lengths[slot] = n
        self._cur_tok[slot] = tok
        self._out_buf[slot, 0] = tok
        self._m_prefill_tokens.inc(n)
        self._m_joins.inc()
        req.generated = 1

    def _prefill_one_chunk(self, req: Request) -> None:
        """Advance one request's prefill by one chunk: a batch-1 span
        ``decode_step`` over the paged cache.  The span width is the pow2
        bucket of the real remainder; the final chunk samples the first
        token exactly as a join would."""
        start, n = req.prefilled, req.prompt_len
        c_real = min(self.prefill_chunk, n - start)
        width = 1
        while width < c_real:
            width *= 2
        tokens = np.zeros((1, width), np.int32)
        tokens[0, :c_real] = req.prompt[start:start + c_real]
        slot = req.slot
        attn = KV.make_paged_span_step(
            self.cfg, self._block_tables[slot:slot + 1], self.page_size,
            self.sc.max_seq, self.sc.use_kernel)
        pos = torch.full((1,), start, dtype=torch.int32, device=self.device)
        with ops.fused_ops(self.sc.fuse):
            logits, _ = T.decode_step(
                self.cfg, self.params,
                torch.from_numpy(tokens).to(self.device), self.cache, pos,
                attn, use_kernel=self.sc.use_kernel)
        self._lengths[slot] = start + c_real
        self._m_prefill_tokens.inc(c_real)
        self._m_prefill_chunks.inc()
        req.prefilled = start + c_real
        if req.prefill_done:
            tok = sample_tokens(self.cfg, logits[:, n - 1 - start],
                                self.sc.temperature, self._gen)[0]
            self._cur_tok[slot] = tok
            self._out_buf[slot, 0] = tok
            req.generated = 1

    def _decode_once(self, running: list[Request]) -> None:
        b = self.sc.max_batch
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
        chunk = int(min(self.sc.decode_chunk, chunk))
        self._decode_fn(occupied, remaining, out_idx, chunk)
        self._m_decode_steps.inc(chunk)
        for r in running:
            steps = min(chunk, r.max_new_tokens - r.generated)
            r.generated += steps
            self._m_decode_tokens.inc(steps)

    def _decode_fn(self, occupied: np.ndarray, remaining: np.ndarray,
                   out_idx: np.ndarray, chunk: int) -> None:
        """``chunk`` decode steps over every slot, with no host sync.

        A step is active for slot b while ``occupied[b]`` and its emitted
        count is under ``remaining[b]``; inactive slots freeze their
        length, token and output row.  Unoccupied slots' block-table rows
        and lengths are masked to the scratch page / 0 here, so eviction
        never has to reset device state."""
        dev = self.device
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
        for _ in range(chunk):
            active = occ & (emitted < rem)
            with ops.fused_ops(self.sc.fuse):
                logits, _ = T.decode_step(self.cfg, self.params, cur_tok,
                                          self.cache, lengths, attn,
                                          use_kernel=self.sc.use_kernel)
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
