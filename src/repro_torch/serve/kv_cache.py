"""Paged KV cache: fixed-size KV blocks + per-request block tables (the
port of ``repro.serve.kv_cache``).

Every attention layer owns a page pool ``(n_pages, page, Hkv, D)``; the
port stacks all layers' pools into one tensor per K and V,
``(n_layers, n_pages, page, Hkv, D)``, and each request holds a block
table mapping its logical KV blocks to physical pages.  The page size is
the flash-decode kernel's KV tile, chosen by the analytical blocking
model on the Hopper target through ``repro_torch.tune`` under the
``"flash_decode"`` key (:func:`choose_page_size`; under
``"flash_decode_fp8"`` for an fp8 pool, and ``"flash_decode_oproj"``
for a fused engine's wide pool, whose decode kernel stages the page), so
cache layout and kernel schedule are one decision;
:func:`choose_prefill_chunk` sizes the prefill chunk against the same
kernel footprint.

The pools are updated in place (``index_put_``): JAX returned a new
pool from every scatter, which PyTorch need not copy.  An fp8 pool
(``kv_cache_dtype=torch.float8_e4m3fn``) is a pure cast of K/V, as in
JAX's engine; it is scattered through its ``uint8`` view (the cast
values' bytes, never a widened pool), so the scatter needs no indexing
kernel for the fp8 dtype.

Page 0 is a reserved scratch page: inactive request slots keep all-zero
block tables, so their (masked, ignored) decode writes land there
instead of needing a branch.  Prefix sharing (``PrefixCache``) is a
later slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import ParamDef, build, stack_defs
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry

SCRATCH_PAGE = 0


def num_blocks(length: int, page_size: int) -> int:
    return -(-length // page_size)


def choose_page_size(cfg: ModelConfig, max_seq: int, cache=None,
                     fused: bool = False) -> int:
    """KV page size from the analytical model (op key ``"flash_decode"``).

    The spec's dims are (G, S, D): G query heads per KV head stream over
    an S-long cache of head dim D.  A tuned entry in the schedule cache
    (``python -m repro_torch.tune flash_decode ...``) wins; otherwise the
    analytic top candidate is used.

    An fp8 pool (``kv_cache_dtype`` of width 1) sizes its pages under
    ``"flash_decode_fp8"``, dims (G, S, D), named by the model dtype (the
    q rows' width; the pages are 1 byte), ahead of ``fused``: the fused
    path decodes an fp8 pool with the unfused fp8 kernel, as in JAX.

    ``fused=True`` (the engine's ``fuse`` flag) sizes a wide pool's pages
    under ``"flash_decode_oproj"``, dims (G, S, D, E): its decode kernel
    stages the page beside the head's G x D rows and its (1, E) partial,
    so the page is priced by the kernel that runs
    (``oproj_smem_bytes_required``).  The prefix cache's ``reuse_rate``
    pricing is not ported yet (``ROADMAP.md``, queue 1, item 7).
    """
    from repro_torch.tune import best_schedule
    g = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    kv_dtype = cfg.kv_cache_dtype or cfg.dtype
    if kv_dtype.itemsize == 1:
        op, dtype = "flash_decode_fp8", cfg.dtype
        dims: tuple[int, ...] = (g, max_seq, cfg.head_dim)
    elif fused:
        op, dtype = "flash_decode_oproj", kv_dtype
        dims = (g, max_seq, cfg.head_dim, cfg.d_model)
    else:
        op, dtype = "flash_decode", kv_dtype
        dims = (g, max_seq, cfg.head_dim)
    sched = best_schedule(op, dims, str(dtype).removeprefix("torch."),
                          cache=cache)
    return max(1, min(sched.tiles[0], max_seq))


def choose_prefill_chunk(cfg: ModelConfig, max_seq: int,
                         page_size: int) -> int:
    """Prefill chunk size from the same blocking model as the page size.

    A prefill chunk is one multi-position q block of the flash-decode
    kernel (``q_span = chunk``), so it is priced by the kernel's own
    footprint (``flash_decode.smem_bytes_required``) against the shared
    memory budget the page was tuned under: the chunk is the largest
    power-of-two multiple of the page size (a whole number of pages)
    whose footprint still fits, capped at ``max_seq``.  On Hopper the
    kernel tiles query rows across blocks, ``ROWS_PER_BLOCK`` at a time,
    so the span never enters the footprint and the rule returns the
    largest power-of-two whole-page chunk within ``max_seq`` -- the JAX
    rule's answer when nothing binds.
    """
    from repro_torch.core.hopper_adapter import default_smem_budget
    from repro_torch.kernels.flash_decode import (ROWS_PER_BLOCK,
                                                  smem_bytes_required)
    kv_bytes = (cfg.kv_cache_dtype or cfg.dtype).itemsize
    fits = smem_bytes_required(page_size, ROWS_PER_BLOCK, cfg.head_dim,
                               cfg.dtype.itemsize, kv_bytes) \
        <= default_smem_budget()
    chunk = min(page_size, max_seq)
    while fits and chunk * 2 <= max_seq:
        chunk *= 2
    return chunk


# ------------------------------ device side --------------------------------


def paged_cache_defs(cfg: ModelConfig, n_pages: int, page_size: int) -> dict:
    """K and V pools of every layer, stacked: (n_layers, n_pages, page,
    Hkv, D) each."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    dtype = cfg.kv_cache_dtype or cfg.dtype
    pool = ParamDef((n_pages, page_size, hkv, hd), init="zeros", dtype=dtype)
    return stack_defs({"k_pages": pool, "v_pages": pool}, cfg.n_layers)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device: torch.device) -> dict:
    return build(paged_cache_defs(cfg, n_pages, page_size), device)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor an in-place scatter writes through: a 1-byte (fp8)
    tensor's ``uint8`` view (the same bytes), any other as it is."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _scatter(pool: torch.Tensor, idx: tuple, values: torch.Tensor) -> None:
    """``pool[idx] = values`` in place, ``values`` cast to the pool's
    dtype first."""
    _raw(pool).index_put_(idx, _raw(values.to(pool.dtype)))


def write_prefill(cfg: ModelConfig, paged: dict, dense: dict,
                  pages: torch.Tensor, page_size: int) -> None:
    """Scatter one request's dense prefill cache into the pools, in place.

    ``dense`` is a batch-1 ``transformer.prefill(..., full_kv=True)``
    cache; ``pages`` (int64) is the request's physical page per logical
    block (length >= ceil(bucket / page_size); spill entries may point at
    the scratch page).
    """
    for name, key in (("k_pages", "k"), ("v_pages", "v")):
        pool = paged[name]
        kv = torch.stack([_raw(c[key][0].to(pool.dtype))
                          for c in dense["layers"]])      # L, bucket, ..
        bucket = kv.shape[1]
        nb = num_blocks(bucket, page_size)
        pad = nb * page_size - bucket
        blocks = F.pad(kv, (0, 0, 0, 0, 0, pad)).reshape(
            kv.shape[0], nb, page_size, *kv.shape[2:])
        _raw(pool)[:, pages[:nb]] = blocks


def make_paged_attn_step(cfg: ModelConfig, block_tables: torch.Tensor,
                         page_size: int, use_kernel: bool = True,
                         fused: bool = False):
    """The ``attn_step`` the paged engine threads through
    ``transformer.decode_step`` for one token per request.

    ``pos`` is the per-request cached-token count (B,): the new token sits
    at position ``pos[b]``, its K/V are written into page
    ``block_tables[b, pos // page]`` slot ``pos % page`` (in place), and
    attention runs over ``pos + 1`` positions through
    ``ops.paged_attention`` (the flash-decode kernel) and the output
    projection.  ``fused=True`` (the engine's ``fuse``) runs attention
    and the output projection as one ``ops.paged_attention_oproj`` (the
    oproj-fused decode kernel): the heads' outputs never reach HBM.
    """
    def attn_step(p: dict, hn: torch.Tensor, cache: dict, pos: torch.Tensor,
                  window: int | None) -> torch.Tensor:
        b = hn.shape[0]
        hq, hd = cfg.n_heads, cfg.head_dim
        q, k, v = L.qkv_decode_proj(cfg, p, hn[:, 0], pos[:, None],
                                    use_kernel=use_kernel)
        rows = torch.arange(b, device=pos.device)
        page_idx = block_tables[rows, pos // page_size].long()
        slot_idx = (pos % page_size).long()
        kp, vp = cache["k_pages"], cache["v_pages"]
        _scatter(kp, (page_idx, slot_idx), k)
        _scatter(vp, (page_idx, slot_idx), v)
        if fused:
            out = ops.paged_attention_oproj(
                q, kp, vp, block_tables, pos + 1, p["wo"], window=window,
                logit_cap=cfg.attn_logit_cap, use_kernel=use_kernel)
            return out[:, None, :].to(hn.dtype)
        out = ops.paged_attention(q, kp, vp, block_tables, pos + 1,
                                  window=window,
                                  logit_cap=cfg.attn_logit_cap,
                                  use_kernel=use_kernel)
        return ops.linear(out.reshape(b, 1, hq * hd).to(hn.dtype), p["wo"],
                          use_kernel)

    return attn_step


def make_paged_span_step(cfg: ModelConfig, block_tables: torch.Tensor,
                         page_size: int, max_seq: int,
                         use_kernel: bool = True):
    """The span ``attn_step`` for multi-token ``transformer.decode_step``
    (chunked prefill).

    ``hn`` is (B, S, D): S consecutive tokens starting at position
    ``pos[b]``.  All S positions' K/V are written into the request's
    pages first, then ONE ``ops.paged_attention`` call with a
    (B, S, Hq, D) q block scores every position under its own causal
    limit.  Positions at or past ``max_seq`` (the padded tail of a final
    chunk) write harmlessly into the scratch page.

    The oproj-fused kernel is single-token, so spans keep the unfused
    attention and ``linear`` pair, as in JAX; under ``fuse`` the QKV
    projection and the MLP still fuse.
    """
    def attn_step(p: dict, hn: torch.Tensor, cache: dict, pos: torch.Tensor,
                  window: int | None) -> torch.Tensor:
        b, s, _ = hn.shape
        hq, hd = cfg.n_heads, cfg.head_dim
        positions = pos[:, None] + torch.arange(s, dtype=pos.dtype,
                                                device=pos.device)[None, :]
        q, k, v = L.qkv_span_proj(cfg, p, hn, positions,
                                  use_kernel=use_kernel)
        rows = torch.arange(b, device=pos.device)[:, None]
        nb = block_tables.shape[1]
        safe = positions < max_seq
        blk = torch.clamp(positions // page_size, max=nb - 1)
        page_idx = torch.where(safe, block_tables[rows, blk],
                               SCRATCH_PAGE).long()
        slot_idx = torch.where(safe, positions % page_size, 0).long()
        kp, vp = cache["k_pages"], cache["v_pages"]
        _scatter(kp, (page_idx, slot_idx), k)
        _scatter(vp, (page_idx, slot_idx), v)
        out = ops.paged_attention(q, kp, vp, block_tables, pos + 1,
                                  window=window,
                                  logit_cap=cfg.attn_logit_cap,
                                  use_kernel=use_kernel)   # (B, S, Hq, hd)
        return ops.linear(out.reshape(b, s, hq * hd).to(hn.dtype), p["wo"],
                          use_kernel)

    return attn_step


# ------------------------------- host side ---------------------------------


class PageAllocator:
    """Host-side refcounted free list over the page pool.

    Page 0 (``SCRATCH_PAGE``) is reserved and never handed out, which is
    what lets the engine mask inactive block-table rows to it.
    :meth:`share` takes an extra reference (for prefix sharing); a page
    returns to the free list when its last owner releases it.  Every
    transition is checked, so a leak or double free fails loudly.
    """

    def __init__(self, n_pages: int, metrics=None):
        if n_pages < 2:
            raise ValueError("need at least one scratch + one real page")
        self.n_pages = n_pages
        self._refs = np.zeros(n_pages, np.int32)
        self._free = list(range(n_pages - 1, 0, -1))   # page 0 reserved
        m = metrics if metrics is not None else MetricsRegistry()
        m.gauge("pages.capacity").set(self.capacity)
        self._m_in_use = m.gauge("pages.in_use")

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError("page pool exhausted")
        page = self._free.pop()
        assert self._refs[page] == 0, page
        self._refs[page] = 1
        self._m_in_use.set(self.in_use())
        return page

    def alloc_many(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        return [self.alloc() for _ in range(n)]

    def share(self, page: int) -> int:
        """Take an extra reference (shared prompt prefix)."""
        if page == SCRATCH_PAGE or self._refs[page] <= 0:
            raise ValueError(f"cannot share unowned page {page}")
        self._refs[page] += 1
        return page

    def free(self, page: int) -> None:
        if page == SCRATCH_PAGE:
            return                       # scratch is never owned
        if self._refs[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            self._m_in_use.set(self.in_use())

    def free_many(self, pages) -> None:
        for p in pages:
            self.free(int(p))
