"""Paged KV cache: fixed-size KV blocks + per-request block tables (the
port of ``repro.serve.kv_cache``).

Every attention layer owns a page pool ``(n_pages, page, Hkv, D)``; the
port stacks the attention layers' pools into one tensor per K and V,
``(n_attn, n_pages, page, Hkv, D)``, and each request holds a block
table mapping its logical KV blocks to physical pages.  Non-attention
mixers (RG-LRU, SSD) keep their O(1) states per batch slot beside the
pools (``cache["layers"]``): paging only applies to the linearly
growing K/V.  The page size is
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

Pages are position-agnostic, so two block tables may point at the same
physical page: the allocator refcounts owners
(:meth:`PageAllocator.share`) and :class:`PrefixCache` is the sharing
layer, a radix tree over full-page token spans mapping each span to its
page, so a new request's admission matches its longest cached prefix and
prefills only the tail.  Only full, frozen pages are shared; when a
shared page would be written (an exact full-page hit re-runs its last
token for the first-sample logits), the engine first copies it
(:func:`fork_page`, copy on write).

Page 0 is a reserved scratch page: inactive request slots keep all-zero
block tables, so their (masked, ignored) decode writes land there
instead of needing a branch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamDef, build, stack_defs
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import P
from repro_torch.obs.metrics import MetricsRegistry

SCRATCH_PAGE = 0


def num_blocks(length: int, page_size: int) -> int:
    return -(-length // page_size)


def choose_page_size(cfg: ModelConfig, max_seq: int, cache=None,
                     fused: bool = False,
                     reuse_rate: float | None = None) -> int:
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
    (``oproj_smem_bytes_required``).

    ``reuse_rate`` (prefix caching on) re-prices the tuned page for
    sharing against streaming (:func:`reuse_priced_page`): the tree
    shares only full pages, so small pages share better, while the
    decode kernel pays a fixed cost for every page it streams.
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
    page = max(1, min(sched.tiles[0], max_seq))
    if reuse_rate:
        return reuse_priced_page(page, max_seq, float(reuse_rate))
    return page


# per-page fixed streaming overhead, in token-equivalents: what one more
# page boundary costs the decode kernel (its block-table read and the
# page's copy start) against streaming one more KV token.  The access
# counts tie across page sizes (every KV element streams once), so this
# models the constant per-page work they cannot see.
PAGE_OVERHEAD_TOKENS = 0.25


def reuse_priced_page(tuned: int, max_seq: int, reuse_rate: float) -> int:
    """Share-against-stream page pricing for the prefix cache.

    Candidates are the whole-page divisors of ``max_seq`` from 8 and the
    tuned page.  Each candidate ``p`` scores, in expected re-streamed
    tokens a request:

    * **sharing loss** ``reuse_rate * (p - 1) / 2``: the tree shares full
      pages only, so a hit re-prefills the matched prefix's boundary
      slack, ``(p - 1) / 2`` tokens on average;
    * **streaming loss** ``PAGE_OVERHEAD_TOKENS * max_seq / p``: a
      full-length decode stream touches ``max_seq / p`` pages, each at
      the fixed per-page cost.

    ``reuse_rate -> 0`` gives back the tuned page; higher rates shrink
    it.  Ties go to the larger page.
    """
    tuned = max(1, min(tuned, max_seq))
    floor = min(8, max_seq)
    cands = {d for d in range(floor, max_seq + 1) if max_seq % d == 0}
    cands.add(tuned)

    def score(p: int) -> float:
        return (reuse_rate * (p - 1) / 2.0
                + PAGE_OVERHEAD_TOKENS * max_seq / p)

    return min(sorted(cands), key=lambda p: (score(p), -p))


def choose_prefill_chunk(cfg: ModelConfig, max_seq: int,
                         page_size: int) -> int:
    """Prefill chunk size from the same blocking model as the page size.

    A prefill chunk is one multi-position q block of the flash-decode
    kernel (``q_span = chunk``), so it is priced by the kernel's own
    footprint (``flash_decode.page_smem_bytes``: the instance that runs
    the model's dtype) against the shared memory budget the page was
    tuned under: the chunk is the largest power-of-two multiple of the
    page size (a whole number of pages) whose footprint still fits,
    capped at ``max_seq``.  On Hopper the kernels tile query rows across
    blocks (16 rows a block in bf16, 4 in fp32), so the span never
    enters the footprint and the rule returns the largest power-of-two
    whole-page chunk within ``max_seq`` -- the JAX rule's answer when
    nothing binds.
    """
    from repro_torch.core.hopper_adapter import default_smem_budget
    from repro_torch.kernels.flash_decode import page_smem_bytes
    kv_bytes = (cfg.kv_cache_dtype or cfg.dtype).itemsize
    fits = page_smem_bytes(page_size, cfg.head_dim, cfg.dtype.itemsize,
                           kv_bytes) <= default_smem_budget()
    chunk = min(page_size, max_seq)
    while fits and chunk * 2 <= max_seq:
        chunk *= 2
    return chunk


# ------------------------------ device side --------------------------------


def paged_cache_defs(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, model_ax: int = 1) -> dict:
    """The paged decode state: the K and V pools of every attention
    layer, stacked in layer order, ``(n_attn, n_pages, page, Hkv, D)``
    each (``transformer.attention_layers``), and ``"layers"``, one entry
    a layer: ``{}`` for an attention layer, the O(1) RG-LRU or SSD state
    of ``batch`` slots for the others (paging only applies to the
    linearly growing K/V).  Paged serving covers decoder-only token
    models, as in JAX.

    Specs at ``model_ax``, JAX's (``paged_attention_cache_defs``): a pool
    splits its kv heads over ``model`` where they divide, the stacking
    axis unsplit; the states take their dense specs.  Neither engine
    serves on a mesh, in either package."""
    if cfg.is_encdec or cfg.prefix_tokens:
        raise NotImplementedError(
            "paged serving covers decoder-only token models")
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    dtype = cfg.kv_cache_dtype or cfg.dtype
    skv = "model" if model_ax > 1 and hkv % model_ax == 0 else None
    pool = ParamDef((n_pages, page_size, hkv, hd), init="zeros", dtype=dtype,
                    spec=P(None, None, skv, None))
    defs = stack_defs({"k_pages": pool, "v_pages": pool},
                      len(T.attention_layers(cfg)))
    defs["layers"] = [
        {} if cfg.mixer_for_layer(i) in T.ATTENTION
        else T.layer_cache_defs(cfg, i, batch, 0, model_ax)
        for i in range(cfg.n_layers)]
    return defs


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, device: torch.device) -> dict:
    return build(paged_cache_defs(cfg, batch, n_pages, page_size), device)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor an in-place scatter writes through: a 1-byte (fp8)
    tensor's ``uint8`` view (the same bytes), any other as it is."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _scatter(pool: torch.Tensor, idx: tuple, values: torch.Tensor) -> None:
    """``pool[idx] = values`` in place, ``values`` cast to the pool's
    dtype first."""
    _raw(pool).index_put_(idx, _raw(values.to(pool.dtype)))


def write_prefill(cfg: ModelConfig, paged: dict, dense: dict, slot: int,
                  pages: torch.Tensor, page_size: int) -> None:
    """Write one request's dense prefill cache into the paged state, in
    place.

    ``dense`` is a batch-1 ``transformer.prefill(..., full_kv=True)``
    cache; ``pages`` (int64) is the request's physical page per logical
    block (length >= ceil(bucket / page_size); spill entries may point at
    the scratch page).  The attention layers' K/V land in the pools, the
    RG-LRU and SSD states at batch row ``slot``.
    """
    attn = T.attention_layers(cfg)
    if attn:
        for name, key in (("k_pages", "k"), ("v_pages", "v")):
            pool = paged[name]
            kv = torch.stack([_raw(dense["layers"][i][key][0].to(pool.dtype))
                              for i in attn])             # L, bucket, ..
            bucket = kv.shape[1]
            nb = num_blocks(bucket, page_size)
            pad = nb * page_size - bucket
            blocks = F.pad(kv, (0, 0, 0, 0, 0, pad)).reshape(
                kv.shape[0], nb, page_size, *kv.shape[2:])
            _raw(pool)[:, pages[:nb]] = blocks
    for state, dc in zip(paged["layers"], dense["layers"]):
        for key, t in state.items():
            t[slot] = dc[key][0].to(t.dtype)


def fork_page(cache: dict, src: int, dst: int) -> None:
    """Copy on write: page ``src`` into page ``dst`` in every layer's K
    and V pool, in place (through the ``uint8`` view of an fp8 pool)."""
    for pool in (cache["k_pages"], cache["v_pages"]):
        raw = _raw(pool)
        raw[:, dst] = raw[:, src]


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
    """The span ``attn_step`` for multi-token ``transformer.decode_step``:
    one definition behind both chunked prefill and the speculative
    verify.

    ``hn`` is (B, S, D): S consecutive tokens starting at position
    ``pos[b]``.  All S positions' K/V are written into the request's
    pages first, then ONE ``ops.paged_attention`` call with a
    (B, S, Hq, D) q block scores every position under its own causal
    limit.  Positions at or past ``max_seq`` (the padded tail of a final
    chunk, or draft rows past the token budget) write harmlessly into
    the scratch page, as do positions past the request's reserved pages
    (their block-table entries are the scratch page); positions inside
    ``max_seq`` but past a verify span's accepted prefix are overwritten
    by the next span before the length mask exposes them.

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

    Page 0 (``SCRATCH_PAGE``) is reserved and never handed out: it can
    never be allocated, shared or owned, which is what lets the engine
    mask inactive block-table rows to it, and why :class:`PrefixCache`
    refuses it.  :meth:`share` takes an extra reference (one for each
    owning request, and one held by the prefix tree itself); a page
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

    def refcount(self, page: int) -> int:
        """Current reference count (0 = free; scratch is always 0)."""
        return int(self._refs[page])

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


class _PrefixNode:
    """One full-page token span cached in the prefix tree."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent):
        self.key = key                  # tuple of page_size token ids
        self.page = page                # physical page holding the span's KV
        self.parent = parent
        self.children: dict = {}        # key -> _PrefixNode
        self.last_used = 0


class PrefixCache:
    """Radix tree over full-page token spans -> physical KV pages.

    Each node caches one page-aligned span of prompt tokens and the page
    holding that span's K/V; a root-to-node path spells a cached prompt
    prefix.  The tree holds its own allocator reference on every cached
    page (``refcount == owning requests + 1``), so a page outlives the
    request that prefilled it and later requests can :meth:`match` it:
    admission takes references instead of re-prefilling.

    Invariants (enforced here):

    * spans are always exactly ``page_size`` tokens;
    * the scratch page can never enter the tree;
    * eviction (:meth:`evict`) only frees LRU leaves whose sole reference
      is the tree's: a page a live request owns has ``refcount >= 2`` and
      is skipped, so sharing never frees a page under a reader.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 metrics=None):
        self.allocator = allocator
        self.page_size = page_size
        self._root = _PrefixNode((), -1, None)
        self._pages: dict[int, _PrefixNode] = {}   # page -> node
        self._clock = 0
        m = metrics if metrics is not None else MetricsRegistry()
        self._m_cached = m.gauge("prefix_cache.cached_pages")
        self._m_evicted = m.counter("prefix_cache.evicted_pages")

    def __len__(self) -> int:
        return len(self._pages)

    def pages(self) -> set[int]:
        """The set of physical pages the tree currently references."""
        return set(self._pages)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt) -> list[int]:
        """Pages of the longest cached full-page prefix of ``prompt``, in
        block order (possibly the whole prompt when its length is an
        exact page multiple: the caller then forks the last page before
        re-running the final token).  Bumps LRU on the matched path;
        takes no references (the caller shares each page it attaches)."""
        p = self.page_size
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        node, out, t = self._root, [], self._tick()
        for i in range(0, len(toks) - len(toks) % p, p):
            child = node.children.get(tuple(toks[i:i + p]))
            if child is None:
                break
            child.last_used = t
            out.append(child.page)
            node = child
        return out

    def insert(self, tokens, pages) -> int:
        """Register full, frozen prompt pages; returns the nodes added.

        ``tokens`` must be page-aligned and ``pages`` its physical page
        per block.  Spans already cached keep their page (the duplicate
        prefill is the caller's loss, not a correctness fault); new nodes
        take the tree's own reference (:meth:`PageAllocator.share`)."""
        p = self.page_size
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if len(toks) % p:
            raise ValueError(
                f"prefix spans must be page-aligned: {len(toks)} tokens "
                f"with page {p}")
        if len(toks) != len(pages) * p:
            raise ValueError(f"{len(toks)} tokens != {len(pages)} pages")
        node, added, t = self._root, 0, self._tick()
        for i, page in enumerate(pages):
            key = tuple(toks[i * p:(i + 1) * p])
            child = node.children.get(key)
            if child is None:
                page = int(page)
                if page == SCRATCH_PAGE:
                    raise ValueError(
                        "scratch page can never enter the prefix tree")
                if page in self._pages:
                    raise ValueError(
                        f"page {page} already cached under another span")
                self.allocator.share(page)     # the tree's own reference
                child = _PrefixNode(key, page, node)
                node.children[key] = child
                self._pages[page] = child
                added += 1
            child.last_used = t
            node = child
        self._m_cached.set(len(self._pages))
        return added

    def evict(self, n_pages: int, protect=frozenset()) -> int:
        """Free up to ``n_pages`` pages from LRU leaves the tree alone
        owns (``refcount == 1``); returns how many were freed.

        Pages in ``protect`` (a just-matched path the caller is about to
        attach) and pages a live request owns are never touched; an inner
        node becomes evictable only once its subtree is gone, so a cached
        span never loses the prefix that gives it meaning."""
        freed = 0
        while freed < n_pages:
            victim = None
            for node in self._pages.values():
                if (node.children or node.page in protect
                        or self.allocator.refcount(node.page) != 1):
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            del self._pages[victim.page]
            self.allocator.free(victim.page)
            freed += 1
        self._m_evicted.inc(freed)
        self._m_cached.set(len(self._pages))
        return freed
