"""Public ops over the port's kernels (the counterpart of
``repro.kernels.ops`` for the serving path).

Each op runs its CUDA kernel through the kernel's wrapper, which
launches on CUDA tensors (or raises) and takes the plain version for CPU
tensors.  ``use_kernel=False`` is the caller's explicit choice of the
plain version on any device: the yardstick a kernel is held against on
the card, never a fallback.

``matmul`` asks the schedule tuner (``repro_torch.tune.best_schedule``)
for its tiles: a tuned, persisted schedule when one is cached for this
(op, shapes, dtype, device), else the blocking model's winner on the
Hopper target.  ``linear`` is a plain ``x @ w`` unless blocked linears
are enabled (``blocked_linear(True)`` or ``REPRO_BLOCKED_LINEAR=1``), in
which case every projection runs ``matmul``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_decode import flash_decode, paged_attention_ref
from repro_torch.kernels.matmul_blocked import matmul_blocked
from repro_torch.tune import best_schedule


def matmul(a: torch.Tensor, b: torch.Tensor,
           tiles: tuple[int, int, int] | None = None) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` through the blocked GEMM, with the tuned or
    model-derived tiles of the ``"matmul"`` key (``tiles`` pins them).
    Any shape launches: the kernel masks ragged edges itself."""
    m, k = a.shape
    n = b.shape[1]
    bm, bk, bn = tiles or best_schedule(
        "matmul", (m, n, k), str(a.dtype).removeprefix("torch.")).tiles
    return matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)


_BLOCKED_LINEAR: contextvars.ContextVar[bool | None] = \
    contextvars.ContextVar("repro_torch_blocked_linear", default=None)


def blocked_linear_enabled() -> bool:
    v = _BLOCKED_LINEAR.get()
    if v is None:
        return os.environ.get("REPRO_BLOCKED_LINEAR") == "1"
    return v


@contextlib.contextmanager
def blocked_linear(enable: bool = True):
    """Route model projections (``linear``) through the blocked GEMM
    while inside this context."""
    tok = _BLOCKED_LINEAR.set(bool(enable))
    try:
        yield
    finally:
        _BLOCKED_LINEAR.reset(tok)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection ``x @ w`` for any-rank x (w stored ``(d_in, d_out)``);
    the blocked GEMM when blocked linears are enabled
    (:func:`blocked_linear`)."""
    if not blocked_linear_enabled():
        return x @ w
    lead = x.shape[:-1]
    out = matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return out.reshape(*lead, w.shape[-1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              logit_cap: float | None = None,
              use_kernel: bool = True) -> torch.Tensor:
    """Multi-head attention with GQA.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq a multiple of Hkv.
    """
    fn = flash_attention if use_kernel else flash_attention_ref
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              window=window, logit_cap=logit_cap)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, window: int | None = None,
                    logit_cap: float | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Attention over a paged KV cache.

    q: (B, Hq, D) — one token per request; k/v_pages: (n_pages, page,
    Hkv, D); block_tables: (B, n_blocks) int32; lengths: (B,) int32, the
    cache length *including* the token being decoded.  Returns (B, Hq, D).

    A 4-D ``q`` of shape (B, S, Hq, D) is the multi-position form
    (chunked prefill): the S positions are consecutive, their K/V already
    scattered into the pages, and ``lengths`` counts the cache including
    the FIRST of them.  Rows fold into the kernel's group dim (``q_span =
    S``) so all S positions score in one flash-decode call over the same
    pages, each under its own causal limit.  Returns (B, S, Hq, D).
    """
    multi = q.dim() == 4
    if multi:
        b, span, hq, d = q.shape
    else:
        b, hq, d = q.shape
        span = 1
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads not a multiple of {hkv}")
    g = hq // hkv
    if multi:
        # (B, S, Hq, D) -> (B, Hkv, S*G, D), rows position-major inside
        # each kv head: row r of head h is position offset r // G
        qg = (q.transpose(1, 2)
               .reshape(b, hkv, g, span, d)
               .transpose(2, 3)
               .reshape(b, hkv, span * g, d))
    else:
        qg = q.reshape(b, hkv, g, d)
    fn = flash_decode if use_kernel else paged_attention_ref
    out = fn(qg.contiguous(), k_pages, v_pages, block_tables, lengths,
             window=window, logit_cap=logit_cap, q_span=span)
    if multi:
        return (out.reshape(b, hkv, span, g, d)
                   .transpose(1, 2)
                   .reshape(b, span, hq, d))
    return out.reshape(b, hq, d)
