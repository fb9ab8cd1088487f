"""Model assembly for dense, attention-only decoders (the port of
``repro.models.transformer`` for the serving and training paths).

A model is a stack of pre-norm blocks, each an attention mixer and a
SwiGLU FFN.  Parameters hold one entry per layer under ``"layers"`` and a
Python loop walks them, where the JAX package stacked layer groups and
scanned.  Other families (MoE, SSM, recurrent, encoder-decoder) are
later slices (``ROADMAP.md``, queue 1, item 11).

Training: :func:`forward` is the full-sequence forward and
:func:`loss_fn` the masked cross-entropy, with JAX's ``(total, {"loss",
"aux", "tokens"})`` result.  ``cfg.remat`` ``"block"`` and ``"full"``
checkpoint every block (``torch.utils.checkpoint``, non-reentrant), as
JAX checkpoints each pattern cycle; ``"dots"`` checkpoints every block
under a selective policy, JAX's ``dots_with_no_batch_dims_saveable``:
the outputs of matrix products without batch dimensions (``aten.mm``,
``aten.addmm``: the projections) are saved, everything else is
recomputed in the backward.  The port's CUDA GEMMs (blocked linears,
``ops.blocked_linear``) are ``autograd.Function`` s that launch through
ctypes, which the policy cannot see, so they are recomputed, as JAX
recomputes a ``pallas_call`` (not a dot).  ``"none"`` keeps every
activation.

Decoding: :func:`prefill` returns the per-layer caches and
:func:`decode_step` takes one token (or a span) over a cache.  With no
``attn_step`` it steps the dense cache (:func:`init_cache`, the static
engine's; ``layers.attention_decode``, a ring buffer for local layers),
as JAX's ``_block_decode`` does; the paged engine passes its own step.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import ParamDef, build, fan_in_scale, retype_defs
from repro_torch.models.config import ModelConfig
from repro_torch.util import resolve_device


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.is_encdec
            or cfg.prefix_tokens
            or any(m not in ("global", "local") for m in cfg.layer_pattern)):
        raise NotImplementedError(
            f"{cfg.name}: only dense attention-only decoders are ported; "
            "see ROADMAP.md, queue 1, item 11")


def block_defs(cfg: ModelConfig) -> dict:
    return {"norm1": L.rmsnorm_defs(cfg.d_model),
            "mixer": L.attention_defs(cfg),
            "norm2": L.rmsnorm_defs(cfg.d_model),
            "ffn": L.mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    defs: dict[str, Any] = {
        "embed": L.embedding_defs(cfg),
        "final_norm": L.rmsnorm_defs(cfg.d_model),
        "layers": [block_defs(cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, L.padded_vocab(cfg)),
                                   scale=fan_in_scale(cfg.d_model))
    return retype_defs(defs, cfg.dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters drawn from an explicit generator seeded with
    ``seed`` on ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build(model_defs(cfg), dev, gen)


def _window(cfg: ModelConfig, i: int) -> int | None:
    return cfg.window if cfg.mixer_for_layer(i) == "local" else None


def logits_fn(cfg: ModelConfig, params: dict,
              h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["embedding"].T
    else:
        logits = h @ params["lm_head"]
    if cfg.final_logit_cap is not None:
        logits = cfg.final_logit_cap * torch.tanh(
            logits.float() / cfg.final_logit_cap)
    return logits


def _block_apply(cfg: ModelConfig, p: dict, h: torch.Tensor, i: int,
                 positions: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    hn = L.rmsnorm(p["norm1"], h)
    h = h + L.attention_apply(cfg, p["mixer"], hn, positions, causal=True,
                              window=_window(cfg, i), use_kernel=use_kernel)
    return L.mlp_apply(p["ffn"], L.rmsnorm(p["norm2"], h), residual=h,
                       use_kernel=use_kernel)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    matrix products without batch dimensions, recompute the rest."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _remat_block(cfg, p, h, i, positions, use_kernel, blocked, fused):
    """One block under the caller's op switches: the backward recomputes
    it from autograd's own thread, where the switches' context variables
    have their defaults, so they are set again here."""
    with ops.blocked_linear(blocked), ops.fused_ops(fused):
        return _block_apply(cfg, p, h, i, positions, use_kernel)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  tokens (B, S) -> (hidden (B, S, D) after
    the final norm, aux loss: 0 for the dense family).  Under grad,
    ``cfg.remat`` decides which blocks are checkpointed (module
    docstring); ``use_kernel=False`` takes every kernel's plain
    version."""
    _check_ported(cfg)
    h = params["embed"]["embedding"][tokens] * (cfg.d_model ** 0.5)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    remat = torch.is_grad_enabled() and cfg.remat in ("block", "full",
                                                      "dots")
    switches = (ops.blocked_linear_enabled(), ops.fused_ops_enabled())
    extra = {"context_fn": _DOTS_CONTEXT} if cfg.remat == "dots" else {}
    for i, p in enumerate(params["layers"]):
        if remat:
            h = checkpoint(_remat_block, cfg, p, h, i, positions,
                           use_kernel, *switches, use_reentrant=False,
                           **extra)
        else:
            h = _block_apply(cfg, p, h, i, positions, use_kernel)
    h = L.rmsnorm(params["final_norm"], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
    """Cross-entropy LM loss over ``batch["tokens"]`` and
    ``batch["labels"]`` (label -1: not counted), in fp32.  Returns
    ``(total, {"loss", "aux", "tokens"})`` as JAX's ``loss_fn``."""
    for extra in ("prefix_embeds", "enc_embeds"):
        if batch.get(extra) is not None:
            raise NotImplementedError(
                f"{extra}: the multimodal and encoder-decoder families are "
                "not ported yet; see ROADMAP.md, queue 1, item 11")
    h, aux = forward(cfg, params, batch["tokens"], use_kernel=use_kernel)
    logits = logits_fn(cfg, params, h).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / mask.sum().clamp_min(1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux, "tokens": mask.sum()}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_seq: int, full_kv: bool = False,
            logits_at: int | None = None, use_kernel: bool = True):
    """Full-sequence forward that also returns the K/V caches.

    Returns (logits (B, V), cache) with ``cache["layers"][i]`` =
    ``{"k", "v"}`` of shape (B, max_seq, Hkv, D), or (B, min(window,
    max_seq), Hkv, D) for a local layer: the dense cache of
    :func:`init_cache`, a local layer's a ring buffer.  ``full_kv=True``
    keeps windowed layers position-indexed (the paged cache masks the
    window at decode time); ``logits_at`` returns that position's logits
    instead of the last one's (a bucketed prompt is right-padded).
    """
    h = params["embed"]["embedding"][tokens] * (cfg.d_model ** 0.5)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    caches = []
    for i, p in enumerate(params["layers"]):
        hn = L.rmsnorm(p["norm1"], h)
        out, cache = L.attention_apply(
            cfg, p["mixer"], hn, positions, causal=True,
            window=_window(cfg, i), return_cache=max_seq, full_cache=full_kv,
            use_kernel=use_kernel)
        h = h + out
        h = L.mlp_apply(p["ffn"], L.rmsnorm(p["norm2"], h), residual=h,
                        use_kernel=use_kernel)
        caches.append(cache)
    h = L.rmsnorm(params["final_norm"], h)
    at = s - 1 if logits_at is None else logits_at
    logits = logits_fn(cfg, params, h[:, at:at + 1, :])[:, 0, :]
    return logits, {"layers": caches}


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The dense decode cache's tree: ``{"layers": [{"k", "v"}, ...]}``,
    one entry per layer in execution order, like the parameters
    (``layers.attention_cache_defs``: a ring buffer of ``window`` slots
    for a local layer)."""
    _check_ported(cfg)
    return {"layers": [L.attention_cache_defs(cfg, batch, max_seq,
                                              _window(cfg, i))
                       for i in range(cfg.n_layers)]}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> dict:
    """The dense decode cache, zeros on ``device`` (default ``"cuda"``;
    raises without a GPU unless ``device="cpu"``)."""
    return build(cache_defs(cfg, batch, max_seq), resolve_device(device))


AttnStep = Callable[[dict, torch.Tensor, dict, torch.Tensor, "int | None"],
                    torch.Tensor]


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, attn_step: AttnStep | None = None,
                use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
    """One decode step.

    token: (B,) int -> logits (B, V); or (B, S), the span form (chunked
    prefill), whose S tokens occupy consecutive positions from ``pos`` ->
    logits (B, S, V).  ``attn_step(params, hn, layer_cache, pos, window)``
    is the attention implementation over a stacked cache
    (``serve.kv_cache.make_paged_attn_step`` / ``make_paged_span_step``);
    ``layer_cache`` holds layer i's slice of every stacked cache tensor,
    which the step updates in place.  Without one, the dense cache
    (:func:`init_cache` or :func:`prefill`'s, ``pos`` an int, the
    batch's one position) is stepped by ``layers.attention_decode``, as
    JAX's ``_block_decode`` does; the dense cache is one-token, so the
    span form then raises.  ``use_kernel=False`` gives every GEMM its
    plain version (a paged step carries its own choice).  Returns
    (logits, cache) with ``cache`` the same, updated object.
    """
    single = token.dim() == 1
    if not single and attn_step is None:
        raise ValueError("multi-token decode_step needs a span-capable "
                         "attn_step (the dense cache is one-token)")
    h = params["embed"]["embedding"][token[:, None] if single else token] \
        * (cfg.d_model ** 0.5)
    for i, p in enumerate(params["layers"]):
        hn = L.rmsnorm(p["norm1"], h)
        if attn_step is None:
            out, _ = L.attention_decode(cfg, p["mixer"], hn,
                                        cache["layers"][i], pos,
                                        window=_window(cfg, i),
                                        use_kernel=use_kernel)
        else:
            layer_cache = {k: v[i] for k, v in cache.items()}
            out = attn_step(p["mixer"], hn, layer_cache, pos, _window(cfg, i))
        h = h + out
        h = L.mlp_apply(p["ffn"], L.rmsnorm(p["norm2"], h), residual=h,
                        use_kernel=use_kernel)
    h = L.rmsnorm(params["final_norm"], h)
    logits = logits_fn(cfg, params, h)
    if single:
        logits = logits[:, 0, :]
    return logits, cache
