"""Model assembly for every arch family of the reference (the port of
``repro.models.transformer``).

A model is a stack of pre-norm blocks; each block has a *mixer* chosen
by ``cfg.layer_pattern`` ("global" / "local" attention, "recurrent"
RG-LRU, "ssd" Mamba-2) and an FFN (the dense MLP, the top-k MoE, or none
for the pure-SSD stack).  Parameters hold one entry per layer under
``"layers"``, in execution order, and a Python loop walks them, where the
JAX package stacked each pattern entry's layers and scanned
(``convert.params_from_numpy`` maps one layout to the other).

Encoder-decoder (seamless-m4t) adds a bidirectional encoder over the
frontend stub's embeddings (``params["encoder"]``: its layers and final
norm) and a cross-attention in every decoder block (row 4, non-causal,
over the encoder's output).  The vision-prefix family (phi-3-vision)
concatenates the stub's prefix embeddings ahead of the token
embeddings; the loss drops the prefix positions.

Training: :func:`forward` is the full-sequence forward and
:func:`loss_fn` the masked cross-entropy plus ``0.01 * aux`` (the MoE
load-balance loss), with JAX's ``(total, {"loss", "aux", "tokens"})``
result.  ``cfg.remat`` ``"block"`` and ``"full"`` checkpoint every block
(``torch.utils.checkpoint``, non-reentrant), as JAX checkpoints each
pattern cycle; ``"dots"`` checkpoints every block under a selective
policy, JAX's ``dots_with_no_batch_dims_saveable``: the outputs of
matrix products without batch dimensions (``aten.mm``, ``aten.addmm``:
the projections) are saved, everything else is recomputed in the
backward.  The port's CUDA GEMMs (blocked linears, ``ops.blocked_linear``)
are ``autograd.Function`` s that launch through ctypes, which the policy
cannot see, so they are recomputed, as JAX recomputes a ``pallas_call``
(not a dot).  ``"none"`` keeps every activation.

Decoding: :func:`prefill` returns the per-layer caches (attention K/V,
the O(1) RG-LRU and SSD states, the cross K/V) and :func:`decode_step`
takes one token (or, for attention-only stacks, a span) over a cache.
With no ``attn_step`` it steps the dense cache (:func:`init_cache`, the
static engine's; ``layers.attention_decode``, a ring buffer for local
layers), as JAX's ``_block_decode`` does; the paged engine passes its
own step and a paged cache (``serve.kv_cache.init_paged_cache``).  The
recurrent and SSD states, and the attention caches, are updated in
place.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import sharding, spmd
from repro_torch.models.base import (ParamDef, build, fan_in_scale,
                                     retype_defs, shape_tree, spec_tree)
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import P
from repro_torch.util import resolve_device

ATTENTION = ("global", "local")

# ------------------------------ block defs ---------------------------------


def _mixer_defs(cfg: ModelConfig, mixer: str, model_ax: int) -> dict:
    if mixer in ATTENTION:
        return L.attention_defs(cfg, model_ax)
    if mixer == "recurrent":
        return L.rglru_defs(cfg, model_ax)
    if mixer == "ssd":
        return L.ssd_defs(cfg, model_ax)
    raise ValueError(mixer)


def _ffn_defs(cfg: ModelConfig, model_ax: int) -> dict | None:
    if cfg.n_experts:
        return L.moe_defs(cfg, model_ax)
    if cfg.d_ff:
        return L.mlp_defs(cfg, model_ax)
    return None  # the pure-SSM stack has no separate FFN


def block_defs(cfg: ModelConfig, mixer: str, cross: bool = False,
               model_ax: int = 1) -> dict:
    d = {"norm1": L.rmsnorm_defs(cfg.d_model),
         "mixer": _mixer_defs(cfg, mixer, model_ax)}
    ffn = _ffn_defs(cfg, model_ax)
    if ffn is not None:
        d["norm2"] = L.rmsnorm_defs(cfg.d_model)
        d["ffn"] = ffn
    if cross:
        d["norm_x"] = L.rmsnorm_defs(cfg.d_model)
        d["cross"] = L.attention_defs(cfg, model_ax)
    return d


def model_defs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    """The parameter tree's declaration at ``model_ax`` (the model axis's
    size): JAX's shapes (the vocab padded to ``16 * model_ax``) and
    partition specs, one entry per layer (JAX stacks each pattern
    entry's layers under a leading unsharded axis)."""
    v = L.padded_vocab(cfg, model_ax)
    defs: dict[str, Any] = {
        "embed": L.embedding_defs(cfg, model_ax),
        "final_norm": L.rmsnorm_defs(cfg.d_model),
        "layers": [block_defs(cfg, cfg.mixer_for_layer(i),
                              cross=cfg.is_encdec, model_ax=model_ax)
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef(
            (cfg.d_model, v), scale=fan_in_scale(cfg.d_model),
            spec=P("data", L._shard_if(v, model_ax)))
    if cfg.is_encdec:
        defs["encoder"] = {
            "layers": [block_defs(cfg, "global", model_ax=model_ax)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.rmsnorm_defs(cfg.d_model),
        }
    return retype_defs(defs, cfg.dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                model_ax: int = 1) -> dict:
    """Random parameters (the full tree at ``model_ax``) drawn from an
    explicit generator seeded with ``seed`` on ``device`` (default
    ``"cuda"``; raises without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build(model_defs(cfg, model_ax), dev, gen)


def jax_stacking(cfg: ModelConfig) -> list[int]:
    """For every parameter leaf (``optim.adamw.leaves`` order), the id of
    the JAX tensor that holds it: JAX stacks pattern entry j's layers of
    the whole cycles into one tensor a leaf (the remainder layers and
    the rest are tensors of their own), and the encoder's layers into
    one.  Where JAX computes one number per tensor (the gradient
    compression's scale), the port computes it over the leaves of an
    id."""
    period = len(cfg.layer_pattern)
    stacked = cfg.n_layers // period * period
    keys: dict = {}
    ids: list[int] = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            if path[0] == "layers" and path[1] < stacked:
                path = ("layers", path[1] % period) + path[2:]
            elif path[:2] == ("encoder", "layers"):
                path = path[:2] + path[3:]
            ids.append(keys.setdefault(path, len(keys)))
    walk(model_defs(cfg), ())
    return ids


def param_shapes(cfg: ModelConfig, model_ax: int = 1) -> dict:
    """The parameter tree at ``model_ax`` as meta tensors (global
    shapes, no allocation)."""
    return shape_tree(model_defs(cfg, model_ax))


def param_specs(cfg: ModelConfig, model_ax: int = 1) -> dict:
    """The parameter tree's partition specs at ``model_ax`` (canonical
    axis names; ``sharding.translate_tree`` maps them onto a mesh)."""
    return spec_tree(model_defs(cfg, model_ax))


def _window(cfg: ModelConfig, i: int) -> int | None:
    return cfg.window if cfg.mixer_for_layer(i) == "local" else None


def attention_layers(cfg: ModelConfig) -> list[int]:
    """The attention layers' indices, in order: the paged cache stacks
    their pools in this order."""
    return [i for i in range(cfg.n_layers)
            if cfg.mixer_for_layer(i) in ATTENTION]


def attention_only(cfg: ModelConfig) -> bool:
    return all(m in ATTENTION for m in cfg.layer_pattern)


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


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           prefix_embeds: torch.Tensor | None) -> torch.Tensor:
    """The scaled token embeddings, the prefix's rows ahead of them (on
    a mesh the vocab-parallel lookup, :func:`_embed_mesh`, and the
    rank's rows of the prefix)."""
    ctx = sharding.active()
    if ctx is None:
        h = params["embed"]["embedding"][tokens] * (cfg.d_model ** 0.5)
    else:
        h = _embed_mesh(cfg, params, tokens, ctx)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor,
         use_kernel: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN half (h + FFN(norm2(h))) and the MoE aux loss
    (None for the dense MLP).  On a mesh the MLP is column- then
    row-parallel where the model axis divides d_ff."""
    if "ffn" not in p:
        return h, None
    hf = L.rmsnorm(p["norm2"], h)
    if cfg.n_experts:
        out, aux = L.moe_apply(cfg, p["ffn"], hf)
        return h + out, aux
    ctx = sharding.active()
    if ctx is None:
        return L.mlp_apply(p["ffn"], hf, residual=h,
                           use_kernel=use_kernel), None
    group = ctx.model_group if L._shard_if(cfg.d_ff, ctx.model_ax) else None
    out = L.mlp_apply(p["ffn"], spmd.copy_to(hf, group),
                      use_kernel=use_kernel)
    return h + spmd.reduce_from(out, group), None


# ------------------------------ on a mesh ----------------------------------
#
# Under ``sharding.use_mesh`` the functions below take the rank's local
# shards of JAX's specs (``param_specs(cfg, ctx.model_ax)``,
# ``models.spmd.shard_params``) and its batch rows; ``models/spmd.py``
# says how the collectives stand in for XLA's partitioner.


def _mixer_group(cfg: ModelConfig, mixer: str, ctx):
    """The RG-LRU's or SSD's tensor-parallel group (``L.rglru_apply``,
    ``L.ssd_apply``): the model axis's where it splits the mixer's width,
    else None (off a mesh, or the leaves replicated over it)."""
    width = cfg.lru_width if mixer == "recurrent" else cfg.d_inner
    if ctx is None or not L._shard_if(width, ctx.model_ax):
        return None
    return ctx.model_group


def _layer_specs(cfg: ModelConfig, i: int, model_ax: int) -> dict:
    return spec_tree(block_defs(cfg, cfg.mixer_for_layer(i),
                                cross=cfg.is_encdec, model_ax=model_ax))


def _gathered(params: dict, name: str, specs: dict, ctx) -> torch.Tensor:
    return spmd.gather_tree({name: params[name]}, {name: specs[name]},
                            ctx)[name]


def _embed_mesh(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                ctx) -> torch.Tensor:
    """The vocab-parallel embedding of the rank's token rows."""
    specs = L.embedding_defs(cfg, ctx.model_ax)
    emb = _gathered(params["embed"], "embedding", spec_tree(specs), ctx)
    h = spmd.vocab_embed(emb, tokens, ctx, ctx.model_ax > 1)
    return h * (cfg.d_model ** 0.5)


def _logits_mesh(cfg: ModelConfig, params: dict, h: torch.Tensor,
                 ctx) -> torch.Tensor:
    """The rank's vocabulary shard of the logits (column-parallel over
    the model axis), capped as :func:`logits_fn` caps them."""
    group = ctx.model_group if ctx.model_ax > 1 else None
    ht = spmd.copy_to(h, group)
    v = L.padded_vocab(cfg, ctx.model_ax)
    if cfg.tie_embeddings:
        specs = spec_tree(L.embedding_defs(cfg, ctx.model_ax))
        logits = ht @ _gathered(params["embed"], "embedding", specs, ctx).T
    else:
        spec = P("data", L._shard_if(v, ctx.model_ax))
        logits = ht @ _gathered(params, "lm_head", {"lm_head": spec}, ctx)
    if cfg.final_logit_cap is not None:
        logits = cfg.final_logit_cap * torch.tanh(
            logits.float() / cfg.final_logit_cap)
    return logits


def _full_vocab(logits: torch.Tensor, ctx) -> torch.Tensor:
    """Logits with every vocabulary shard (gathered over the model
    axis)."""
    if ctx.model_ax > 1:
        return spmd.all_gather(logits, logits.dim() - 1, ctx.model_group)
    return logits


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     enc_out: torch.Tensor,
                     use_kernel: bool) -> torch.Tensor:
    """The decoder's cross-attention over the encoder's output: row 4,
    non-causal, Sq = the decoder's length, Skv = the encoder's (no
    rope, the projections plain products, as in JAX).

    On a mesh it is tensor parallel as the self-attention is
    (``spmd.head_plan``): the rank's query heads, K/V of the
    (replicated) encoder output by its kv heads (``L._kv_weights``),
    ``wo`` row-parallel."""
    ctx = sharding.active()
    b, s, _ = x.shape
    hd, se = cfg.head_dim, enc_out.shape[1]
    _, hq, kv = spmd.head_plan(cfg, ctx)
    group = ctx.model_group if spmd.tp_split(cfg, ctx) else None
    xt, et = spmd.copy_to(x, group), spmd.copy_to(enc_out, group)
    wk, wv = L._kv_weights(cfg, p, kv, group,
                           ctx.model_ax if ctx is not None else 1, x.device)
    q = (xt @ p["wq"]).reshape(b, s, hq, hd)
    k = (et @ wk).reshape(b, se, len(kv), hd)
    v = (et @ wv).reshape(b, se, len(kv), hd)
    out = ops.attention(q, k, v, causal=False, use_kernel=use_kernel)
    return spmd.reduce_from(out.reshape(b, s, hq * hd) @ p["wo"], group)


def _cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor) -> dict:
    """A layer's cross K/V cache, (B, Se, Hkv, D) each, in the model
    dtype: every kv head, as JAX's spec replicates it over the model
    axis (on a mesh whose model axis splits the kv heads, the rank's
    ``wk``/``wv`` columns are gathered first)."""
    ctx = sharding.active()
    wk, wv = p["cross"]["wk"], p["cross"]["wv"]
    if ctx is not None and L.attention_specs(cfg, ctx.model_ax)[1]:
        wk, wv = (spmd.all_gather(w, 1, ctx.model_group) for w in (wk, wv))
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.n_kv_heads, cfg.head_dim)
    return {"cross_k": (enc_out @ wk).reshape(shape).to(cfg.dtype),
            "cross_v": (enc_out @ wv).reshape(shape).to(cfg.dtype)}


def _encoder_apply(cfg: ModelConfig, params: dict, embeds: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """The bidirectional encoder over the frontend stub's embeddings (B,
    Se, D): row 4 non-causal at Sq = Skv = Se, then the MLP; returns
    its output after the final norm.  On a mesh each layer is gathered
    under the encoder's specs (``param_specs``' ``("encoder",
    "layers")``) and runs the sharded attention and the MLP's
    tensor-parallel pair (:func:`_ffn`)."""
    ctx = sharding.active()
    enc = params["encoder"]
    b, se, _ = embeds.shape
    positions = torch.arange(se, device=embeds.device).expand(b, se)
    h = embeds.to(cfg.dtype)
    attn = L.attention_apply if ctx is None else L.attention_apply_mesh
    specs = None if ctx is None else spec_tree(block_defs(
        cfg, "global", model_ax=ctx.model_ax))
    for p in enc["layers"]:
        if ctx is not None:
            p = spmd.gather_tree(p, specs, ctx)
        hn = L.rmsnorm(p["norm1"], h)
        h = h + attn(cfg, p["mixer"], hn, positions, causal=False,
                     use_kernel=use_kernel)
        h, _ = _ffn(cfg, p, h, use_kernel)
    return L.rmsnorm(enc["final_norm"], h)


def _block_apply(cfg: ModelConfig, p: dict, h: torch.Tensor, i: int,
                 positions: torch.Tensor, enc_out: torch.Tensor | None,
                 use_kernel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One block: (h, its MoE aux loss, 0 for the other FFNs).  On a
    mesh the layer's weights are all-gathered over the batch axes first
    (FSDP; under remat the backward gathers them again)."""
    mixer = cfg.mixer_for_layer(i)
    ctx = sharding.active()
    if ctx is not None:
        p = spmd.gather_tree(p, _layer_specs(cfg, i, ctx.model_ax), ctx)
    hn = L.rmsnorm(p["norm1"], h)
    if mixer in ATTENTION:
        attn = L.attention_apply if ctx is None else L.attention_apply_mesh
        h = h + attn(cfg, p["mixer"], hn, positions, causal=True,
                     window=_window(cfg, i), use_kernel=use_kernel)
    elif mixer == "recurrent":
        h = h + L.rglru_apply(cfg, p["mixer"], hn,
                              group=_mixer_group(cfg, mixer, ctx))
    else:
        h = h + L.ssd_apply(cfg, p["mixer"], hn,
                            group=_mixer_group(cfg, mixer, ctx))
    if enc_out is not None and "cross" in p:
        h = h + _cross_attention(cfg, p["cross"],
                                 L.rmsnorm(p["norm_x"], h), enc_out,
                                 use_kernel)
    h, aux = _ffn(cfg, p, h, use_kernel)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    matrix products without batch dimensions, recompute the rest."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _remat_block(cfg, p, h, i, positions, enc_out, use_kernel, blocked,
                 fused):
    """One block under the caller's op switches: the backward recomputes
    it from autograd's own thread, where the switches' context variables
    have their defaults, so they are set again here."""
    with ops.blocked_linear(blocked), ops.fused_ops(fused):
        return _block_apply(cfg, p, h, i, positions, enc_out, use_kernel)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None,
            use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  tokens (B, S) -> (hidden (B, P + S, D)
    after the final norm, P the prefix's length, and the summed MoE aux
    loss, 0 for the other families).  ``enc_embeds`` (B, Se, D) is the
    encoder-decoder's input, required for that family.  Under grad,
    ``cfg.remat`` decides which blocks are checkpointed (module
    docstring); ``use_kernel=False`` takes every kernel's plain
    version.

    Under ``sharding.use_mesh`` ``params`` are the rank's shards and
    ``tokens``, ``prefix_embeds`` and ``enc_embeds`` its batch rows; the
    hidden state returned is its rows', replicated over the model
    axis."""
    h = _embed(cfg, params, tokens, prefix_embeds)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "enc_embeds")
        enc_out = _encoder_apply(cfg, params, enc_embeds, use_kernel)
    remat = torch.is_grad_enabled() and cfg.remat in ("block", "full",
                                                      "dots")
    switches = (ops.blocked_linear_enabled(), ops.fused_ops_enabled())
    extra = {"context_fn": _DOTS_CONTEXT} if cfg.remat == "dots" else {}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, p in enumerate(params["layers"]):
        if remat:
            h, aux = checkpoint(_remat_block, cfg, p, h, i, positions,
                                enc_out, use_kernel, *switches,
                                use_reentrant=False, **extra)
        else:
            h, aux = _block_apply(cfg, p, h, i, positions, enc_out,
                                  use_kernel)
        aux_total = aux_total + aux
    h = L.rmsnorm(params["final_norm"], h)
    return h, aux_total


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
    """Cross-entropy LM loss over ``batch["tokens"]`` and
    ``batch["labels"]`` (label -1: not counted), in fp32, on the text
    positions only (a ``prefix_embeds`` prefix is dropped), plus ``0.01
    * aux``.  ``batch`` carries the modality extras ``prefix_embeds`` and
    ``enc_embeds`` where the family has them.  Returns ``(total,
    {"loss", "aux", "tokens"})`` as JAX's ``loss_fn``.

    On a mesh the batch is the rank's rows: the logits stay split over
    the vocabulary (``spmd.vocab_cross_entropy``), the token count is
    the global one, and ``total`` is the rank's rows' share of the
    global mean (plus ``0.01 * aux``), whose gradients summed over the
    batch axes are the global ones; the metrics are global."""
    ctx = sharding.active()
    if ctx is not None:
        return _loss_mesh(cfg, params, batch, use_kernel, ctx)
    prefix = batch.get("prefix_embeds")
    h, aux = forward(cfg, params, batch["tokens"], prefix_embeds=prefix,
                     enc_embeds=batch.get("enc_embeds"),
                     use_kernel=use_kernel)
    if prefix is not None:
        h = h[:, prefix.shape[1]:, :]                  # loss on text only
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


def _loss_mesh(cfg: ModelConfig, params: dict, batch: dict,
               use_kernel: bool, ctx) -> tuple[torch.Tensor, dict]:
    prefix = batch.get("prefix_embeds")
    h, aux = forward(cfg, params, batch["tokens"], prefix_embeds=prefix,
                     enc_embeds=batch.get("enc_embeds"),
                     use_kernel=use_kernel)
    if prefix is not None:
        h = h[:, prefix.shape[1]:, :]                  # loss on text only
    logits = _logits_mesh(cfg, params, h, ctx).float()
    nll, mask = spmd.vocab_cross_entropy(logits, batch["labels"], ctx,
                                         ctx.model_ax > 1)
    mask = mask.float()
    count = mask.sum()
    if ctx.batch_group is not None:
        count = spmd.all_reduce(count, ctx.batch_group)
    loss = (nll * mask).sum() / count.clamp_min(1.0)
    total = loss + 0.01 * aux
    glob = loss.detach()
    if ctx.batch_group is not None:
        glob = spmd.all_reduce(glob, ctx.batch_group)
    return total, {"loss": glob, "aux": aux.detach(), "tokens": count}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_seq: int, prefix_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None, full_kv: bool = False,
            logits_at: int | None = None, use_kernel: bool = True):
    """Full-sequence forward that also returns the decode caches.

    Returns (logits (B, V), cache) with ``cache["layers"][i]`` layer i's
    cache: ``{"k", "v"}`` of shape (B, max_seq, Hkv, D) for a global
    layer, (B, min(window, max_seq), Hkv, D) for a local one (a ring
    buffer); ``{"conv", "h"}`` for an RG-LRU layer and ``{"conv",
    "state"}`` for an SSD one (O(1) in the sequence); an
    encoder-decoder's layers add ``{"cross_k", "cross_v"}``.  This is
    the dense cache of :func:`init_cache`.  ``full_kv=True`` keeps
    windowed layers position-indexed (the paged cache masks the window
    at decode time); ``logits_at`` returns that position's logits
    instead of the last one's (a bucketed prompt is right-padded; a
    prefix's positions count).

    Under ``sharding.use_mesh`` ``params`` are the rank's shards and
    ``tokens`` (and the extras) its batch rows; the caches come back as
    the rank's shards of :func:`cache_specs` and the logits are its
    rows' over the whole vocabulary.
    """
    ctx = sharding.active()
    h = _embed(cfg, params, tokens, prefix_embeds)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "enc_embeds")
        enc_out = _encoder_apply(cfg, params, enc_embeds, use_kernel)
    caches = []
    for i, p in enumerate(params["layers"]):
        mixer = cfg.mixer_for_layer(i)
        if ctx is not None:
            p = spmd.gather_tree(p, _layer_specs(cfg, i, ctx.model_ax), ctx)
        hn = L.rmsnorm(p["norm1"], h)
        if mixer in ATTENTION:
            attn = L.attention_apply if ctx is None else \
                L.attention_apply_mesh
            out, cache = attn(cfg, p["mixer"], hn, positions, causal=True,
                              window=_window(cfg, i), return_cache=max_seq,
                              full_cache=full_kv, use_kernel=use_kernel)
        elif mixer == "recurrent":
            out, cache = L.rglru_apply(cfg, p["mixer"], hn,
                                       return_cache=True,
                                       group=_mixer_group(cfg, mixer, ctx))
        else:
            out, cache = L.ssd_apply(cfg, p["mixer"], hn, return_cache=True,
                                     group=_mixer_group(cfg, mixer, ctx))
        h = h + out
        if enc_out is not None:
            h = h + _cross_attention(cfg, p["cross"],
                                     L.rmsnorm(p["norm_x"], h), enc_out,
                                     use_kernel)
            cache.update(_cross_kv(cfg, p, enc_out))
        h, _ = _ffn(cfg, p, h, use_kernel)
        if ctx is not None:
            defs = layer_cache_defs(
                cfg, i, b * ctx.batch_size, max_seq, ctx.model_ax,
                full_kv=full_kv,
                enc_seq=enc_out.shape[1] if enc_out is not None else None)
            cache = {k: sharding.maybe_shard(c, defs[k].spec, defs[k].shape)
                     for k, c in cache.items()}
        caches.append(cache)
    h = L.rmsnorm(params["final_norm"], h)
    at = s - 1 if logits_at is None else logits_at
    h = h[:, at:at + 1, :]
    if ctx is None:
        return logits_fn(cfg, params, h)[:, 0, :], {"layers": caches}
    logits = _logits_mesh(cfg, params, h, ctx)[:, 0, :]
    return _full_vocab(logits, ctx), {"layers": caches}


def layer_cache_defs(cfg: ModelConfig, i: int, batch: int,
                     max_seq: int, model_ax: int = 1, full_kv: bool = False,
                     enc_seq: int | None = None) -> dict:
    """Layer i's dense decode cache: the attention K/V
    (``layers.attention_cache_defs``: a ring buffer of ``window`` slots
    for a local layer, position-indexed under ``full_kv``), or the O(1)
    RG-LRU or SSD state; with ``enc_seq`` (an encoder-decoder) the
    (B, enc_seq, Hkv, D) cross K/V too, replicated over the model axis
    as in JAX."""
    mixer = cfg.mixer_for_layer(i)
    if mixer in ATTENTION:
        d = L.attention_cache_defs(cfg, batch, max_seq,
                                   None if full_kv else _window(cfg, i),
                                   model_ax)
    elif mixer == "recurrent":
        d = L.rglru_cache_defs(cfg, batch, model_ax)
    else:
        d = L.ssd_cache_defs(cfg, batch, model_ax)
    if enc_seq is not None:
        kv = ParamDef((batch, enc_seq, cfg.n_kv_heads, cfg.head_dim),
                      init="zeros", dtype=cfg.dtype,
                      spec=P("data", None, None, None))
        d = {**d, "cross_k": kv, "cross_v": kv}
    return d


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int,
               enc_seq: int = 0, model_ax: int = 1) -> dict:
    """The dense decode cache's tree: ``{"layers": [layer cache, ...]}``,
    one entry per layer in execution order, like the parameters
    (:func:`layer_cache_defs`; an encoder-decoder's entries add the
    cross K/V).  Specs at ``model_ax``, JAX's."""
    enc = enc_seq if cfg.is_encdec else None
    return {"layers": [layer_cache_defs(cfg, i, batch, max_seq, model_ax,
                                        enc_seq=enc)
                       for i in range(cfg.n_layers)]}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                model_ax: int = 1, enc_seq: int = 0) -> dict:
    """The dense cache's partition specs (JAX's argument order)."""
    return spec_tree(cache_defs(cfg, batch, max_seq, enc_seq, model_ax))


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                 model_ax: int = 1, enc_seq: int = 0) -> dict:
    """The dense cache as meta tensors (global shapes)."""
    return shape_tree(cache_defs(cfg, batch, max_seq, enc_seq, model_ax))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda",
               enc_seq: int = 0) -> dict:
    """The dense decode cache, zeros on ``device`` (default ``"cuda"``;
    raises without a GPU unless ``device="cpu"``)."""
    return build(cache_defs(cfg, batch, max_seq, enc_seq),
                 resolve_device(device))


def prefill_cross_cache(cfg: ModelConfig, params: dict, cache: dict,
                        enc_embeds: torch.Tensor,
                        use_kernel: bool = True) -> dict:
    """Encoder-decoder: run the encoder once and write every layer's
    cross K/V into ``cache`` (in place); returns ``cache``."""
    enc_out = _encoder_apply(cfg, params, enc_embeds, use_kernel)
    for p, c in zip(params["layers"], cache["layers"]):
        c.update(_cross_kv(cfg, p, enc_out))
    return cache


def _cross_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over the cached cross K/V: fp32
    ``einsum`` s outside any kernel, as in JAX.  On a mesh the rank's
    query heads attend over their kv heads of the (replicated) cache,
    and ``wo``'s partial sums are all-reduced."""
    ctx = sharding.active()
    b, hd = x.shape[0], cfg.head_dim
    _, hq, kv = spmd.head_plan(cfg, ctx)
    group = ctx.model_group if spmd.tp_split(cfg, ctx) else None
    if kv != list(range(ck.shape[2])):
        idx = torch.tensor(kv, device=x.device)
        ck, cv = ck.index_select(2, idx), cv.index_select(2, idx)
    qh = (x @ p["wq"]).reshape(b, len(kv), hq // len(kv), hd)
    logits = torch.einsum("bhgd,blhd->bhgl", qh.float(),
                          ck.float()) * hd ** -0.5
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", probs, cv.float())
    return spmd.reduce_from(out.reshape(b, 1, hq * hd).to(x.dtype)
                            @ p["wo"], group)


AttnStep = Callable[[dict, torch.Tensor, dict, torch.Tensor, "int | None"],
                    torch.Tensor]


def _set_state(cache: dict, new: dict) -> None:
    for k, v in new.items():
        cache[k].copy_(v)


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, attn_step: AttnStep | None = None,
                use_kernel: bool = True,
                max_seq: int | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step.

    token: (B,) int -> logits (B, V); or (B, S), the span form (chunked
    prefill, speculative verify), whose S tokens occupy consecutive
    positions from ``pos`` -> logits (B, S, V).  The span form needs a
    span-capable ``attn_step`` and an attention-only stack (the RG-LRU
    and SSD updates are one-token), as in JAX.

    ``attn_step(params, hn, layer_cache, pos, window)`` is the attention
    implementation over a paged cache (``serve.kv_cache.
    make_paged_attn_step`` / ``make_paged_span_step``;
    ``init_paged_cache``'s tree): an attention layer's ``layer_cache``
    holds its pools, the stacked ``k_pages``/``v_pages`` at its index
    among the attention layers, which the step updates in place.
    Without one, the dense cache (:func:`init_cache` or
    :func:`prefill`'s, ``pos`` an int, the batch's one position) is
    stepped by ``layers.attention_decode``, as JAX's ``_block_decode``
    does.  Either way an RG-LRU or SSD layer's state is
    ``cache["layers"][i]``, advanced in place for every row of the
    batch, and an encoder-decoder's layers attend over their cached
    cross K/V.  ``use_kernel=False`` gives every GEMM its plain version
    (a paged step carries its own choice).  Returns (logits, cache) with
    ``cache`` the same, updated object.

    Under ``sharding.use_mesh`` (the dense cache, one token a row)
    ``params`` and ``cache`` are the rank's shards, ``token`` its rows,
    and ``max_seq`` the cache's global length (which says how it splits:
    ``layers.attention_cache_defs``); the logits are its rows' over the
    whole vocabulary.
    """
    ctx = sharding.active()
    single = token.dim() == 1
    if ctx is not None:
        if attn_step is not None:
            raise ValueError("on a mesh decode_step steps the dense cache")
        if not single:
            raise ValueError("on a mesh decode_step takes one token a row")
        if max_seq is None:
            raise ValueError("on a mesh decode_step needs max_seq, the "
                             "dense cache's global length")
    if not single:
        if attn_step is None:
            raise ValueError("multi-token decode_step needs a span-capable "
                             "attn_step (the dense cache is one-token)")
        bad = [m for m in cfg.layer_pattern if m not in ATTENTION]
        if bad:
            raise ValueError(f"multi-token decode_step is attention-only; "
                             f"layer_pattern has {bad}")
    h = _embed(cfg, params, token[:, None] if single else token, None)
    a = 0                                  # the attention layer's index
    for i, p in enumerate(params["layers"]):
        mixer = cfg.mixer_for_layer(i)
        if ctx is not None:
            p = spmd.gather_tree(p, _layer_specs(cfg, i, ctx.model_ax), ctx)
        # a paged attention layer's state is its pools alone
        paged = attn_step is not None and mixer in ATTENTION
        lc = {} if paged else cache["layers"][i]
        hn = L.rmsnorm(p["norm1"], h)
        if mixer in ATTENTION:
            if ctx is not None:
                out, _ = L.attention_decode_mesh(
                    cfg, p["mixer"], hn, lc, pos, max_seq=max_seq,
                    window=_window(cfg, i), use_kernel=use_kernel)
            elif not paged:
                out, _ = L.attention_decode(cfg, p["mixer"], hn, lc, pos,
                                            window=_window(cfg, i),
                                            use_kernel=use_kernel)
            else:
                pools = {k: cache[k][a] for k in ("k_pages", "v_pages")}
                out = attn_step(p["mixer"], hn, pools, pos, _window(cfg, i))
            a += 1
        else:
            step = L.rglru_decode if mixer == "recurrent" else L.ssd_decode
            out, new = step(cfg, p["mixer"], hn, lc,
                            group=_mixer_group(cfg, mixer, ctx))
            _set_state(lc, new)
        h = h + out
        if "cross" in p and "cross_k" in lc:
            h = h + _cross_decode(cfg, p["cross"], L.rmsnorm(p["norm_x"], h),
                                  lc["cross_k"], lc["cross_v"])
        h, _ = _ffn(cfg, p, h, use_kernel)
    h = L.rmsnorm(params["final_norm"], h)
    if ctx is not None:
        return _full_vocab(_logits_mesh(cfg, params, h, ctx), ctx)[:, 0], \
            cache
    logits = logits_fn(cfg, params, h)
    if single:
        logits = logits[:, 0, :]
    return logits, cache
