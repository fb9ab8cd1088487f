"""Explicit SPMD partitioning of the model over a mesh.

JAX writes partition specs and XLA's partitioner (GSPMD) inserts the
collectives; this module is what that partitioner does for the port,
so it has no JAX file.  PyTorch has no partitioner in front of the
port's kernels (ctypes libraries that take raw pointers), so every rank
holds the **local shards** of JAX's specs as plain tensors, the kernels
launch on those, and the collectives are explicit calls on the mesh's
process groups (NCCL on the card, gloo on the CPU).

The conventions (those of Megatron-style tensor parallelism with ZeRO-3
storage, which is what GSPMD makes of JAX's specs):

* The batch is split over the batch axes (translated "data"); every
  rank's loss is its rows' summed loss over the **global** token count,
  so summing a parameter's gradient over the batch axes gives the
  global gradient.
* Along the model axis activations are replicated and every rank
  back-propagates the same loss.  :func:`copy_to` (forward identity,
  backward all-reduce) enters a region split over the model axis and
  :func:`reduce_from` (forward all-reduce, backward identity) leaves it:
  the column-parallel / row-parallel projection pair; :func:`split_to`
  (forward this rank's chunk, backward all-gather) enters one with the
  rank's columns of a replicated activation (SSD's gated norm, whose
  mean needs the whole row, before its row-parallel ``out_proj``).  A
  replicated weight used inside such a region (the kv projections
  where the kv heads do not split, the MoE router) goes through
  :func:`copy_to` too, so its gradient is summed over the model axis;
  a replicated input that a region needs whole (the RG-LRU's gate
  products over the rank's conv columns) is gathered with
  :func:`gather_shards`, whose backward reduce-scatters the ranks'
  partial gradients.
* A weight's dimensions split over "data" are all-gathered per layer
  (:func:`gather_tree`; the backward is a reduce-scatter, which sums
  the gradient over the batch axes); every other leaf's gradient is
  all-reduced over the batch axes once a step (:func:`reduce_grads`).

All collectives go through this module's few functions, which also
report their bytes to :func:`count_collectives` (the dry run's tally,
per rank, each op's output as XLA's collective lines count it).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.sharding import (MeshContext, P, axis_group,
                                         entry_axes, group_index,
                                         spec_axes, translate_spec)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_TALLIES: list[dict] = []


@contextlib.contextmanager
def count_collectives():
    """Tally the bytes each collective kind writes on this rank inside
    this context (groups of one rank move nothing and count nothing)."""
    tally = {k: 0 for k in COLLECTIVE_KINDS}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _note(kind: str, out: torch.Tensor, group) -> None:
    if _TALLIES and dist.get_world_size(group) > 1:
        n = out.numel() * out.element_size()
        for t in _TALLIES:
            t[kind] += n


# ------------------------- plain collectives ------------------------------


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in group
    order, row-major (the blocked GEMM takes only contiguous operands)."""
    w = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((w * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    _note("all-gather", out, group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's chunk along ``dim``."""
    w = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // w,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=group)
    _note("reduce-scatter", out, group)
    return out.movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    _note("all-reduce", out, group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``x`` along dim 0 to rank j; chunk j of the result from
    rank j."""
    xc = x.contiguous()
    out = torch.empty_like(xc)
    dist.all_to_all_single(out, xc, group=group)
    _note("all-to-all", out, group)
    return out


def own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    w = dist.get_world_size(group)
    n = x.shape[dim] // w
    return x.narrow(dim, group_index(group) * n, n)


# ------------------------- autograd collectives ---------------------------


class _GatherShards(torch.autograd.Function):
    """all-gather forward, reduce-scatter (sum) backward: FSDP's
    per-layer weight gather, and any gather whose consumers' gradients
    are partial per rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    """all-gather forward, this rank's chunk backward: a gather whose
    consumers are replicated over the group (the same gradient on every
    rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return own_chunk(g, ctx.dim, ctx.group).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    """this rank's chunk forward, all-gather backward: a replicated
    activation entering a region split over the group along ``dim``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return own_chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def gather_shards(x, dim: int, group):
    return x if group is None else _GatherShards.apply(x, dim, group)


def gather_replicated(x, dim: int, group):
    return x if group is None else _GatherReplicated.apply(x, dim, group)


def copy_to(x, group):
    """Enter a region split over ``group``: identity forward, gradient
    all-reduced backward (None: no split, identity)."""
    return x if group is None else _CopyTo.apply(x, group)


def split_to(x, dim: int, group):
    """Enter a region split over ``group`` along ``dim`` with this
    rank's chunk of a replicated ``x`` (backward: the chunks' gradients
    gathered; None: no split, identity)."""
    return x if group is None else _SplitTo.apply(x, dim, group)


def reduce_from(x, group):
    """Leave a region split over ``group``: the partial sums all-reduced
    forward, identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def exchange(x, group):
    """all-to-all over ``group`` (dim 0 in equal chunks), differentiable
    (its backward is the same exchange of the gradient)."""
    return x if group is None else _AllToAll.apply(x, group)


def scale_grad(x, s: float):
    return x if s == 1 else _ScaleGrad.apply(x, s)


# --------------------------- parameters -----------------------------------


def _slice_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            x = own_chunk(x, dim, axis_group(mesh, axes))
    return x.contiguous()


def shard_params(params: Any, specs: Any, mesh, mapping: dict) -> Any:
    """The local shards of a full tree (parameters, an optimizer moment
    tree, a cache) under canonical ``specs`` translated by ``mapping``:
    each dimension cut by this rank's index along its axes."""
    return _zip_map(lambda x, s: _slice_leaf(
        x, translate_spec(s, mapping), mesh), params, specs)


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def unshard(tree: Any, specs: Any, ctx: MeshContext) -> Any:
    """The full tree from every rank's shards (no gradient): each
    sharded dimension all-gathered over its axes."""
    def one(x, spec):
        for dim, entry in enumerate(ctx.translate(spec)):
            axes = entry_axes(entry)
            if axes:
                x = all_gather(x, dim, ctx.group(axes))
        return x.contiguous()
    return _zip_map(one, tree, specs)


def gather_tree(tree: Any, specs: Any, ctx: MeshContext) -> Any:
    """FSDP: every leaf's "data" dimensions all-gathered over the batch
    axes (backward: the gradient reduce-scattered, summed over them);
    the "model" dimensions stay local (tensor parallelism)."""
    group = ctx.batch_group

    def one(x, spec):
        for dim, entry in enumerate(spec):
            if entry == "data" and group is not None:
                x = gather_shards(x, dim, group)
        return x
    return _zip_map(one, tree, specs)


def reduce_grads(grads: Any, specs: Any, ctx: MeshContext) -> Any:
    """Sum over the batch axes the gradients of the leaves that
    :func:`gather_tree` did not reduce-scatter (no "data" dimension)."""
    group = ctx.batch_group

    def one(g, spec):
        if group is None or "data" in tuple(spec):
            return g
        return all_reduce(g, group)
    return _zip_map(one, grads, specs)


def _by_axes(tree: Any, specs: Any, ctx: MeshContext, fn, op):
    """``fn`` of every leaf (a scalar), combined with ``op`` over the
    leaves that share a set of mesh axes, then across those axes' ranks:
    a sharded leaf counts every shard once, a replicated one once."""
    parts: dict[tuple[str, ...], torch.Tensor] = {}

    def one(x, spec):
        axes = tuple(a for a in ctx.mesh.mesh_dim_names
                     if a in spec_axes(ctx.translate(spec)))
        v = fn(x)
        parts[axes] = v if axes not in parts else op(parts[axes], v)
        return x
    _zip_map(one, tree, specs)
    return parts


def global_norm(grads: Any, specs: Any, ctx: MeshContext) -> torch.Tensor:
    """sqrt of the sum of squares of the global tree (fp32): each leaf's
    local sum, summed over the ranks that hold its distinct shards."""
    parts = _by_axes(grads, specs, ctx,
                     lambda g: torch.sum(torch.square(g.float())),
                     torch.add)
    total = None
    for axes, v in parts.items():
        if axes:
            v = all_reduce(v, ctx.group(axes))
        total = v if total is None else total + v
    return torch.sqrt(total)


def compress_tree(grads: Any, specs: Any, ctx: MeshContext,
                  groups: list | None = None) -> Any:
    """``optim.compress.compress_tree`` of the global tree, shard by
    shard: each tensor's scale is the max over its global extent (an
    all-reduce over the axes that shard it), so every rank quantizes its
    shard as the unsharded tensor would be."""
    from repro_torch.optim.adamw import leaves
    from repro_torch.optim.compress import compress_tree as compress
    axes = []
    _zip_map(lambda g, spec: axes.append(tuple(
        a for a in ctx.mesh.mesh_dim_names
        if a in spec_axes(ctx.translate(spec)))), grads, specs)
    assert len(axes) == len(leaves(grads))

    def reduce_max(i, amax):
        return all_reduce(amax, ctx.group(axes[i]), dist.ReduceOp.MAX) \
            if axes[i] else amax
    return compress(grads, groups=groups, reduce_max=reduce_max)[0]


# ------------------- vocab-parallel embedding and loss --------------------


def vocab_embed(emb: torch.Tensor, tokens: torch.Tensor,
                ctx: MeshContext, vocab_split: bool) -> torch.Tensor:
    """Rows of an embedding split over the model axis by vocabulary:
    each rank looks up the tokens in its range (zeros elsewhere) and the
    partial rows are summed over the model axis."""
    if not vocab_split:
        return emb[tokens]
    group = ctx.model_group
    n = emb.shape[0]
    local = tokens.long() - group_index(group) * n
    mine = (local >= 0) & (local < n)
    rows = emb[local.clamp(0, n - 1)] * mine[..., None].to(emb.dtype)
    return reduce_from(rows, group)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        ctx: MeshContext, vocab_split: bool):
    """Per-position ``logsumexp - gold`` of fp32 logits split over the
    model axis by vocabulary (the max and the sums all-reduced), and
    the mask of counted labels (label >= 0)."""
    labels = labels.long()
    mask = labels >= 0
    labels = labels.clamp_min(0)
    if not vocab_split:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return logz - gold, mask
    group = ctx.model_group
    n = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), group, dist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    logz = m + torch.log(sumexp)
    local = labels - group_index(group) * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from(gold * mine.to(gold.dtype), group)
    return logz - gold, mask


# -------------------- sequence-sharded decode merge -----------------------


def merge_partials(out: torch.Tensor, mx: torch.Tensor, sm: torch.Tensor,
                   group) -> torch.Tensor:
    """Merge softmax-attention partials computed over disjoint key runs:
    ``out`` (..., D) the unnormalised sum of ``exp(s - mx) v``, ``mx``
    (...) the run's max score, ``sm`` (...) its ``sum exp(s - mx)``.
    Reduced over ``group`` (the model axis): the global max, then the
    rescaled sums."""
    g = all_reduce(mx, group, dist.ReduceOp.MAX)
    w = torch.exp(mx - g)
    total = all_reduce(sm * w, group)
    o = all_reduce(out * w[..., None], group)
    return o / total[..., None]


# ---------------------------- the heads plan ------------------------------


def head_plan(cfg, ctx: MeshContext | None):
    """How this rank's attention heads sit on the model axis.

    Returns ``(q0, hq, kv_heads)``: the first global query head and the
    count of the local ones, and the global kv heads (a list, in the
    order the kernel reads them) that the local query heads attend with
    in GQA layout (query head i of the local ones on kv entry ``i //
    (hq // len(kv_heads))``).  Where the local query heads straddle kv
    heads unevenly, every query head gets its own copy of its kv head
    (GQA group 1)."""
    from repro_torch.models.layers import attention_specs
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    m = ctx.model_ax if ctx is not None else 1
    sq, skv = attention_specs(cfg, m)
    if sq is None:
        return 0, hq, list(range(hkv))
    r = group_index(ctx.model_group)
    hq_l = hq // m
    q0 = r * hq_l
    if skv is not None:
        n = hkv // m
        return q0, hq_l, list(range(r * n, (r + 1) * n))
    g = hq // hkv
    lo, hi = q0 // g, (q0 + hq_l - 1) // g
    if lo == hi:
        return q0, hq_l, [lo]
    if q0 % g == 0 and hq_l % g == 0:
        return q0, hq_l, list(range(lo, hi + 1))
    return q0, hq_l, [(q0 + i) // g for i in range(hq_l)]


def kv_columns(kv_heads: list[int], head_dim: int) -> torch.Tensor:
    return torch.tensor([h * head_dim + j for h in kv_heads
                         for j in range(head_dim)], dtype=torch.long)


def tp_split(cfg, ctx: MeshContext | None) -> bool:
    """True where the attention's query heads split over the model axis
    (a tensor-parallel attention)."""
    from repro_torch.models.layers import attention_specs
    return ctx is not None and ctx.model_ax > 1 and \
        attention_specs(cfg, ctx.model_ax)[0] is not None


def leaves_bytes(tree: Any) -> int:
    """Bytes of every tensor of a tree of dicts, lists and tuples (meta
    tensors included; other leaves count nothing)."""
    if isinstance(tree, dict):
        return sum(leaves_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(leaves_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def local_bytes(shapes: Any, specs: Any, sizes: dict, mapping: dict) -> int:
    """Bytes of this rank's shards of a tree of global-shape tensors."""
    from repro_torch.models.sharding import local_shape
    total = [0]

    def one(t, spec):
        shape = local_shape(tuple(t.shape), translate_spec(spec, mapping),
                            sizes)
        total[0] += math.prod(shape) * t.element_size()
        return t
    _zip_map(one, shapes, specs)
    return total[0]
