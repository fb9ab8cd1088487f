"""The plain reference of a dense pre-norm decoder, in float32.

It follows the equations of the measured model, written out again with
plain torch operations, and takes nothing but the weights and the token
ids that the benchmark made and handed to the program too:

    h_0     = E[tokens] * sqrt(d_model)
    a       = rmsnorm(h) (eps 1e-6, times the layer's scale)
    q, k, v = a Wq, a Wk, a Wv, rotated by RoPE (rotate-half, theta)
    o       = softmax(q k^T / sqrt(head_dim), causal) v, query head j
              reading kv head j // (n_heads / n_kv_heads)
    h      += o Wo
    m       = rmsnorm(h)
    h      += (silu(m Wgate) * (m Wup)) Wdown
    logits  = rmsnorm(h_L) E^T        (tied embedding, every row of E)

Weights are stored as the configuration states (bfloat16) and widened
to float32 one layer at a time, so the reference fits beside the stored
weights at the published widths.  TF32 is switched off by the caller
(:func:`strict_fp32`).  Every product goes through ``mm``, so the
control can put a lower precision in its place (:func:`fp8_mm`).

This file imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
EPS = 1e-6
Q_BLOCK = 1024          # query rows a block of the attention


@contextlib.contextmanager
def strict_fp32():
    """float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude to e4m3's largest, 448), returned in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands, and in the backward the incoming
    gradient, rounded to e4m3 first; the sums in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # sum over the broadcast leading dimensions of each operand
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        for i, n in enumerate(qa.shape):
            if n == 1 and ga.shape[i] != 1:
                ga = ga.sum(i, keepdim=True)
        for i, n in enumerate(qb.shape):
            if n == 1 and gb.shape[i] != 1:
                gb = gb.sum(i, keepdim=True)
        return ga, gb


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands (and, in the backward, the
    incoming gradient) rounded to e4m3, one scale a tensor, the sums in
    float32."""
    return _Fp8Matmul.apply(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (S,): the two halves of each head
    rotated by the angle position * theta^(-i / (D/2))."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freq          # S, half
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mm: Mm) -> torch.Tensor:
    """Causal GQA attention of one sequence.  q (S, Hq, D), k and v
    (S, Hkv, D) -> (S, Hq, D), in blocks of query rows."""
    s, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qh = q.reshape(s, hkv, g, d).permute(1, 2, 0, 3)          # Hkv,G,S,D
    kt = k.permute(1, 2, 0)[:, None]                           # Hkv,1,D,S
    vh = v.permute(1, 0, 2)[:, None]                           # Hkv,1,S,D
    out = []
    for r0 in range(0, s, Q_BLOCK):
        r1 = min(s, r0 + Q_BLOCK)
        sc = mm(qh[:, :, r0:r1], kt[..., :r1]) / math.sqrt(d)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        out.append(mm(torch.softmax(sc, dim=-1), vh[:, :, :r1]))
    o = torch.cat(out, dim=2)                                  # Hkv,G,S,D
    return o.permute(2, 0, 1, 3).reshape(s, hq, d)


def widen(layer: dict) -> dict:
    """One layer's stored weights as float32 tensors, by plain names."""
    return {"norm1": layer["norm1"]["scale"].float(),
            "wq": layer["mixer"]["wq"].float(),
            "wk": layer["mixer"]["wk"].float(),
            "wv": layer["mixer"]["wv"].float(),
            "wo": layer["mixer"]["wo"].float(),
            "norm2": layer["norm2"]["scale"].float(),
            "w_gate": layer["ffn"]["w_gate"].float(),
            "w_up": layer["ffn"]["w_up"].float(),
            "w_down": layer["ffn"]["w_down"].float()}


def block(w: dict, h: torch.Tensor, positions: torch.Tensor, heads: tuple,
          theta: float, mm: Mm, on_kv=None) -> torch.Tensor:
    """One block over (B, S, D).  ``heads`` is (n_heads, n_kv_heads,
    head_dim); ``on_kv(k, v)`` receives the rotated keys and the values,
    (B, S, Hkv, D) each."""
    hq, hkv, hd = heads
    b, s, _ = h.shape
    a = rmsnorm(h, w["norm1"])
    q = rope(mm(a, w["wq"]).reshape(b, s, hq, hd), positions, theta)
    k = rope(mm(a, w["wk"]).reshape(b, s, hkv, hd), positions, theta)
    v = mm(a, w["wv"]).reshape(b, s, hkv, hd)
    if on_kv is not None:
        on_kv(k, v)
    o = torch.stack([attention(q[i], k[i], v[i], mm) for i in range(b)])
    h = h + mm(o.reshape(b, s, hq * hd), w["wo"])
    m = rmsnorm(h, w["norm2"])
    u = torch.nn.functional.silu(mm(m, w["w_gate"])) * mm(m, w["w_up"])
    return h + mm(u, w["w_down"])


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    e = params["embed"]["embedding"]
    return e[tokens].float() * math.sqrt(e.shape[1])


def logits(params: dict, h: torch.Tensor, mm: Mm) -> torch.Tensor:
    return mm(rmsnorm(h, params["final_norm"]["scale"].float()),
              params["embed"]["embedding"].float().T)


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor, heads: tuple, theta: float,
            mms: tuple = (fp32_mm,), on_kv=None) -> list[torch.Tensor]:
    """The last block's output over one prompt (S,), (S, D), once for
    each product of ``mms``, the passes run side by side one layer at a
    time (:func:`logits` turns rows of it into logits).
    ``on_kv(layer, kvs)`` is given each layer's keys and values as they
    leave the projections, one (k, v) pair (S, Hkv, D) for each pass."""
    hs = [embed(params, tokens)[None] for _ in mms]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    for i, layer in enumerate(params["layers"]):
        w = widen(layer)
        kvs = []
        for j, mm in enumerate(mms):
            hs[j] = block(w, hs[j], pos, heads, theta, mm,
                          lambda k, v: kvs.append((k[0], v[0])))
        if on_kv is not None:
            on_kv(i, kvs)
        del w, kvs
    return [h[0] for h in hs]


# ------------------------------- training ----------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def loss_and_grads(params: dict, batch: dict, heads: tuple, theta: float,
                   mm: Mm = fp32_mm) -> tuple[float, list]:
    """The mean next-token cross-entropy over ``batch`` ({"tokens",
    "labels"}, (B, S) each, every label counted) and its float32
    gradient for every leaf of ``params``, in the order of a walk of
    the tree (dicts in insertion order, lists in order).  The forward
    keeps each block's input; the backward recomputes one block at a
    time under autograd."""
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    emb = params["embed"]["embedding"]
    grads = {id(x): None for x in _leaves(params)}
    with torch.no_grad():
        h = embed(params, tokens)
        inputs = []
        for layer in params["layers"]:
            inputs.append(h)
            h = block(widen(layer), h, pos, heads, theta, mm)
    # the head: final norm, tied embedding, loss
    h = h.detach().requires_grad_(True)
    e32 = emb.detach().float().requires_grad_(True)
    fn = params["final_norm"]["scale"].detach().float().requires_grad_(True)
    with torch.enable_grad():
        lg = mm(rmsnorm(h, fn), e32.T)
        loss = torch.nn.functional.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))
        dh, g_emb, g_fn = torch.autograd.grad(loss, (h, e32, fn))
    del lg
    grads[id(params["final_norm"]["scale"])] = g_fn
    for i in range(len(params["layers"]) - 1, -1, -1):
        layer = params["layers"][i]
        w = {k: t.detach().requires_grad_(True)
             for k, t in widen(layer).items()}
        x = inputs[i].requires_grad_(True)
        with torch.enable_grad():
            out = block(w, x, pos, heads, theta, mm)
            names = list(w)
            gs = torch.autograd.grad(out, [x] + [w[n] for n in names], dh)
        dh = gs[0]
        by_name = dict(zip(names, gs[1:]))
        plain = {"norm1": layer["norm1"]["scale"], "wq": layer["mixer"]["wq"],
                 "wk": layer["mixer"]["wk"], "wv": layer["mixer"]["wv"],
                 "wo": layer["mixer"]["wo"],
                 "norm2": layer["norm2"]["scale"],
                 "w_gate": layer["ffn"]["w_gate"],
                 "w_up": layer["ffn"]["w_up"],
                 "w_down": layer["ffn"]["w_down"]}
        for n, t in plain.items():
            grads[id(t)] = by_name[n]
        inputs[i] = None
    # the lookup's gradient: dh_0 scattered back onto the rows it read
    g_emb = g_emb.index_add_(0, tokens.reshape(-1),
                             dh.reshape(-1, dh.shape[-1])
                             * math.sqrt(emb.shape[1]))
    grads[id(emb)] = g_emb
    return float(loss.detach()), [grads[id(x)] for x in _leaves(params)]


def adamw_step(params: dict, grads: list, state: dict,
               opt: dict) -> list[float]:
    """One AdamW step in float32 over ``params`` (stored dtype kept):
    global-norm clip, linear warm-up then cosine decay, moments in
    float32, decoupled weight decay on every leaf.  ``state`` holds
    ``mu``, ``nu`` (lists by leaf) and ``step``; ``opt`` the
    hyper-parameters.  Updates ``params`` and ``state`` in place and
    returns the norm of each leaf's clipped gradient, as the moments
    took it."""
    step = state["step"] + 1
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
    scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
    if step < opt["warmup_steps"]:
        lr = opt["lr"] * step / max(opt["warmup_steps"], 1)
    else:
        t = (step - opt["warmup_steps"]) / max(
            opt["total_steps"] - opt["warmup_steps"], 1)
        t = min(max(t, 0.0), 1.0)
        lr = opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"])
                          * 0.5 * (1 + math.cos(math.pi * t)))
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    norms = []
    for i, p in enumerate(_leaves(params)):
        g = grads[i] * scale
        grads[i] = None
        norms.append(float(torch.linalg.vector_norm(g)))
        mu = state["mu"][i] = b1 * state["mu"][i] + (1 - b1) * g
        nu = state["nu"][i] = b2 * state["nu"][i] + (1 - b2) * g * g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + opt["eps"]) \
            + opt["weight_decay"] * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return norms


def train(params: dict, batches: list, heads: tuple, theta: float,
          opt: dict, mm: Mm = fp32_mm) -> dict:
    """``len(batches)`` steps from ``params`` (updated in place).
    Returns each step's loss, the norm of every leaf's first gradient
    as the optimizer took it (clipped), the norm of every leaf's change
    over all the steps, and every leaf's float32 moments after them
    (``mu``, ``nu``), in the order of a walk of the tree."""
    flat = _leaves(params)
    start = [p.clone() for p in flat]
    state = {"mu": [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in flat],
             "nu": [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in flat],
             "step": 0}
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grads(params, batch, heads, theta, mm)
        losses.append(loss)
        norms = adamw_step(params, grads, state, opt)
        first = norms if first is None else first
        del grads
    change = [float(torch.linalg.vector_norm(p.float() - s.float()))
              for p, s in zip(flat, start)]
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "mu": state["mu"], "nu": state["nu"]}
