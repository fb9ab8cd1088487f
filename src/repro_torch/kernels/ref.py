"""Plain-PyTorch oracles (the port's counterpart of ``repro.kernels.ref``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None,
                  logit_cap: float | None = None,
                  window: int | None = None) -> torch.Tensor:
    """Softmax attention oracle in fp32.  q, k, v: (..., Sq, D),
    (..., Skv, D), (..., Skv, D) with broadcastable leading dims (the
    JAX oracle's single head is the case of none).  ``kv_offset = Skv -
    Sq`` aligns the queries to the tail of the keys."""
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)
