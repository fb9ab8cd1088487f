"""Plain-PyTorch oracles (the port's counterpart of ``repro.kernels.ref``).

The conv oracles keep JAX's NHWC x HWIO layout at their interface and
run ``torch.nn.functional.conv2d`` on permuted fp32 views.  A float32
convolution on the card goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, so :func:`conv2d_ref` turns
it off for its call (and restores it): the oracle is full float32.
They are yardsticks only, never on a kernel path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """Direct 2-D convolution (cross-correlation, VALID padding) in fp32.

    x: (N, H, W, C)   w: (Fh, Fw, C, K)   ->   (N, H', W', K), x's dtype.
    """
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x.float().permute(0, 3, 1, 2),
                       w.float().permute(3, 2, 0, 1), stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """The Caffe-style lowering baseline (paper section 2.2): an explicit
    im2col of every (Fh, Fw) window, then one product.  The same
    arithmetic as :func:`conv2d_ref`, with the lowered matrix the paper
    counts replicated Fh * Fw times."""
    n, h, wd, c = x.shape
    fh, fw, _, k = w.shape
    oh = (h - fh) // stride + 1
    ow = (wd - fw) // stride + 1
    patches = [x[:, i:i + (oh - 1) * stride + 1:stride,
                 j:j + (ow - 1) * stride + 1:stride, :]
               for i in range(fh) for j in range(fw)]
    lowered = torch.cat(patches, dim=-1).float()      # (N, OH, OW, Fh*Fw*C)
    out = lowered @ w.reshape(fh * fw * c, k).float()
    return out.to(x.dtype)


def conv2d_wgrad_ref(x: torch.Tensor, g: torch.Tensor,
                     w_shape: tuple[int, ...], stride: int = 1
                     ) -> torch.Tensor:
    """Oracle dW for :func:`conv2d_ref`: the transpose of the linear map
    w -> conv(x, w) at the cotangent g (``torch.autograd.grad``, as JAX
    takes ``jax.vjp``), in g's dtype."""
    wz = torch.zeros(w_shape, dtype=g.dtype, device=g.device,
                     requires_grad=True)
    with torch.enable_grad():
        out = conv2d_ref(x.detach(), wz, stride)
        (dw,) = torch.autograd.grad(out, wz, g)
    return dw


def conv2d_dgrad_ref(g: torch.Tensor, w: torch.Tensor,
                     x_shape: tuple[int, ...], stride: int = 1
                     ) -> torch.Tensor:
    """Oracle dX for :func:`conv2d_ref`: the transpose of x -> conv(x, w)
    at the cotangent g, in g's dtype."""
    xz = torch.zeros(x_shape, dtype=g.dtype, device=g.device,
                     requires_grad=True)
    with torch.enable_grad():
        out = conv2d_ref(xz, w.detach(), stride)
        (dx,) = torch.autograd.grad(out, xz, g)
    return dx


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
