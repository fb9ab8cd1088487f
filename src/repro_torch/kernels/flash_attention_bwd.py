"""Flash-attention backward: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.flash_attention_bwd.flash_attention_bwd`` (kernel
row 5).  The kernel lives in ``csrc/flash_attention_bwd.cu`` (design and
bound in its header comment): a dq pass over query rows streaming K/V
tiles of ``block_kv`` keys, and a dk/dv pass over keys streaming the
query rows (all G heads of the kv head, positions in order) in tiles of
``block_q``; both recompute ``p = exp(s - lse)`` from the forward's
residual, and ``delta = rowsum(do * o)`` is a torch reduction here, as
JAX computes it outside its kernels.  GQA's sum over the G query heads
is taken inside the dk/dv pass's block in one fixed order, so repeated
launches agree bit for bit.  ``(block_q, block_kv)`` come from
``core.hopper_adapter.flash_tiles`` against :func:`dq_smem_bytes` and
:func:`dkv_smem_bytes`.

Layouts: q, o, do ``(B, Sq, Hq, D)``; k, v ``(B, Skv, Hkv, D)``; lse
``(B, Hq, Sq)`` fp32 (``flash_attention``'s residual).  Returns (dq, dk,
dv) in the inputs' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hopper_adapter import flash_tiles
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, _check,
                                                 dense_scores)

ROWS_PER_BLOCK = 4   # query rows (dq pass) or keys (dk/dv pass) per block
STAGES = 2           # streamed tiles in flight: the current one and the next
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def dq_smem_bytes(block_kv: int, head_dim: int,
                  bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one dq block (csrc: ``dq_smem_bytes``):
    K and V tiles of ``block_kv`` keys, two stages each; the block's q
    and do rows; one fp32 ds per key for each row."""
    return (STAGES * 2 * block_kv * head_dim * bytes_per_elem
            + 2 * ROWS_PER_BLOCK * head_dim * bytes_per_elem
            + ROWS_PER_BLOCK * block_kv * 4)


def dkv_smem_bytes(block_q: int, head_dim: int,
                   bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one dk/dv block (csrc:
    ``dkv_smem_bytes``): q and do tiles of ``block_q`` rows and their
    fp32 lse and delta, two stages each; the block's k and v rows; one
    fp32 p and ds per row for each key."""
    return (STAGES * 2 * block_q * head_dim * bytes_per_elem
            + STAGES * 2 * block_q * 4
            + 2 * ROWS_PER_BLOCK * head_dim * bytes_per_elem
            + 2 * ROWS_PER_BLOCK * block_q * 4)


def row_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` in fp32, laid out like lse
    ``(B, Hq, Sq)``."""
    return (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, g, *, causal: bool = True,
                            window: int | None = None,
                            logit_cap: float | None = None):
    """Plain version: JAX's recompute math over dense fp32 tensors (not
    torch autograd).  Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    scale = d ** -0.5
    s, t, mask = dense_scores(q, k, causal=causal, window=window,
                              logit_cap=logit_cap)        # B,Hkv,G,Sq,Skv

    def heads(x):  # (B, Sq, Hq, D) -> (B, Hkv, G, Sq, D) in fp32
        return x.float().reshape(b, sq, hkv, grp, d).permute(0, 2, 3, 1, 4)

    qh, gh = heads(q), heads(g)
    kh = k.float().permute(0, 2, 1, 3)[:, :, None]        # B,Hkv,1,Skv,D
    vh = v.float().permute(0, 2, 1, 3)[:, :, None]
    lse_h = lse.reshape(b, hkv, grp, sq, 1)
    delta = row_delta(o, g).reshape(b, hkv, grp, sq, 1)
    p = torch.where(mask, torch.exp(s - lse_h), 0.0)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.matmul(ds, kh) * scale                     # B,Hkv,G,Sq,D
    dk = torch.matmul(ds.transpose(-1, -2), qh).sum(2) * scale
    dv = torch.matmul(p.transpose(-1, -2), gh).sum(2)     # B,Hkv,Skv,D
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bwd(q, k, v, o, lse, g, *, causal: bool = True,
                        window: int | None = None,
                        logit_cap: float | None = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` given its output
    ``o``, residual ``lse`` and the output cotangent ``g``, the two
    passes tiled ``(block_q, block_kv)`` by the Hopper ``flash_tiles``.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`flash_attention_bwd_ref`.
    """
    kw = dict(causal=causal, window=window, logit_cap=logit_cap)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, g, **kw)
    b, sq, hq, d = _check(q, k, v, window)
    for name, t in (("o", o), ("g", g)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte "
                             f"aligned {tuple(q.shape)} {q.dtype} tensor "
                             f"on {q.device}")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous fp32 {(b, hq, sq)} "
                         f"tensor on {q.device}")
    skv, hkv = k.shape[1], k.shape[2]
    block_q, block_kv = flash_tiles(sq, skv, d, q.element_size())
    have = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    need = max(dq_smem_bytes(block_kv, d, q.element_size()),
               dkv_smem_bytes(block_q, d, q.element_size()))
    if need > have:
        raise ValueError(f"tiles {(block_q, block_kv)} need {need} bytes of "
                         f"shared memory per block; this card allows {have}")
    delta = row_delta(o, g)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    fn = _build.load("flash_attention_bwd", "flash_attention_bwd", _ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, int(causal),
             int(window or 0), float(logit_cap or 0.0), block_q, block_kv,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
