"""Flash-attention backward: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.flash_attention_bwd.flash_attention_bwd`` (kernel
row 5).  The kernel lives in ``csrc/flash_attention_bwd.cu`` (design and
bound in its header comment): a dq pass over query rows streaming K/V
tiles of ``block_kv`` keys, and a dk/dv pass over keys streaming the
query rows (all G heads of the kv head, positions in order) in tiles of
``block_q``; both recompute ``p = exp(s - lse)`` from the forward's
residual.  ``delta = rowsum(do * o)``, which JAX computes outside its
kernels, is summed in fp32 by the dq pass (it stages each row's do
anyway) and read by the dk/dv pass.  GQA's sum over the G query heads
is taken inside the dk/dv pass's block in one fixed order, so repeated
launches agree bit for bit.  Two instances, as the forward's: bf16 on
the tensor cores (``csrc/attn_mma.cuh``; P and dS are rounded to bf16
before their products), fp32 on CUDA cores.  ``(block_q, block_kv)`` are
the forward's, from ``core.hopper_adapter.flash_tiles`` against
:func:`dq_smem_bytes` and :func:`dkv_smem_bytes` (and the accumulator
counts); the wrapper records its instance in
``flash_attention_bwd.instance``.  Head dims as the forward's; at width
256 the bf16 dk/dv pass sweeps the streamed rows twice, dv then dk, 16
rows at a time (:func:`dkv_sweeps`), so each sweep's sums fit the
registers.

Layouts: q, o, do ``(B, Sq, Hq, D)``; k, v ``(B, Skv, Hkv, D)``; lse
``(B, Hq, Sq)`` fp32 (``flash_attention``'s residual).  Returns (dq, dk,
dv) in the inputs' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hopper_adapter import flash_tiles
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, CUDA_CORE_ROWS,
                                                 ROWS_PER_WARP, _check,
                                                 check_tiles, dense_scores,
                                                 instance_head_dim,
                                                 instance_kind)

STAGES = 2           # streamed tiles in flight: the current one and the next
DKV_SUB_ROWS = 32    # bf16 dk/dv pass: streamed rows scored at a time
DKV_SUB_ROWS_WIDE = 16   # the same at D = 256, where it sweeps twice
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def dq_smem_bytes(block_q: int, block_kv: int, head_dim: int,
                  bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one dq block (csrc: ``dq_smem_bytes``):
    K and V tiles of ``block_kv`` keys, two stages each, and the block's
    q and do rows; bf16 with the rows' fp32 lse and delta (``block_q``
    rows), fp32 with one fp32 ds per key for each of its 4 rows.  Rows
    at the instance's width (``instance_head_dim``)."""
    d = instance_head_dim(head_dim)
    if bytes_per_elem == 2:
        return ((2 * block_q + STAGES * 2 * block_kv) * d * 2
                + 2 * block_q * 4)
    return (STAGES * 2 * block_kv * d * bytes_per_elem
            + 2 * CUDA_CORE_ROWS * d * bytes_per_elem
            + CUDA_CORE_ROWS * block_kv * 4)


def dkv_smem_bytes(block_q: int, block_kv: int, head_dim: int,
                   bytes_per_elem: int = 2) -> int:
    """Dynamic shared memory of one dk/dv block (csrc:
    ``dkv_smem_bytes``): q and do tiles of ``block_q`` rows and their
    fp32 lse and delta, two stages each, and the block's k and v rows
    (bf16: ``block_kv`` keys; fp32: 4 keys, with one fp32 p and ds per
    row for each).  Rows at the instance's width."""
    d = instance_head_dim(head_dim)
    if bytes_per_elem == 2:
        return ((STAGES * 2 * block_q + 2 * block_kv) * d * 2
                + STAGES * 2 * block_q * 4)
    return (STAGES * 2 * block_q * d * bytes_per_elem
            + STAGES * 2 * block_q * 4
            + 2 * CUDA_CORE_ROWS * d * bytes_per_elem
            + 2 * CUDA_CORE_ROWS * block_q * 4)


def dq_accumulators(block_q: int, block_kv: int, head_dim: int) -> int:
    """fp32 sums a thread of the bf16 dq pass holds: its warp's m16 x D
    dq and m16 x block_kv s and dp, over 32 lanes."""
    return ROWS_PER_WARP * (instance_head_dim(head_dim)
                            + 2 * block_kv) // 32


def dkv_sweeps(head_dim: int) -> int:
    """Sweeps of the bf16 dk/dv pass over the streamed rows: one (dk and
    dv together) up to D = 128; two at D = 256 (dv, then dk), where both
    at once would need 272 sums a thread (csrc: ``dkv_sweeps``)."""
    return 2 if instance_head_dim(head_dim) > 128 else 1


def dkv_sub_rows(block_q: int, head_dim: int) -> int:
    """Streamed rows the bf16 dk/dv pass scores at a time (csrc:
    ``dkv_sub_rows``)."""
    sub = DKV_SUB_ROWS_WIDE if dkv_sweeps(head_dim) == 2 else DKV_SUB_ROWS
    return min(block_q, sub)


def dkv_accumulators(block_q: int, block_kv: int, head_dim: int) -> int:
    """fp32 sums a thread of the bf16 dk/dv pass holds: its warp's 16
    keys' dk and dv (16 x D each; one of them a sweep at D = 256) and
    their s and dp against one sub-step of :func:`dkv_sub_rows` rows,
    over 32 lanes."""
    d = instance_head_dim(head_dim)
    sub = dkv_sub_rows(block_q, head_dim)
    return ROWS_PER_WARP * (2 * d // dkv_sweeps(head_dim) + 2 * sub) // 32


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
    passes tiled ``(block_q, block_kv)`` by the Hopper ``flash_tiles``,
    as the forward is.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`flash_attention_bwd_ref`.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, g, causal=causal,
                                       window=window, logit_cap=logit_cap)
    return _backward(q, k, v, o, lse, g, causal, window, logit_cap)


flash_attention_bwd.launches = 0
flash_attention_bwd.instance = None   # (kind, block_q, block_kv) of the last


def _backward(q, k, v, o, lse, g, causal, window, logit_cap):
    """Launch the two passes, tiled by the Hopper ``flash_tiles`` (the
    forward's tiles); ``(dq, dk, dv)``."""
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
    esz = q.element_size()
    block_q, block_kv = check_tiles(flash_tiles(sq, skv, d, esz), q.dtype)
    have = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    need = max(dq_smem_bytes(block_q, block_kv, d, esz),
               dkv_smem_bytes(block_q, block_kv, d, esz))
    if need > have:
        raise ValueError(f"tiles {(block_q, block_kv)} need {need} bytes of "
                         f"shared memory per block; this card allows {have}")
    delta = torch.empty_like(lse)      # written by the dq pass
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    fn = _build.load("flash_attention_bwd", "flash_attention_bwd", _ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             g.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, int(causal),
             int(window or 0), float(logit_cap or 0.0), block_q, block_kv,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.instance = (instance_kind(q.dtype), block_q,
                                    block_kv)
    return dq, dk, dv
