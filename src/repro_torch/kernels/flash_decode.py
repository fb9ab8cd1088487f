"""Paged flash-decode attention: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.flash_decode.flash_decode`` (the TPU kernel of
paged decode and chunked prefill).  The kernel lives in
``csrc/flash_decode.cu`` (design and bound in its header comment).  As
on the TPU, its KV tile is one page: the page size the blocking model
chooses (``serve.kv_cache.choose_page_size``) is what the kernel stages
per step, and :func:`smem_bytes_required` is what the Hopper adapter's
``"flash_decode"`` search prices.

Layouts (GQA-native: all G query heads of one KV head share its pages):

* ``q``:            (B, Hkv, q_span*G, D) — rows position-major, row r is
  position offset ``r // G``;
* ``k/v_pages``:    (n_pages, page, Hkv, D) — the global page pool;
* ``block_tables``: (B, n_blocks) int32 — physical page of each logical
  KV block; entries past a request's length must still be valid page
  indices (the scratch page 0);
* ``lengths``:      (B,) int32 — tokens in the cache *including* the
  first spanned token (its K/V already scattered into the pages).

D, the head_dim, is any multiple of 16 from 16 to 256: each kernel runs
the smallest compiled width of 32, 64, 128 and 256 at least D, its
columns past D staged as zeros (``flash_attention.instance_head_dim``).

:func:`flash_decode_oproj` is the single-token form with the output
projection fused in (port of ``flash_decode.flash_decode_oproj``, kernel
row 3; ``csrc/flash_decode_oproj.cu``): q (B, Hkv, G, D) and ``wo``
(Hkv, G*D, E) give (B, E).  Its grid is E slices by kv heads
(:func:`oproj_grid`): the blocks of a head's slices form clusters that
run the head's attention once per batch row and share the rows through
distributed shared memory, each block streams its slice of the head's
``wo`` once for every batch row, and the last block of a slice sums the
heads' fp32 partials in head order, so the attention output never
reaches HBM.  Its page is priced by :func:`oproj_smem_bytes_required`
under the ``"flash_decode_oproj"`` key.

:func:`flash_decode_fp8` is the same attention over ``float8_e4m3fn``
pools with fp32 per-kv-head scales (port of
``flash_decode.flash_decode_fp8``, kernel row 2;
``csrc/flash_decode_fp8.cu``): the pages are staged as raw bytes and
widened in registers, the k scale folds into the scores and the v scale
into the output row.  Its page is priced by :func:`smem_bytes_required`
with ``kv_bytes=1`` under the ``"flash_decode_fp8"`` key.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (check_head_dim,
                                                 instance_head_dim)
from repro_torch.kernels.ref import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_BLOCK = 4   # query rows per block, one per warp (csrc: kWarps)
STAGES = 2           # K/V tiles in flight: the current page and the next


def smem_bytes_required(page: int, rows_per_block: int, head_dim: int,
                        bytes_per_elem: int = 2,
                        kv_bytes: int | None = None) -> int:
    """Dynamic shared memory of one block (``attn::smem_bytes``): a K and
    a V tile of ``page`` keys each, two stages deep, at ``kv_bytes`` per
    element (the input's width unless given: 1 for an fp8 pool), and the
    block's q rows in the input dtype; one fp32 score per key for each
    row.  The query span of a chunked prefill does not enter: rows are
    tiled across blocks, ``rows_per_block`` at a time.  Rows are staged
    at the compiled instance's width (``instance_head_dim``: 16 at 32,
    96 at 128), the columns past ``head_dim`` as zeros."""
    kvb = bytes_per_elem if kv_bytes is None else kv_bytes
    d = instance_head_dim(head_dim)
    return (STAGES * 2 * page * d * kvb
            + rows_per_block * d * bytes_per_elem
            + rows_per_block * page * 4)


def largest_page(head_dim: int, bytes_per_elem: int, smem_bytes: int,
                 kv_bytes: int | None = None) -> int:
    """The largest page whose tile fits ``smem_bytes`` of shared memory
    (head_dim 128 on an H100's 232,448 B: 111 keys in fp32, 222 in bf16;
    at the two-block budget of 115,712 B, 110 in bf16 and 217 for an fp8
    pool under bf16 q rows)."""
    fixed = smem_bytes_required(0, ROWS_PER_BLOCK, head_dim, bytes_per_elem,
                                kv_bytes)
    per_key = smem_bytes_required(1, ROWS_PER_BLOCK, head_dim,
                                  bytes_per_elem, kv_bytes) - fixed
    return (smem_bytes - fixed) // per_key


OPROJ_MAX_ROWS = 16        # batch rows of one group (csrc: kMaxRows)
OPROJ_WO_STAGES = 4        # wo steps in the ring (csrc: kStages)
OPROJ_STEP_BYTES = 16384   # one wo step (csrc: kStageBytes)
OPROJ_SLICES = (128, 256)  # E columns a block owns: 1 or 2 a thread
OPROJ_BLOCKS = 128         # the grid's least Hkv * E / slice
MAX_CLUSTER = 16           # blocks of one cluster (H100's non-portable 16)


def oproj_group_rows(batch: int | None = None) -> int:
    """Row slots of one batch group in ``flash_decode_oproj``: 8 up to 8
    rows, else :data:`OPROJ_MAX_ROWS` (None: the most any batch takes)."""
    return 8 if batch is not None and batch <= 8 else OPROJ_MAX_ROWS


def oproj_smem_bytes_required(page: int, groups: int, head_dim: int,
                              bytes_per_elem: int = 2, *,
                              batch: int | None = None) -> int:
    """Dynamic shared memory of one ``flash_decode_oproj`` block (csrc
    ``smem_bytes``): the decode tiles of :func:`smem_bytes_required` or
    the wo ring (:data:`OPROJ_WO_STAGES` steps of
    :data:`OPROJ_STEP_BYTES`), which overlays them, whichever is larger;
    the group's G x head_dim fp32 attention rows in
    :func:`oproj_group_rows` slots; one split's rows and its G running
    maxima and sums (:func:`oproj_splits`).  Neither E nor Hkv enters,
    nor B beyond 16 rows (larger batches run in groups)."""
    tiles = max(smem_bytes_required(page, ROWS_PER_BLOCK, head_dim,
                                    bytes_per_elem),
                OPROJ_WO_STAGES * OPROJ_STEP_BYTES)
    rows = oproj_group_rows(batch) + 1
    return tiles + (rows * head_dim + 2) * groups * 4


def oproj_splits(cluster: int, rows: int) -> int:
    """The ways a group's batch row's visible pages are split across a
    cluster's blocks in ``flash_decode_oproj``: ``cluster // rows`` where
    the cluster has at least as many blocks as the group has rows (block
    r runs split ``r % n`` of row ``r // n``; every block merges a row's
    splits in split order), else 1 (block r runs rows r, r + c, ...)."""
    return max(1, cluster // rows)


def oproj_grid(n_kv_heads: int, d_model: int) -> tuple[int, int, int]:
    """``(slice, slices, cluster)`` of ``flash_decode_oproj``'s grid
    (slices x Hkv blocks): the widest of :data:`OPROJ_SLICES` whose
    ``Hkv * ceil(E / slice)`` blocks reach :data:`OPROJ_BLOCKS` (the
    narrowest where none does: row 9's decode rule), and the cluster of a
    head's slices, the largest divisor of the slice count up to
    :data:`MAX_CLUSTER`."""
    wide = [w for w in OPROJ_SLICES
            if n_kv_heads * -(-d_model // w) >= OPROJ_BLOCKS]
    width = max(wide) if wide else min(OPROJ_SLICES)
    n = -(-d_model // width)
    return width, n, oproj_cluster(n)


def oproj_cluster(n_slices: int) -> int:
    """Blocks of one cluster in ``flash_decode_oproj``: the largest
    divisor of the head's slice count up to :data:`MAX_CLUSTER`; block
    ``r`` of a cluster runs the attention of batch rows ``r, r + c, ...``
    of each group."""
    return max(c for c in range(1, MAX_CLUSTER + 1) if n_slices % c == 0)


def oproj_hbm_bytes(batch: int, hkv: int, groups: int, head_dim: int,
                    d_model: int, seq: int, page: int,
                    bytes_per_elem: int = 2) -> int:
    """Global-memory bytes of one ``flash_decode_oproj`` call, as JAX's
    ``oproj_hbm_bytes`` counts them (q, K and V over ``ceil(seq / page)``
    pages a row, out) but with ``wo`` read once a call (per group of up
    to :data:`OPROJ_MAX_ROWS` rows), K and V once per cluster of a
    head's slices, and the fp32 (Hkv, B, E) workspace written and read
    back.  JAX's kernel reads ``wo`` once per batch row."""
    width, n, c = oproj_grid(hkv, d_model)
    nb = -(-seq // page)
    q_bytes = batch * hkv * groups * head_dim * bytes_per_elem
    kv = 2 * batch * hkv * nb * page * head_dim * bytes_per_elem * (n // c)
    reads = -(-batch // OPROJ_MAX_ROWS)
    wo = reads * hkv * groups * head_dim * d_model * bytes_per_elem
    ws = 2 * hkv * batch * d_model * 4
    out = batch * d_model * bytes_per_elem
    return q_bytes + kv + wo + ws + out


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
_FP8_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
FP8 = torch.float8_e4m3fn
_OPROJ_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *, window: int | None = None,
                        logit_cap: float | None = None,
                        q_span: int = 1) -> torch.Tensor:
    """Plain version: gather pages by block table, dense masked softmax
    in fp32 — the counterpart of the JAX ``paged_attention_ref``."""
    b, hkv, gtot, d = q.shape
    g = gtot // q_span
    _, page, _, _ = k_pages.shape
    nb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * page, hkv, d).float()
    v = v_pages[bt].reshape(b, nb * page, hkv, d).float()
    s = torch.einsum("bhgd,blhd->bhgl", q.float(), k) * d ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    kpos = torch.arange(nb * page, device=q.device)
    offs = torch.arange(gtot, device=q.device) // g    # row -> position off
    lim = lengths.long()[:, None] + offs[None, :]      # (b, gtot)
    valid = kpos[None, None, :] < lim[..., None]
    if window is not None:
        valid &= kpos[None, None, :] > (lim[..., None] - 1) - window
    s = torch.where(valid[:, None, :, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", probs, v)
    return out.to(q.dtype)


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor, *, window: int | None = None,
                 logit_cap: float | None = None,
                 q_span: int = 1) -> torch.Tensor:
    """Paged attention over one q block per (batch, kv head); returns the
    shape of ``q`` in ``q.dtype``.  With ``q_span > 1`` the rows hold
    consecutive positions, each under its own causal limit.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`paged_attention_ref`.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, window=window,
                                   logit_cap=logit_cap, q_span=q_span)
    _refuse_grad("flash_decode", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, block_tables, lengths, q_span, window)
    b, hkv, gtot, d = q.shape
    page = k_pages.shape[1]
    out = torch.empty_like(q)
    fn = _build.load("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), b, hkv, gtot, q_span, page,
             block_tables.shape[1], int(window or 0),
             float(logit_cap or 0.0),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def paged_attention_fp8_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, k_scale, v_scale,
                            block_tables: torch.Tensor,
                            lengths: torch.Tensor, *,
                            window: int | None = None,
                            logit_cap: float | None = None,
                            q_span: int = 1) -> torch.Tensor:
    """Plain version of :func:`flash_decode_fp8`, as JAX's oracle:
    dequantize the pools in fp32 with the per-kv-head scales, then
    :func:`paged_attention_ref`."""
    hkv = k_pages.shape[2]
    ks = torch.as_tensor(k_scale, dtype=torch.float32,
                         device=q.device).reshape(1, 1, hkv, 1)
    vs = torch.as_tensor(v_scale, dtype=torch.float32,
                         device=q.device).reshape(1, 1, hkv, 1)
    return paged_attention_ref(q, k_pages.float() * ks,
                               v_pages.float() * vs, block_tables, lengths,
                               window=window, logit_cap=logit_cap,
                               q_span=q_span)


def flash_decode_fp8(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *, window: int | None = None,
                     logit_cap: float | None = None,
                     q_span: int = 1) -> torch.Tensor:
    """:func:`flash_decode` over ``float8_e4m3fn`` pools, with fp32
    per-kv-head dequantisation scales ``k_scale``, ``v_scale`` (Hkv,)
    (ones for a pure-cast cache).  Returns the shape of ``q`` in
    ``q.dtype``.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`paged_attention_fp8_ref`.
    """
    if q.device.type == "cpu":
        return paged_attention_fp8_ref(q, k_pages, v_pages, k_scale,
                                       v_scale, block_tables, lengths,
                                       window=window, logit_cap=logit_cap,
                                       q_span=q_span)
    _refuse_grad("flash_decode_fp8", q, k_pages, v_pages, k_scale, v_scale)
    _check(q, k_pages, v_pages, block_tables, lengths, q_span, window,
           kv_dtype=FP8)
    b, hkv, gtot, d = q.shape
    scales = []
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (not isinstance(t, torch.Tensor) or t.device != q.device
                or t.dtype != torch.float32 or t.numel() != hkv):
            raise ValueError(f"{name} must be an fp32 tensor of {hkv} "
                             f"values on {q.device}")
        scales.append(t.contiguous())
    page = k_pages.shape[1]
    out = torch.empty_like(q)
    fn = _build.load("flash_decode_fp8", "flash_decode_fp8_fwd",
                     _FP8_ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), scales[0].data_ptr(), scales[1].data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
             hkv, gtot, q_span, page, block_tables.shape[1],
             int(window or 0), float(logit_cap or 0.0),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_fp8")
    flash_decode_fp8.launches += 1
    return out


flash_decode_fp8.launches = 0


def paged_attention_oproj_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor, wo: torch.Tensor, *,
                              window: int | None = None,
                              logit_cap: float | None = None
                              ) -> torch.Tensor:
    """Plain version: paged attention, then the dense projection over the
    flattened heads, in fp32 with one cast.  q (B, Hkv, G, D); wo
    (Hkv, G*D, E).  The attention rows stay fp32 into the projection, as
    in the TPU kernel and the CUDA one (the JAX oracle rounds them to q's
    dtype first; at fp32 the two are the same)."""
    b, hkv, g, d = q.shape
    attn = paged_attention_ref(q.float(), k_pages.float(), v_pages.float(),
                               block_tables, lengths, window=window,
                               logit_cap=logit_cap)       # (B, Hkv, G, D)
    out = attn.reshape(b, hkv * g * d) @ wo.reshape(hkv * g * d, -1).float()
    return out.to(q.dtype)


def flash_decode_oproj(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, wo: torch.Tensor, *,
                       window: int | None = None,
                       logit_cap: float | None = None) -> torch.Tensor:
    """Single-token paged attention fused with the output projection:
    q (B, Hkv, G, D), wo (Hkv, G*D, E) -> (B, E) in q's dtype.  One
    launch reads ``wo`` once per group of up to 16 batch rows
    (:func:`oproj_grid`), the heads summed in order through an fp32
    (Hkv, B, E) workspace; the slice counters (zero, kept per device,
    left zero by every launch) make the launches of one device share a
    stream.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`paged_attention_oproj_ref`.
    """
    if q.device.type == "cpu":
        return paged_attention_oproj_ref(q, k_pages, v_pages, block_tables,
                                         lengths, wo, window=window,
                                         logit_cap=logit_cap)
    _refuse_grad("flash_decode_oproj", q, k_pages, v_pages, wo)
    _check(q, k_pages, v_pages, block_tables, lengths, 1, window)
    b, hkv, g, d = q.shape
    if wo.dim() != 3 or tuple(wo.shape[:2]) != (hkv, g * d):
        raise ValueError(f"wo {tuple(wo.shape)} is not (Hkv={hkv}, "
                         f"G*D={g * d}, E)")
    if wo.dtype != q.dtype or wo.device != q.device \
            or not wo.is_contiguous() or wo.data_ptr() % 16:
        raise ValueError("wo must be a contiguous, 16-byte aligned tensor "
                         "on q's device in q's dtype")
    e = wo.shape[2]
    if e % (16 // q.element_size()):
        raise ValueError(f"E = {e} must be a multiple of "
                         f"{16 // q.element_size()} (16-byte wo rows)")
    page = k_pages.shape[1]
    need = oproj_smem_bytes_required(page, g, d, q.element_size(), batch=b)
    have = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(
            f"page {page} at G = {g}, D = {d} needs {need} bytes of shared "
            f"memory per block; this card allows {have}")
    width, n_slices, cluster = oproj_grid(hkv, e)
    n_counters = -(-b // oproj_group_rows(b)) * n_slices
    counters = _COUNTERS.get(q.device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32,
                               device=q.device)
        _COUNTERS[q.device] = counters
    ws = torch.empty((hkv, b, e), dtype=torch.float32, device=q.device)
    out = torch.empty((b, e), dtype=q.dtype, device=q.device)
    fn = _build.load("flash_decode_oproj", "flash_decode_oproj_fwd",
                     _OPROJ_ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             wo.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), b, hkv, g, page, block_tables.shape[1], e,
             width, cluster, int(window or 0), float(logit_cap or 0.0),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_oproj")
    flash_decode_oproj.launches += 1
    return out


flash_decode_oproj.launches = 0


def _refuse_grad(name: str, *tensors) -> None:
    """The paged kernels are inference-only, as JAX's paged ops (no VJP):
    under grad, an input that requires one raises instead of dropping
    its gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward (the paged ops are inference-only, as "
            "in JAX); call it under torch.no_grad() or on tensors that do "
            "not require grad")


def _check(q, k_pages, v_pages, block_tables, lengths, q_span, window,
           kv_dtype=None):
    """Raise on what the paged kernels do not take.  ``kv_dtype``: the
    pools' dtype when it is not q's (fp8)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {sorted(map(str, _DTYPES))}; "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        want = q.dtype if name == "q" or kv_dtype is None else kv_dtype
        if t.dtype != want or t.dim() != 4:
            raise TypeError(f"{name} must be 4-D in {want}; got "
                            f"{t.dtype}, {t.dim()}-D")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 16-byte vectors)")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    b, hkv, gtot, d = q.shape
    if (k_pages.shape != v_pages.shape or k_pages.shape[2] != hkv
            or k_pages.shape[3] != d):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError("block_tables must be (B, n_blocks), lengths (B,)")
    if q_span < 1 or gtot % q_span:
        raise ValueError(f"q rows {gtot} not divisible by q_span {q_span}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_head_dim(d)
    page = k_pages.shape[1]
    need = smem_bytes_required(page, ROWS_PER_BLOCK, d, q.element_size(),
                               k_pages.element_size())
    have = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(
            f"page {page} needs {need} bytes of shared memory per block; "
            f"this card allows {have}")
