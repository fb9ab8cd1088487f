"""Paged flash-decode attention: CUDA kernel, wrapper and plain version.

Port of ``repro.kernels.flash_decode.flash_decode`` (the TPU kernel of
paged decode and chunked prefill).  The kernel lives in
``csrc/flash_decode.cu`` (design and bound in its header comment).  As
on the TPU, the KV tile is whole pages: the page size the blocking model
chooses (``serve.kv_cache.choose_page_size``) is the unit the kernel
stages, and :func:`page_smem_bytes` is what the Hopper adapter's
``"flash_decode"`` search prices.

The bf16 instances of rows 1 and 2 (``csrc/decode_mma.cuh``) split each
row tile's visible pages over a cluster of :func:`decode_splits` blocks
and score a kv head's query rows together on the tensor cores; their
footprint is :func:`decode_smem_bytes`.  The fp32 instances keep
``csrc/attn_rows.cuh``, one block of 4 rows a (batch, kv head), one page
a step (:func:`smem_bytes_required`, which row 3 prices too).

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
(Hkv, G*D, E) give (B, E).  Its grid is E slices by kv heads and their
query-head chunks (:func:`oproj_grid`, :func:`oproj_chunks`): the
blocks of a (head, chunk)'s slices form clusters that run its attention
once per batch row and share the rows through distributed shared
memory, each block streams its slice of the chunk's ``wo`` rows once for
every batch row, and the last block of a slice sums the fp32 partials
head by head, chunk by chunk, so the attention output never reaches
HBM.  Its page is priced by :func:`oproj_smem_bytes_required`
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
import functools

import torch

from repro_torch.core.hopper_adapter import H100_SXM, default_smem_budget
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


DECODE_ROWS = 16       # query rows of a bf16 block: one m16 tile (kRows)
DECODE_WARPS = 4       # warps of a block, each taking 16-key chunks (kWarps)
DECODE_CHUNK = 16      # keys a warp scores at once (kChunk)
DECODE_STAGES = 2      # ring steps in flight (kStages)
DECODE_TABLE = 128     # page indices a block holds at once (kTable)
DECODE_PAD = 8         # floats past D in a warp's merge row (kPad)


def decode_step_pages(page: int, head_dim: int) -> int:
    """Pages one ring step of the bf16 decode core stages: whole pages of
    at least 64 keys (32 at the 256-wide instance), or one longer page
    (csrc ``step_pages``)."""
    keys = 4 * DECODE_CHUNK if instance_head_dim(head_dim) <= 128 \
        else 2 * DECODE_CHUNK
    return 1 if page >= keys else keys // page


def decode_step_rows(page: int, head_dim: int) -> int:
    """Staged rows of one ring step: its pages' keys in whole 16-key
    chunks (csrc ``step_rows``)."""
    return -(-decode_step_pages(page, head_dim) * page // DECODE_CHUNK) \
        * DECODE_CHUNK


def decode_smem_bytes(page: int, head_dim: int, kv_bytes: int = 2) -> int:
    """Dynamic shared memory of one block of the bf16 decode core (csrc
    ``decode_mma::smem_bytes``): the ring, :data:`DECODE_STAGES` steps of
    K and V rows at ``kv_bytes`` (1 for an fp8 pool, with each warp's
    16-key bf16 widening scratch), overlaid by the warps' fp32 merge rows
    once drained; the q tile, the page table and the (max, sum) pairs.
    Rows are staged at the compiled width (``instance_head_dim``).  The
    query span never enters: row tiles are blocks of their own."""
    d = instance_head_dim(head_dim)
    ring = DECODE_STAGES * 2 * decode_step_rows(page, head_dim) * d * kv_bytes
    if kv_bytes == 1:
        ring += DECODE_WARPS * DECODE_CHUNK * d * 2
    merge = DECODE_WARPS * DECODE_ROWS * (d + DECODE_PAD) * 4
    return (max(ring, merge) + DECODE_ROWS * d * 2 + DECODE_TABLE * 4
            + (DECODE_WARPS + 1) * DECODE_ROWS * 2 * 4)


def page_smem_bytes(page: int, head_dim: int, bytes_per_elem: int = 2,
                    kv_bytes: int | None = None) -> int:
    """The footprint of the paged decode instance that runs these widths:
    the bf16 decode core (:func:`decode_smem_bytes`) for bf16 q rows, the
    fp32 instance's ``attn_rows`` tiles (:func:`smem_bytes_required`)
    otherwise.  The ``"flash_decode"`` and ``"flash_decode_fp8"`` keys
    price their pages by it."""
    if bytes_per_elem == 2:
        return decode_smem_bytes(page, head_dim,
                                 bytes_per_elem if kv_bytes is None
                                 else kv_bytes)
    return smem_bytes_required(page, ROWS_PER_BLOCK, head_dim,
                               bytes_per_elem, kv_bytes)


def decode_splits(batch: int, hkv: int, rows: int, n_blocks: int, *,
                  max_cluster: int | None = None) -> int:
    """Runs of each row tile's visible pages in the bf16 decode core, one
    block each, one cluster a tile: the least count whose ``batch * hkv *
    ceil(rows / 16) * splits`` blocks fill the H100's 132 SMs, capped by
    ``n_blocks`` (no run below one page) and the cluster limit
    (:data:`MAX_CLUSTER`).  From shapes only: the host never reads
    ``lengths``, so a short row's later runs may be empty."""
    tiles = batch * hkv * -(-rows // DECODE_ROWS)
    want = -(-H100_SXM.sms // max(tiles, 1))
    cap = MAX_CLUSTER if max_cluster is None else max_cluster
    return max(1, min(want, n_blocks, cap))


@functools.lru_cache(maxsize=None)
def decode_grid(batch: int, hkv: int, rows: int, page: int, n_blocks: int,
                head_dim: int, kv_bytes: int = 2) -> tuple[int, int, int]:
    """``(splits, cluster, blocks)`` of the bf16 decode core's launch at
    these shapes, as the wrapper picks them: a cluster above the portable
    8 only where two blocks share an SM (the footprint within the
    two-block budget), so that 16 blocks fit one GPC.  Cached by shape:
    each decode step asks it once a layer."""
    two = decode_smem_bytes(page, head_dim, kv_bytes) <= default_smem_budget()
    splits = decode_splits(batch, hkv, rows, n_blocks,
                           max_cluster=MAX_CLUSTER if two else 8)
    return splits, splits, splits * hkv * batch * -(-rows // DECODE_ROWS)


def hbm_bytes(batch: int, hkv: int, groups: int, head_dim: int, seq: int,
              page: int, bytes_per_elem: int = 2,
              kv_bytes: int | None = None, q_span: int = 1) -> int:
    """Global-memory bytes of one :func:`flash_decode` (``kv_bytes=1``:
    :func:`flash_decode_fp8`) call whose rows each see ``seq`` keys, in
    whole pages (block tables and lengths excluded, as in JAX).

    bf16 (``csrc/decode_mma.cuh``): grid (splits, Hkv, B x row tiles of
    16 rows), :func:`decode_grid`'s split count; every block of a tile's
    cluster stages the tile's q rows, the runs partition the tile's
    pages (each K and V page read once a row tile), and the output is
    written once.  fp32 (``attn_rows``): one block a (b, kv head) per 4
    rows, each streaming every visible page.  An fp8 pool's pages are
    ``kv_bytes`` wide and every block reads its head's two fp32 scales.
    JAX's count reads each page once per (b, kv head)."""
    kvb = bytes_per_elem if kv_bytes is None else kv_bytes
    rows = q_span * groups
    nb = -(-seq // page)
    if bytes_per_elem == 2:
        tiles = -(-rows // DECODE_ROWS)
        splits = decode_grid(batch, hkv, rows, page, nb, head_dim, kvb)[0]
    else:
        tiles, splits = -(-rows // ROWS_PER_BLOCK), 1
    pairs = batch * hkv
    q = pairs * rows * head_dim * bytes_per_elem
    kv = 2 * pairs * tiles * nb * page * head_dim * kvb
    scales = 2 * 4 * pairs * tiles * splits if kv_bytes is not None else 0
    return q * splits + kv + q + scales


OPROJ_MAX_ROWS = 16        # batch rows of one group (csrc: kMaxRows)
OPROJ_WO_STAGES = 4        # wo steps in the ring (csrc: kStages)
OPROJ_STEP_BYTES = 16384   # one wo step (csrc: kStageBytes)
OPROJ_SLICES = (128, 256)  # E columns a block owns: 1 or 2 a thread
OPROJ_BLOCKS = 128         # the grid's least partials * E / slice
MAX_CLUSTER = 16           # blocks of one cluster (H100's non-portable 16)


def oproj_group_rows(batch: int | None = None) -> int:
    """Row slots of one batch group in ``flash_decode_oproj``: 8 up to 8
    rows, else :data:`OPROJ_MAX_ROWS` (None: the most any batch takes)."""
    return 8 if batch is not None and batch <= 8 else OPROJ_MAX_ROWS


def oproj_head_chunk(groups: int, head_dim: int,
                     batch: int | None = None) -> int:
    """Query heads of one partial of ``flash_decode_oproj`` (csrc
    ``head_chunk``): all G where their fp32 rows in
    :func:`oproj_group_rows` slots, one split's rows and their (max, sum)
    pairs fit the two-block budget beside the wo ring; else the most
    that do, in whole warps' worth of rows (:data:`ROWS_PER_BLOCK`);
    where not even one warp's rows fit, the most heads that do, at least
    one (the kernel takes any chunk).  granite-3-8b (G 4, D 128): 4, one
    pass; glm4-9b (G 16) and granite-34b (G 48) at D 128: 8 up to 8
    batch rows, else 4; recurrentgemma-9b (G 16, D 256): 4 up to 8 batch
    rows, else 2.  From shapes only, like the grid."""
    per_head = (oproj_group_rows(batch) + 1) * head_dim * 4 + 2 * 4
    room = default_smem_budget() - OPROJ_WO_STAGES * OPROJ_STEP_BYTES
    fit = room // per_head
    if fit >= groups:
        return groups
    if fit >= ROWS_PER_BLOCK:
        return fit - fit % ROWS_PER_BLOCK
    return max(fit, 1)


def oproj_chunks(groups: int, head_dim: int,
                 batch: int | None = None) -> int:
    """Query-head chunks of a kv head in ``flash_decode_oproj``
    (:func:`oproj_head_chunk` heads each, the last short): each is a
    partial of its own, Hkv x chunks of them on the grid's second axis.
    glm4-9b: 2 up to 8 batch rows, else 4; granite-34b: 6, else 12."""
    return -(-groups // oproj_head_chunk(groups, head_dim, batch))


def oproj_smem_bytes_required(page: int, groups: int, head_dim: int,
                              bytes_per_elem: int = 2, *,
                              batch: int | None = None) -> int:
    """Dynamic shared memory of one ``flash_decode_oproj`` block (csrc
    ``smem_bytes``): the decode tiles of :func:`smem_bytes_required` or
    the wo ring (:data:`OPROJ_WO_STAGES` steps of
    :data:`OPROJ_STEP_BYTES`), which overlays them, whichever is larger;
    one head chunk's (:func:`oproj_head_chunk`) head_dim-wide fp32
    attention rows in :func:`oproj_group_rows` slots; one split's rows
    and their running maxima and sums (:func:`oproj_splits`).  Neither E
    nor Hkv enters, nor B beyond 16 rows (larger batches run in groups),
    nor G past the chunk."""
    tiles = max(smem_bytes_required(page, ROWS_PER_BLOCK, head_dim,
                                    bytes_per_elem),
                OPROJ_WO_STAGES * OPROJ_STEP_BYTES)
    rows = oproj_group_rows(batch) + 1
    chunk = oproj_head_chunk(groups, head_dim, batch)
    return tiles + (rows * head_dim + 2) * chunk * 4


def oproj_splits(cluster: int, rows: int) -> int:
    """The ways a group's batch row's visible pages are split across a
    cluster's blocks in ``flash_decode_oproj``: ``cluster // rows`` where
    the cluster has at least as many blocks as the group has rows (block
    r runs split ``r % n`` of row ``r // n``; every block merges a row's
    splits in split order), else 1 (block r runs rows r, r + c, ...)."""
    return max(1, cluster // rows)


def oproj_grid(n_kv_heads: int, d_model: int,
               chunks: int = 1) -> tuple[int, int, int]:
    """``(slice, slices, cluster)`` of ``flash_decode_oproj``'s grid
    (slices x Hkv x ``chunks`` blocks, :func:`oproj_chunks`): the widest
    of :data:`OPROJ_SLICES` whose ``Hkv * chunks * ceil(E / slice)``
    blocks reach :data:`OPROJ_BLOCKS` (the narrowest where none does: row
    9's decode rule), and the cluster of a partial's slices, the largest
    divisor of the slice count up to :data:`MAX_CLUSTER`."""
    wide = [w for w in OPROJ_SLICES
            if n_kv_heads * chunks * -(-d_model // w) >= OPROJ_BLOCKS]
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
    (head, chunk)'s slices, and the fp32 (Hkv x chunks, B, E) workspace
    (:func:`oproj_chunks`) written once and read back once.  JAX's
    kernel reads ``wo`` once per batch row."""
    passes = oproj_chunks(groups, head_dim, batch)
    width, n, c = oproj_grid(hkv, d_model, passes)
    nb = -(-seq // page)
    q_bytes = batch * hkv * groups * head_dim * bytes_per_elem
    kv = 2 * batch * hkv * nb * page * head_dim * bytes_per_elem * (n // c)
    reads = -(-batch // OPROJ_MAX_ROWS)
    wo = reads * hkv * groups * head_dim * d_model * bytes_per_elem
    ws = 2 * passes * hkv * batch * d_model * 4
    out = batch * d_model * bytes_per_elem
    return q_bytes + kv + wo + ws + out


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_FP8_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
FP8 = torch.float8_e4m3fn
_OPROJ_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
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
    consecutive positions, each under its own causal limit.  bf16 q rows
    run :func:`decode_grid`'s split count, fp32 ones one block a (batch,
    kv head).

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`paged_attention_ref`.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, window=window,
                                   logit_cap=logit_cap, q_span=q_span)
    _refuse_grad("flash_decode", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, block_tables, lengths, q_span, window)
    _check_launch(q, k_pages)
    b, hkv, gtot, d = q.shape
    page, n_blocks = k_pages.shape[1], block_tables.shape[1]
    splits = _splits(q, page, n_blocks, k_pages.element_size())
    out = torch.empty_like(q)
    fn = _build.load("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), b, hkv, gtot, q_span, page, n_blocks,
             int(window or 0), float(logit_cap or 0.0), splits,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    flash_decode.instance = _instance(q, splits)
    return out


flash_decode.launches = 0
flash_decode.instance = None


def _splits(q: torch.Tensor, page: int, n_blocks: int,
            kv_bytes: int) -> int:
    """The launch's split count: :func:`decode_grid`'s for bf16 q rows; 1
    for the fp32 instance (one block of 4 rows a (b, kv head))."""
    if q.dtype != torch.bfloat16:
        return 1
    b, hkv, gtot, d = q.shape
    return decode_grid(b, hkv, gtot, page, n_blocks, d, kv_bytes)[0]


def _instance(q: torch.Tensor, splits: int) -> tuple:
    """What a launch ran: ``("mma", splits)`` (the bf16 decode core) or
    ``("rows", 1)`` (the fp32 ``attn_rows`` instance)."""
    return ("mma", splits) if q.dtype == torch.bfloat16 else ("rows", 1)


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
    _check_launch(q, k_pages)
    b, hkv, gtot, d = q.shape
    scales = []
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (not isinstance(t, torch.Tensor) or t.device != q.device
                or t.dtype != torch.float32 or t.numel() != hkv):
            raise ValueError(f"{name} must be an fp32 tensor of {hkv} "
                             f"values on {q.device}")
        scales.append(t.contiguous())
    page, n_blocks = k_pages.shape[1], block_tables.shape[1]
    splits = _splits(q, page, n_blocks, 1)
    out = torch.empty_like(q)
    fn = _build.load("flash_decode_fp8", "flash_decode_fp8_fwd",
                     _FP8_ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), scales[0].data_ptr(), scales[1].data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
             hkv, gtot, q_span, page, n_blocks, int(window or 0),
             float(logit_cap or 0.0), splits,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_fp8")
    flash_decode_fp8.launches += 1
    flash_decode_fp8.instance = _instance(q, splits)
    return out


flash_decode_fp8.launches = 0
flash_decode_fp8.instance = None


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
    (:func:`oproj_grid`), the query heads in chunks side by side where
    their rows overflow the budget (:func:`oproj_chunks`), the partials
    summed in order through an fp32 (Hkv x chunks, B, E) workspace; the
    slice counters (zero, kept per device, left zero by every launch)
    make the launches of one device share a stream.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`paged_attention_oproj_ref`.
    """
    if q.device.type == "cpu":
        return paged_attention_oproj_ref(q, k_pages, v_pages, block_tables,
                                         lengths, wo, window=window,
                                         logit_cap=logit_cap)
    _refuse_grad("flash_decode_oproj", q, k_pages, v_pages, wo)
    _check(q, k_pages, v_pages, block_tables, lengths, 1, window)
    _check_launch(q, k_pages, split_core=False)
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
    chunks = oproj_chunks(g, d, b)
    width, n_slices, cluster = oproj_grid(hkv, e, chunks)
    n_counters = -(-b // oproj_group_rows(b)) * n_slices
    counters = _COUNTERS.get(q.device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32,
                               device=q.device)
        _COUNTERS[q.device] = counters
    ws = torch.empty((hkv * chunks, b, e), dtype=torch.float32,
                     device=q.device)
    out = torch.empty((b, e), dtype=q.dtype, device=q.device)
    fn = _build.load("flash_decode_oproj", "flash_decode_oproj_fwd",
                     _OPROJ_ARGTYPES)
    err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             wo.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), b, hkv, g, page, block_tables.shape[1], e,
             width, cluster, oproj_head_chunk(g, d, b), int(window or 0),
             float(logit_cap or 0.0),
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


def _check_launch(q, k_pages, split_core=True):
    """Raise where the launch itself would be refused: a page whose
    footprint (the instance's that runs, or with ``split_core=False``
    ``attn_rows``') overflows the card's shared memory, or more 16-row
    tiles than the bf16 core's grid holds."""
    b, _, gtot, d = q.shape
    page = k_pages.shape[1]
    esz, kvb = q.element_size(), k_pages.element_size()
    need = (page_smem_bytes(page, d, esz, kvb) if split_core
            else smem_bytes_required(page, ROWS_PER_BLOCK, d, esz, kvb))
    have = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(
            f"page {page} needs {need} bytes of shared memory per block; "
            f"this card allows {have}")
    if split_core and esz == 2 and b * -(-gtot // DECODE_ROWS) > 65535:
        raise ValueError(f"{b} batch rows of {gtot} query rows exceed the "
                         "grid's 65,535 row tiles")
