"""Hopper instantiation of the blocking model (the counterpart of
``repro.core.tpu_adapter``).

The paper's model is hierarchy-agnostic.  On an H100 the level a kernel
blocks for is a thread block's shared memory (at most 227 KB, opt-in),
with HBM (3.35 TB/s) above it; the output tile of a GEMM lives in
registers, not in shared memory, so the register file caps it
separately.  This module runs the paper's optimizer with that hierarchy
and Hopper's alignment and emits:

* ``matmul_tile_candidates`` / ``matmul_tiles`` -- (bm, bk, bn) tiles for
  the blocked-GEMM kernel (``kernels/matmul_blocked.py``; the
  ``"matmul"`` key takes ``fused=True``, since in bf16 it runs the fused
  GEMM's tensor-core instances);
* ``flash_decode_tile_candidates`` -- ``(page,)`` for the paged
  flash-decode kernel, whose KV tile is one page, so the tile is also the
  paged cache's page size;
* ``qkv_fused_tile_candidates`` -- (bm, bk, bn) for the fused QKV kernel,
  bn per projection: in fp32 its joint (G+2)*bn tile within the GEMM
  core's limits, in bf16 one projection's (bm, bn) tile on the fused
  GEMM's tensor-core instances (at decode :func:`qkv_decode_tile`);
* ``flash_decode_oproj_tile_candidates`` -- ``(page,)`` for the
  oproj-fused decode kernel (the page of a fused engine);
* ``backward_tile_candidates("matmul_dgrad", ...)`` -- (bm, bk, bn) for
  the dgrad kernels (``kernels/matmul_bwd.py``): the GEMM search over
  the cotangent's (M_out, N_out, K_reduce), as JAX reuses it, snapped to
  the dgrad kernels' own footprint (in bf16 their tensor-core warp
  grid);
* ``flash_tiles`` -- ``(block_q, block_kv)``, the tiles of the
  flash-attention forward and its backward's two passes, checked
  against each pass's own footprint;
* ``conv_tile_candidates`` / ``conv_tiles`` -- (bx, by, bc, bk) for the
  direct blocked conv (``kernels/conv2d_blocked.py``, row 12), and
  ``backward_tile_candidates("conv2d_dgrad" | "conv2d_wgrad", ...)`` for
  its backward: the dgrad's transposed conv on row 12 at stride 1, the
  wgrad on row 13 (``kernels/conv2d_bwd.py``) under its own footprint;
* ``layer_sharding_advice`` -- the paper's multicore rule (§3.3) at mesh
  scale, as the reference's adapter states it.

``"matmul_fused"`` (and ``"matmul_fused_w8"``, its int8 weight at one
byte) takes ``matmul_tile_candidates(fused=True)``: in fp32 the blocked
GEMM's tiles (its kernel runs that tile core), in bf16 tiles snapped to
the fused kernel's tensor-core instances (:func:`fused_fits`), and at
M <= 16 one decode tile for the transposed instance whose column blocks
fill the card (:func:`fused_decode_tile`).  The quantized keys take the
same two searches with their narrow operand at one byte:
``"matmul_w8"`` ``matmul_tile_candidates(w_bytes=1, fused=True)`` (its
bf16 kernels are the fused GEMM's tensor-core instances, so it takes
``"matmul_fused_w8"``'s tiles; in fp32 the int8 weight tile priced by
the tile core's footprint; N and K tiles stay multiples of 64, or at
decode of 16, so bn is a whole number of 16-byte int8 copies whenever
N is), and ``"flash_decode_fp8"``
``flash_decode_tile_candidates(kv_bytes=1)`` (1-byte pages under bf16
q rows: at D = 128 a page of up to 217 keys fits the two-block budget of
115,712 B, against 110 at 2 bytes; the model chooses).  Each candidate is
checked against the CUDA kernel's own footprint (``smem_bytes_required``,
and for the GEMMs ``accumulators_per_thread``), imported lazily so the
model stays importable without the kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.hierarchy import MemLevel
from repro_torch.core.loopnest import Dim, Problem, divisors
from repro_torch.core.optimizer import ranked_level0_tiles


@dataclasses.dataclass(frozen=True)
class HopperTarget:
    """One Hopper card, as the blocking model sees it (frozen: the tuner
    memoizes derivations on it)."""

    name: str
    peak_bf16_flops: float
    hbm_bytes_per_s: float
    sms: int
    smem_optin_bytes: int     # shared memory one block may opt in to
    blocks_per_sm: int        # resident blocks the GEMM design wants
    acc_per_thread: int       # fp32 accumulator registers per thread
    smem_per_sm_bytes: int = 233_472      # shared memory of one SM
    smem_reserved_per_block: int = 1_024  # kept by the card per resident block
    attn_acc_per_thread: int = 160  # fp32 accumulators of a flash thread
    m_mult: int = 16          # M tiles: multiples of 16 (extents < 16 whole)
    nk_mult: int = 64         # N and K tiles: eight 16-byte bf16 vectors
    key_mult: int = 32        # flash-decode KV tile: one key per lane


# NVIDIA's data sheet and the Hopper white paper (H100 SXM).  The GEMM
# designs (the fp32 tile core, csrc/gemm_tile.cuh, and the bf16
# tensor-core instances, csrc/gemm_mma.cuh and gemm_mma_inst.cuh) run 256
# threads a block, each holding at most 64 fp32 sums: 64 of a thread's
# 128 registers when two blocks share an SM's 65,536.  The
# flash-attention tensor-core instances
# (csrc/attn_mma.cuh) hold at most 160 fp32 sums a thread, of the 255
# registers a thread may have: the rest hold fragments, addresses and
# the softmax state.
H100_SXM = HopperTarget(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    hbm_bytes_per_s=3.35e12,
    sms=132,
    smem_optin_bytes=232_448,
    blocks_per_sm=2,
    acc_per_thread=64,
)


def default_smem_budget(target: HopperTarget = H100_SXM,
                        smem_budget_bytes: int | None = None) -> int:
    """Shared memory one block's tiles may use: the SM's shared memory
    split over the resident blocks the GEMM design wants (two, so one
    block's copies overlap the other's multiplies; the kernel itself
    keeps only two stages in flight), less the 1 KB the card reserves
    for each block, and never more than one block may opt in to.  On the
    H100: 233,472 // 2 - 1,024 = 115,712 B.  The single rule shared by
    the snap loops here and the candidate filter in
    ``repro_torch.tune.lowering``."""
    return smem_budget_bytes or min(
        target.smem_optin_bytes,
        target.smem_per_sm_bytes // target.blocks_per_sm
        - target.smem_reserved_per_block)


def _round_to(v: int, mult: int, lo: int, hi: int) -> int:
    v = max(lo, min(hi, (v // mult) * mult))
    return v if v >= mult else min(hi, mult)


def _pick_tile(extent: int, target: int, mult: int) -> int:
    """Largest tile <= target that is a multiple of ``mult`` and <= extent;
    prefers exact divisors of extent to avoid ragged tail blocks."""
    if extent <= mult:
        return extent
    cap = min(target, extent)
    aligned_divs = [d for d in divisors(extent) if d % mult == 0 and d <= cap]
    if aligned_divs:
        return max(aligned_divs)
    return _round_to(cap, mult, mult, extent)


def matmul_fits(bm: int, bk: int, bn: int, bytes_per_elem: int,
                budget: int, target: HopperTarget = H100_SXM,
                w_bytes: int | None = None) -> bool:
    """Whether the GEMM kernel holds these tiles: its staged A and B
    tiles (B at ``w_bytes``: 1 for an int8 weight) within ``budget`` and
    its accumulator within the register limit (lazy import: the kernel
    module owns its footprint)."""
    from repro_torch.kernels.matmul_blocked import (accumulators_per_thread,
                                                    smem_bytes_required)
    return (smem_bytes_required(bm, bk, bn, bytes_per_elem, w_bytes)
            <= budget
            and accumulators_per_thread(bm, bn) <= target.acc_per_thread)


def decode_smem_limit(N: int | None, bn: int, budget: int,
                      target: HopperTarget = H100_SXM, *,
                      blocks: int | None = None) -> int:
    """Shared memory a decode block of the tensor-core GEMM instances may
    use: where its column blocks (``blocks``, else ``ceil(N / bn)``) are
    one wave at one block an SM, the opt-in of one block (a second
    resident block would have no work); else, or with neither known,
    ``budget`` (two blocks an SM)."""
    if blocks is None and N is not None:
        blocks = -(-N // bn)
    if blocks is not None and blocks <= target.sms:
        return max(budget, target.smem_optin_bytes)
    return budget


def fused_fits(M: int, bm: int, bk: int, bn: int, bytes_per_elem: int,
               budget: int, target: HopperTarget = H100_SXM,
               w_bytes: int | None = None, N: int | None = None, *,
               blocks: int | None = None) -> bool:
    """Whether the epilogue-fused GEMM's instance for ``M`` rows holds
    these tiles (``kernels/matmul_fused.py``): fp32, the blocked GEMM's
    tile core (:func:`matmul_fits`); bf16, its staged tiles at the
    instance's stages within ``budget`` and its fp32 sums within the
    register limit -- ``"mma"`` (M > 16) on a warp grid that leaves at
    most ``MAX_EMPTY_ROWS`` of its computed rows empty, ``"mma_t"``
    (M <= 16) at a bn it is compiled for, within
    :func:`decode_smem_limit` of the output's N columns (or of the
    grid's ``blocks``).  Rows 10 and 11 run the same two instances."""
    if bytes_per_elem != 2:
        return matmul_fits(bm, bk, bn, bytes_per_elem, budget, target,
                           w_bytes)
    from repro_torch.kernels.matmul_bwd import MMA_M, empty_row_share
    from repro_torch.kernels.matmul_fused import (MMA_T_COLS, MMA_T_ROWS,
                                                  accumulators_per_thread,
                                                  smem_bytes_required)
    if M <= MMA_T_ROWS:
        budget = decode_smem_limit(N, bn, budget, target, blocks=blocks)
    if (smem_bytes_required(bm, bk, bn, 2, w_bytes, m=M) > budget
            or accumulators_per_thread(bm, bn, 2, m=M)
            > target.acc_per_thread):
        return False
    if M <= MMA_T_ROWS:
        return bn in MMA_T_COLS
    return bm < MMA_M or empty_row_share(bm, bn) <= MAX_EMPTY_ROWS


def fused_decode_tile(M: int, N: int, K: int, budget: int,
                      w_bytes: int | None = None,
                      target: HopperTarget = H100_SXM
                      ) -> tuple[int, int, int]:
    """The bf16 fused GEMM's tile at M <= 16 (decode), for its transposed
    instance: bm = M (the block holds every row); bn the widest of
    ``MMA_T_COLS`` whose ``ceil(N / bn)`` blocks reach
    ``DECODE_BLOCKS`` (about one per SM: N = 4096 takes 32, 12800 takes
    64; the narrowest where none does); bk the deepest power of two up to
    512 whose ``MMA_T_STAGES`` steps of W stay within ``DECODE_W_BYTES``
    (bytes in flight: about 1 us of the card's 3.35 TB/s spread over its
    SMs is 25 KB an SM), no deeper than K rounded up to 16, halved while
    the footprint exceeds :func:`decode_smem_limit` (the opt-in where the
    column blocks are one wave: N = 4096's int8 weight then keeps bk
    512, 25 reduction steps, where the two-block budget held it to 256;
    the per-step barriers and widening pass, not the bytes, set its
    pace).  ``"matmul_w8"`` takes the same tile (its bf16 kernels are
    these instances)."""
    from repro_torch.kernels.matmul_fused import MMA_T_COLS
    return _decode_tile(M, K, MMA_T_COLS, lambda bn: -(-N // bn), budget,
                        w_bytes, target)


def _decode_tile(M: int, K: int, cols, n_blocks, budget: int,
                 w_bytes: int | None, target: HopperTarget
                 ) -> tuple[int, int, int]:
    """:func:`fused_decode_tile`'s rule with bn taken from ``cols`` and a
    grid of ``n_blocks(bn)`` column blocks."""
    from repro_torch.kernels.matmul_fused import (DECODE_BLOCKS,
                                                  DECODE_W_BYTES,
                                                  MMA_T_STAGES,
                                                  smem_bytes_required)
    wide = [c for c in cols if n_blocks(c) >= DECODE_BLOCKS]
    bn = max(wide) if wide else min(cols)
    wb = w_bytes or 2
    bk = 512
    while bk > 16 and MMA_T_STAGES * bk * bn * wb > DECODE_W_BYTES:
        bk //= 2
    bk = min(bk, -(-K // 16) * 16)
    limit = decode_smem_limit(None, bn, budget, target,
                              blocks=n_blocks(bn))
    while (bk > 16 and smem_bytes_required(M, bk, bn, 2, w_bytes, m=M)
           > limit):
        bk //= 2
    return M, bk, bn


def _shrink(extent: int, tile: int, mult: int) -> int:
    """The next smaller aligned tile (divisors of ``extent`` first)."""
    return _pick_tile(extent, max(mult, tile // 2), mult)


def _snap_matmul(bm: int, bk: int, bn: int, M: int, N: int, K: int,
                 bytes_per_elem: int, budget: int, target: HopperTarget,
                 w_bytes: int | None = None, dgrad: bool = False,
                 fused: bool = False) -> tuple[int, int, int]:
    """Snap an analytical (bm, bk, bn) to Hopper alignment, the shared
    memory budget and the register limit, shrinking one tile at a time:
    the forward GEMM's footprint and accumulator, with ``dgrad`` the
    dgrad kernels' (:func:`dgrad_fits`), with ``fused`` in bf16 the fused
    GEMM's tensor-core instance (:func:`fused_fits`)."""
    if fused and bytes_per_elem == 2:
        from repro_torch.kernels.matmul_fused import (
            accumulators_per_thread as fused_acc)
        from repro_torch.kernels.matmul_fused import \
            smem_bytes_required as fused_smem

        def acc(bm, bn):
            return fused_acc(bm, bn, 2, m=M)

        def smem(bm, bk, bn):
            return fused_smem(bm, bk, bn, 2, w_bytes, m=M)

        def fits(bm, bk, bn):
            return fused_fits(M, bm, bk, bn, 2, budget, target, w_bytes)
    elif dgrad:
        from repro_torch.kernels.matmul_bwd import (accumulators_per_thread,
                                                    smem_bytes_required)

        def acc(bm, bn):
            return accumulators_per_thread(bm, bn, bytes_per_elem)

        def smem(bm, bk, bn):
            return smem_bytes_required(bm, bk, bn, bytes_per_elem)

        def fits(bm, bk, bn):
            return dgrad_fits(bm, bk, bn, bytes_per_elem, budget, target)
    else:
        from repro_torch.kernels.matmul_blocked import (
            accumulators_per_thread as acc)

        def smem(bm, bk, bn):
            from repro_torch.kernels.matmul_blocked import \
                smem_bytes_required
            return smem_bytes_required(bm, bk, bn, bytes_per_elem, w_bytes)

        def fits(bm, bk, bn):
            return matmul_fits(bm, bk, bn, bytes_per_elem, budget, target,
                               w_bytes)
    mm, mk = target.m_mult, target.nk_mult
    bm = _pick_tile(M, max(bm, mm), mm)
    bn = _pick_tile(N, max(bn, mk), mk)
    bk = _pick_tile(K, max(bk, mk), mk)
    while not fits(bm, bk, bn):
        regs_ok = acc(bm, bn) <= target.acc_per_thread
        smem_over = smem(bm, bk, bn) > budget
        # the staged tiles are bk * (bm + bn): shrink bk first while it
        # is the larger factor; an accumulator over the register limit
        # (or a dgrad warp grid with too many empty rows) can only shrink
        # through bm or bn
        if regs_ok and smem_over and bk > mk and bk * (bm + bn) >= bm * bn:
            bk = _shrink(K, bk, mk)
        elif bm >= bn and bm > mm:
            bm = _shrink(M, bm, mm)
        elif bn > mk:
            bn = _shrink(N, bn, mk)
        elif bm > mm:
            bm = _shrink(M, bm, mm)
        elif bk > mk:
            bk = _shrink(K, bk, mk)
        else:
            break
    return bm, bk, bn


@functools.lru_cache(maxsize=512)
def matmul_tile_candidates(M: int, N: int, K: int, bytes_per_elem: int = 2,
                           smem_budget_bytes: int | None = None,
                           target: HopperTarget = H100_SXM,
                           top: int = 8, w_bytes: int | None = None,
                           dgrad: bool = False, fused: bool = False
                           ) -> tuple[tuple[int, int, int], ...]:
    """Ranked (bm, bk, bn) candidates for C[M,N] = A[M,K] @ B[K,N].

    The optimizer sees a 2-level hierarchy (one block's shared memory,
    HBM above) with alignment candidates in Hopper's multiples; each
    analytical winner is then snapped to that alignment, the shared
    memory budget and the register limit.  Order follows the optimizer's
    energy ranking; the tuner (``repro_torch.tune``) re-ranks by
    predicted DRAM accesses and measurement.  A candidate that fits no
    budget after snapping is dropped by the tuner's filter.
    ``w_bytes``: the B operand's own width (1 for an int8 weight), which
    the model's nest and the kernel's footprint both see.  ``dgrad``:
    snap to the dgrad kernels (:func:`dgrad_fits`) instead of the
    forward GEMM.  ``fused``: the epilogue-fused GEMM's instances
    (:func:`fused_fits`; the same as the forward GEMM's in fp32), and in
    bf16 at M <= 16 the one decode tile of :func:`fused_decode_tile`.
    """
    budget = default_smem_budget(target, smem_budget_bytes)
    from repro_torch.kernels.matmul_fused import MMA_T_ROWS
    if fused and bytes_per_elem == 2 and M <= MMA_T_ROWS:
        return (fused_decode_tile(M, N, K, budget, w_bytes, target),)
    problem = Problem.gemm(M=M, N_cols=N, K_reduce=K,
                           bytes_per_elem=bytes_per_elem,
                           weight_bytes=w_bytes)
    levels = [MemLevel.sram("SMEM", budget), MemLevel.dram("HBM")]
    align = {Dim.X: target.m_mult, Dim.K: target.nk_mult,
             Dim.C: target.nk_mult}
    raw = [(e.X, e.C, e.K)                     # (bm, bk, bn)
           for e in ranked_level0_tiles(problem, levels, align=align,
                                        top=top)]
    raw.append((128, 64, 128))                 # seed: a 128 x 128 tile
    out: list[tuple[int, int, int]] = []
    for bm, bk, bn in raw:
        cand = _snap_matmul(bm, bk, bn, M, N, K, bytes_per_elem, budget,
                            target, w_bytes, dgrad, fused)
        if cand not in out:
            out.append(cand)
    return tuple(out[:top])


def dgrad_fits(bm: int, bk: int, bn: int, bytes_per_elem: int,
               budget: int, target: HopperTarget = H100_SXM) -> bool:
    """Whether the dgrad kernels hold these tiles (roles of the
    cotangent's nest): both kernels' staged operands within ``budget``
    (``matmul_bwd.smem_bytes_required``, the larger of NT's and TN's) and
    their fp32 sums within the register limit
    (``matmul_bwd.accumulators_per_thread``).  In bf16 that is the
    tensor-core instance at its stage count on a warp grid of
    ``matmul_bwd.mma_layout``, which must leave at most
    ``MAX_EMPTY_ROWS`` of its computed rows empty unless the tile is under
    one m16 fragment (an M extent below 16); in fp32 the CUDA-core
    instance, the forward's footprint whenever bk is a multiple of 8."""
    from repro_torch.kernels.matmul_bwd import (MMA_M,
                                                accumulators_per_thread,
                                                empty_row_share,
                                                smem_bytes_required)
    return (smem_bytes_required(bm, bk, bn, bytes_per_elem) <= budget
            and accumulators_per_thread(bm, bn, bytes_per_elem)
            <= target.acc_per_thread
            and (bytes_per_elem != 2 or bm < MMA_M
                 or empty_row_share(bm, bn) <= MAX_EMPTY_ROWS))


def conv_fits(bx: int, by: int, bc: int, bk: int, Fw: int, Fh: int,
              bytes_per_elem: int, budget: int, stride: int = 1,
              target: HopperTarget = H100_SXM, wgrad: bool = False,
              channels: int | None = None) -> bool:
    """Whether the conv kernel holds these tiles: its staged tiles within
    ``budget`` and its fp32 sums within the register limit -- the
    forward's (row 12, which the dgrad runs too:
    ``conv2d_blocked.smem_bytes_required`` and ``accumulators_per_thread``
    of the (bx*by, bk) output tile; ``channels``, the input's C, lets its
    bf16 instance keep one stage where C takes one step) or, with
    ``wgrad``, row 13's (``conv2d_bwd``: the (Fh, Fw, bc, bk) dW tile, in
    bf16 on the tensor-core instance's warp grid).  Imported lazily: the
    kernel modules own their footprints."""
    if wgrad:
        from repro_torch.kernels.conv2d_bwd import (accumulators_per_thread,
                                                    smem_bytes_required)
        acc = accumulators_per_thread(bc, bk, Fh, Fw, bytes_per_elem)
        smem = smem_bytes_required(bx, by, bc, bk, Fh, Fw, bytes_per_elem,
                                   stride)
        return smem <= budget and acc <= target.acc_per_thread
    from repro_torch.kernels.conv2d_blocked import (accumulators_per_thread,
                                                    smem_bytes_required)
    acc = accumulators_per_thread(bx * by, bk, bytes_per_elem)
    smem = smem_bytes_required(bx, by, bc, bk, Fh, Fw, bytes_per_elem,
                               stride, channels)
    return smem <= budget and acc <= target.acc_per_thread


def _snap_conv(bx: int, by: int, bc: int, bk: int, X: int, Y: int, C: int,
               K: int, Fw: int, Fh: int, bytes_per_elem: int, budget: int,
               target: HopperTarget, stride: int,
               wgrad: bool) -> tuple[int, int, int, int]:
    """Snap an analytical (bx, by, bc, bk) to the conv kernel.  The bf16
    forward (row 12 on the tensor cores, also the dgrad's) goes to
    :func:`_snap_conv_mma`, the bf16 wgrad (row 13 on the tensor cores)
    to :func:`_snap_conv_wgrad_mma`.  Otherwise channel tiles start at
    multiples of ``nk_mult`` (extents below it whole), then one tile
    shrinks at a time until the kernel's own footprint fits.  Large
    filters squeeze the weight tile, so bc and bk go below ``nk_mult``,
    down to one 16-byte vector (4 fp32; C = 3 stays whole).

    fp32 forward (row 12's CUDA-core loop): an accumulator (bx*by x bk)
    over the register limit shrinks the larger of the spatial tile and
    bk; shared memory over the budget shrinks bc first (the reduction
    step: it is in both staged tiles and is reused by nothing), then the
    larger of the weight tile (bk per tap) and the haloed input tile
    (with the stride).  fp32 wgrad (row 13's CUDA-core loop): the dW
    accumulator (Fh*Fw*bc*bk) shrinks the larger of bc and bk, shared
    memory the spatial tile."""
    if bytes_per_elem == 2 and not wgrad:
        return _snap_conv_mma(bx, by, bc, bk, X, Y, C, K, Fw, Fh, budget,
                              target, stride)
    if bytes_per_elem == 2:
        return _snap_conv_wgrad_mma(bx, by, bc, bk, X, Y, C, K, Fw, Fh,
                                    budget, target, stride)
    mk = target.nk_mult
    vec = 16 // bytes_per_elem
    bx = _pick_tile(X, bx, 1)
    by = _pick_tile(Y, by, 1)
    bc = _pick_tile(C, max(bc, min(C, mk)), mk if C >= mk else 1)
    bk = _pick_tile(K, max(bk, min(K, mk)), mk if K >= mk else 1)
    while not conv_fits(bx, by, bc, bk, Fw, Fh, bytes_per_elem, budget,
                        stride, target, wgrad):
        can_xy = bx > 1 or by > 1
        ih = (by - 1) * stride + Fh
        iw = (bx - 1) * stride + Fw
        if wgrad:
            from repro_torch.kernels.conv2d_bwd import accumulators_per_thread
            acc_over = (accumulators_per_thread(bc, bk, Fh, Fw,
                                                bytes_per_elem)
                        > target.acc_per_thread)
            if (acc_over or not can_xy) and max(bc, bk) > vec:
                if bk >= bc or bc <= vec:
                    bk = _shrink(K, bk, vec)
                else:
                    bc = _shrink(C, bc, vec)
                continue
            step = "xy" if can_xy else None
        else:
            from repro_torch.kernels.conv2d_blocked import (
                accumulators_per_thread)
            if accumulators_per_thread(bx * by, bk, bytes_per_elem) > \
                    target.acc_per_thread:
                step = "xy" if can_xy and (bx * by >= bk or bk <= vec) \
                    else "k" if bk > vec else None
            elif bc > vec:
                step = "c"
            elif bk > vec and (Fh * Fw * bk >= ih * iw or not can_xy):
                step = "k"
            else:
                step = "xy" if can_xy else None
        if step == "xy":
            if bx >= by and bx > 1:
                bx = _shrink(X, bx, 1)
            else:
                by = _shrink(Y, by, 1)
        elif step == "k":
            bk = _shrink(K, bk, vec)
        elif step == "c":
            bc = _shrink(C, bc, vec)
        else:
            break
    return bx, by, bc, bk


# the bf16 conv and dgrad kernels' M rows (16 x their warps down M x
# their m16 fragments) that may lie past the tile's rows (bx * by pixels)
MAX_EMPTY_ROWS = 1 / 8


def _mma_channels(C: int, bc: int) -> int:
    """bc for the bf16 conv kernel: whole 8-channel chunks (a 16-deep
    k-step is two of them, from one tap or two), divisors of C first; C
    whole below 8."""
    return C if C < 8 else _pick_tile(C, max(bc, 8), 8)


def _mma_cols(K: int, bk: int, least: int = 16) -> int:
    """bk for the bf16 conv kernel: at least ``least`` (K below it whole;
    16 lets an A fragment feed two n8 tiles), whole n8 fragments for
    every warp across N -- a multiple of 8 up to 64 channels (one warp
    across), of 16 up to 128, 32 up to 256, 64 up to 512 -- the largest
    divisor of K that is one, else bk rounded down to one."""
    if K < least:
        return K
    bk = max(least, min(bk, 512, K))
    mult = 8
    while bk > 8 * mult:
        mult *= 2
    divs = [d for d in divisors(K) if d % mult == 0 and least <= d <= bk]
    return max(divs) if divs else bk // mult * mult


@functools.lru_cache(maxsize=8192)
def _mma_rows_ok(pixels: int, bk: int, acc_limit: int) -> bool:
    """Whether the bf16 kernel's warp grid holds a pixels x bk tile within
    the register limit and leaves at most MAX_EMPTY_ROWS of its M rows
    empty."""
    from repro_torch.kernels.conv2d_blocked import (accumulators_per_thread,
                                                    empty_row_share)
    return (accumulators_per_thread(pixels, bk) <= acc_limit
            and empty_row_share(pixels, bk) <= MAX_EMPTY_ROWS)


@functools.lru_cache(maxsize=1024)
def _mma_max_pixels(bk: int, acc_limit: int) -> int:
    """The most pixels the bf16 kernel's warp grid holds at bk within the
    register limit (a multiple of 16; at least 1)."""
    from repro_torch.kernels.conv2d_blocked import (MMA_M,
                                                    accumulators_per_thread)
    p = MMA_M
    while accumulators_per_thread(p + MMA_M, bk) <= acc_limit:
        p += MMA_M
    return p


def _mma_pixels(want: float, X: int, Y: int, bk: int, cap: int, Fw: int,
                Fh: int, stride: int, acc_limit: int) -> tuple[int, int]:
    """The spatial tile of at most ``cap`` pixels for the bf16 kernel: one
    that meets :func:`_mma_rows_ok` if any does, dividing X and Y first,
    then the most pixels, then the smallest haloed input tile, then the
    log aspect (bx / by) nearest ``want``.  Where none meets it (an image
    or a cap under one m16 fragment per warp), the fewest empty rows."""
    from repro_torch.kernels.conv2d_blocked import empty_row_share
    cap = min(cap, _mma_max_pixels(bk, acc_limit))
    y_divs = sorted(divisors(Y), reverse=True)
    best, best_key = (1, 1), None
    for tx in range(1, min(X, cap) + 1):
        top = min(Y, cap // tx)
        tys = {top, next((ty for ty in range(top, 0, -1)
                          if _mma_rows_ok(tx * ty, bk, acc_limit)), top)}
        if X % tx == 0:
            tys.add(next((ty for ty in y_divs if ty <= top and
                          _mma_rows_ok(tx * ty, bk, acc_limit)), top))
        for ty in tys:
            p = tx * ty
            ok = _mma_rows_ok(p, bk, acc_limit)
            halo = ((ty - 1) * stride + Fh) * ((tx - 1) * stride + Fw)
            key = (ok, ok and X % tx == 0 and Y % ty == 0,
                   0.0 if ok else -empty_row_share(p, bk), p, -halo,
                   -abs(math.log(tx / ty) - want))
            if best_key is None or key > best_key:
                best, best_key = (tx, ty), key
    return best


def _snap_conv_mma(bx: int, by: int, bc: int, bk: int, X: int, Y: int,
                   C: int, K: int, Fw: int, Fh: int, budget: int,
                   target: HopperTarget,
                   stride: int) -> tuple[int, int, int, int]:
    """Snap an analytical (bx, by, bc, bk) to row 12's bf16 kernel (the
    tensor cores): bc starts at ``nk_mult`` or more (C below it whole),
    in whole 8-channel chunks, bk at 16 or more (K below it whole: an A
    fragment then feeds two n8 tiles), in whole n8 fragments of the
    warp grid, and bx * by is a tile whose M fragments leave at most
    ``MAX_EMPTY_ROWS`` of their rows empty (a tile under one m16
    fragment per warp grows to it), of the analytical tile's aspect
    where the halo allows.  Then, until the footprint fits: bc
    shrinks first (in both staged tiles, reused by nothing); then bk
    while the weight tile is the larger and bk > 16 (an A fragment then
    feeds two or more n8 tiles); then the pixels while they fill more
    than one fragment per warp; then bk down to 8, then the pixels down
    to one."""
    from repro_torch.kernels.conv2d_blocked import (
        MMA_M, WARPS, pixel_stride, weight_rows, weight_vectors)
    want = math.log(min(bx, X) / min(by, Y))
    bc = _mma_channels(C, max(bc, min(C, target.nk_mult)))
    bk = _mma_cols(K, bk)
    cap = max(min(bx, X) * min(by, Y), MMA_M * WARPS)
    while True:
        bx, by = _mma_pixels(want, X, Y, bk, cap, Fw, Fh, stride,
                             target.acc_per_thread)
        if conv_fits(bx, by, bc, bk, Fw, Fh, 2, budget, stride, target,
                     channels=C):
            return bx, by, bc, bk
        x_tile = (((by - 1) * stride + Fh) * ((bx - 1) * stride + Fw)
                  * pixel_stride(bc, 2))
        w_tile = weight_rows(bc, Fh, Fw) * weight_vectors(bk) * 8
        if bc > 8:
            bc = _shrink(C, bc, 8)
        elif bk > 16 and w_tile >= x_tile:
            bk = _mma_cols(K, bk // 2)
        elif bx * by > MMA_M * WARPS:
            cap = bx * by // 2
        elif bk > 8:
            bk = _mma_cols(K, bk // 2, least=8)
        elif bx * by > 1:
            cap = bx * by // 2
        else:
            return bx, by, bc, bk


# the bf16 wgrad's reduction slots (a pair's bx * by pixels rounded up to
# whole 16-pixel k-steps) that may be padding: zero cotangent rows
MAX_PADDED_PIXELS = 1 / 8
# the fewest pixels the bf16 wgrad's snap gives a pair where the budget
# allows: 16 k-steps over which a pair's staging and barriers are spread
WGRAD_MIN_PIXELS = 256


def _wgrad_dw_tile(bc: int, bk: int, C: int, K: int, Fw: int, Fh: int,
                   acc_limit: int) -> tuple[int, int]:
    """(bc, bk) for row 13's bf16 instance, at most the analytical tile's:
    bc in whole 8-channel chunks (:func:`_mma_channels`), bk in whole n8
    fragments of the warps across N (:func:`_mma_cols`), on a warp grid
    within the register limit.  Of those: a grid that leaves at most
    ``MAX_EMPTY_ROWS`` of its computed rows empty, then bk of 16 or more
    where K allows (an A fragment then feeds two n8 tiles or more), then
    the most dW cells a block holds (each staged pixel meets them all;
    ragged C and K tiles count their mean width), then the fewest
    ``ldmatrix.x4`` per computed fragment, then the narrowest ``bc + bk``
    (the fewest staged channels a pixel).  None fits: one chunk by 8
    columns, which the kernel's check refuses."""
    from repro_torch.kernels.conv2d_bwd import (accumulators_per_thread,
                                                empty_row_share, mma_layout)
    chans = {_mma_channels(C, c) for c in range(8, max(bc, 8) + 1, 8)}
    cols = {_mma_cols(K, k, least) for k in range(8, max(bk, 8) + 1, 8)
            for least in (16, 8)}
    best, best_key = (_mma_channels(C, 8), _mma_cols(K, 8, 8)), None
    for c in sorted(chans):
        for k in sorted(cols):
            if accumulators_per_thread(c, k, Fh, Fw) > acc_limit:
                continue
            _, _, mt, nt = mma_layout(c, k, Fh, Fw)
            cells = C / -(-C // c) * K / -(-K // k)
            key = (empty_row_share(c, k, Fh, Fw) <= MAX_EMPTY_ROWS,
                   k >= min(K, 16), cells,
                   -(mt + (nt + 1) // 2) / (mt * nt), -(c + k))
            if best_key is None or key > best_key:
                best, best_key = (c, k), key
    return best


@functools.lru_cache(maxsize=4096)
def _wgrad_pixels(want: float, X: int, Y: int, bc: int, bk: int, Fw: int,
                  Fh: int, stride: int, budget: int,
                  cap: int) -> tuple[int, int]:
    """The spatial tile (the reduction of a pair) for row 13's bf16
    instance: at most ``cap`` pixels whose staged tiles fit ``budget``;
    of those, one that pads at most ``MAX_PADDED_PIXELS`` of its slots to
    whole 16-pixel k-steps if any does, dividing X and Y first, then the
    most pixels, then the smallest haloed input tile, then the log aspect
    nearest ``want``.  Where none pads so little (an image of a few
    pixels), the least padded."""
    from repro_torch.kernels.conv2d_bwd import (padded_pixel_share,
                                                smem_bytes_required)

    def fits(tx: int, ty: int) -> bool:
        return smem_bytes_required(tx, ty, bc, bk, Fh, Fw, 2,
                                   stride) <= budget

    def pad_ok(p: int) -> bool:
        return padded_pixel_share(p, 1) <= MAX_PADDED_PIXELS

    y_divs = sorted(divisors(Y), reverse=True)
    best, best_key = (1, 1), None
    for tx in range(1, min(X, cap) + 1):
        if not fits(tx, 1):
            break
        lo, hi = 1, min(Y, cap // tx)
        while lo < hi:                  # the most rows that fit
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(tx, mid) else (lo, mid - 1)
        tys = {lo, next((ty for ty in range(lo, 0, -1) if pad_ok(tx * ty)),
                        lo)}
        if X % tx == 0:
            tys.add(next((ty for ty in y_divs
                          if ty <= lo and pad_ok(tx * ty)), lo))
        for ty in tys:
            p = tx * ty
            ok = pad_ok(p)
            halo = ((ty - 1) * stride + Fh) * ((tx - 1) * stride + Fw)
            key = (ok, ok and X % tx == 0 and Y % ty == 0,
                   0.0 if ok else -padded_pixel_share(p, 1), p, -halo,
                   -abs(math.log(tx / ty) - want))
            if best_key is None or key > best_key:
                best, best_key = (tx, ty), key
    return best


def _snap_conv_wgrad_mma(bx: int, by: int, bc: int, bk: int, X: int, Y: int,
                         C: int, K: int, Fw: int, Fh: int, budget: int,
                         target: HopperTarget,
                         stride: int) -> tuple[int, int, int, int]:
    """Snap an analytical (bx, by, bc, bk) to row 13's bf16 instance (the
    tensor cores: M the dW tile's (tap, channel) rows, N its bk columns,
    the reduction the staged pixels).  The dW tile first
    (:func:`_wgrad_dw_tile`, bc up to ``nk_mult`` or the analytical
    tile's if larger, bk up to the analytical tile's): it is held in
    registers, so the register limit and the warp grid decide it, not
    the budget.  Then the pixels
    (:func:`_wgrad_pixels`): the reduction of a pair, any count the
    budget holds up to the analytical tile's or ``WGRAD_MIN_PIXELS``,
    whichever is more, in whole k16 steps or within
    ``MAX_PADDED_PIXELS``, of the analytical tile's aspect where the
    halo allows.  The fp32 wgrad keeps :func:`_snap_conv`'s loop."""
    want = math.log(min(bx, X) / min(by, Y))
    bc, bk = _wgrad_dw_tile(max(bc, min(C, target.nk_mult)), bk, C, K, Fw,
                            Fh, target.acc_per_thread)
    cap = max(min(bx, X) * min(by, Y), WGRAD_MIN_PIXELS)
    bx, by = _wgrad_pixels(want, X, Y, bc, bk, Fw, Fh, stride, budget, cap)
    return bx, by, bc, bk


# orders of the two-level conv nest the search walks: six active dims
# make the full enumeration take seconds per shape on the host
_CONV_MAX_ORDERS = 4


@functools.lru_cache(maxsize=256)
def conv_tile_candidates(X: int, Y: int, C: int, K: int, Fw: int, Fh: int,
                         bytes_per_elem: int = 2,
                         smem_budget_bytes: int | None = None,
                         target: HopperTarget = H100_SXM, top: int = 8,
                         stride: int = 1, wgrad: bool = False
                         ) -> tuple[tuple[int, int, int, int], ...]:
    """Ranked (bx, by, bc, bk) tiles for the direct blocked conv (the
    Hopper counterpart of ``tpu_adapter.conv_tile_candidates``).

    The paper's optimizer runs on the conv nest (output-space X, Y, the
    stride widening the input halo) over a two-level hierarchy (one
    block's shared memory, HBM), channel tiles aligned to one 16-byte
    vector; each winner, and a seed of the whole spatial extent at
    ``nk_mult`` channels (JAX's seed), is snapped (:func:`_snap_conv`) to
    the CUDA kernel's own footprint and accumulator limit: the forward's
    (row 12, also the dgrad's) or, with ``wgrad``, row 13's.  Order
    follows the optimizer's rank; the tuner re-ranks by predicted DRAM
    accesses."""
    budget = default_smem_budget(target, smem_budget_bytes)
    vec = 16 // bytes_per_elem
    problem = Problem(X=X, Y=Y, C=C, K=K, Fw=Fw, Fh=Fh, stride=stride,
                      bytes_per_elem=bytes_per_elem)
    levels = [MemLevel.sram("SMEM", budget), MemLevel.dram("HBM")]
    align = {Dim.K: vec, Dim.C: vec}
    raw = [(e.X, e.Y, e.C, e.K)
           for e in ranked_level0_tiles(problem, levels, align=align,
                                        top=top,
                                        max_orders=_CONV_MAX_ORDERS)]
    raw.append((X, Y, min(C, target.nk_mult), min(K, target.nk_mult)))
    if bytes_per_elem == 2:
        # the tensor cores' seed: the narrowest bk an A fragment serves
        # twice, so that the forward's snap spends the budget on pixels
        # and the wgrad's the register limit on (tap, channel) rows
        raw.append((X, Y, min(C, target.nk_mult), min(K, 16)))
    out: list[tuple[int, int, int, int]] = []
    for bx, by, bc, bk in raw:
        cand = _snap_conv(bx, by, bc, bk, X, Y, C, K, Fw, Fh,
                          bytes_per_elem, budget, target, stride, wgrad)
        if cand not in out:
            out.append(cand)
    return tuple(out[:top])


def conv_tiles(X: int, Y: int, C: int, K: int, Fw: int, Fh: int,
               bytes_per_elem: int = 2,
               smem_budget_bytes: int | None = None,
               target: HopperTarget = H100_SXM, stride: int = 1
               ) -> tuple[int, int, int, int]:
    """Top analytical (bx, by, bc, bk) tile (see conv_tile_candidates)."""
    return conv_tile_candidates(X, Y, C, K, Fw, Fh, bytes_per_elem,
                                smem_budget_bytes, target,
                                stride=stride)[0]


def backward_tile_candidates(op: str, dims: tuple[int, ...],
                             bytes_per_elem: int = 2,
                             smem_budget_bytes: int | None = None,
                             target: HopperTarget = H100_SXM,
                             top: int = 8, stride: int = 1
                             ) -> tuple[tuple[int, ...], ...]:
    """Ranked tiles for the backward nests, reusing the forward searches
    as JAX's ``tpu_adapter.backward_tile_candidates`` does: the paper's
    analysis does not care which operand of the nest is written.

    * ``"matmul_dgrad"``: the GEMM search over the cotangent's
      ``(M_out, N_out, K_reduce)`` (dA: ``(M, K, N)``; dB: ``(K, N,
      M)``), tiles ``(bm, bk, bn)`` in its row, reduction and column
      roles, snapped to the dgrad kernels' footprint (:func:`dgrad_fits`:
      in bf16 the tensor-core instance's stages, sums and warp grid);
    * ``"conv2d_dgrad"``: the transposed conv as a direct conv (channels
      swapped, the stride folded into host-side dilation, so searched at
      stride 1), snapped to row 12's footprint, which it runs;
    * ``"conv2d_wgrad"``: the forward conv's dims at the forward's
      stride, ``(bx, by)`` blocking the spatial reduction, snapped to row
      13's own footprint and accumulator."""
    if op == "matmul_dgrad":
        M, N, K = dims
        return matmul_tile_candidates(M, N, K, bytes_per_elem,
                                      smem_budget_bytes, target, top,
                                      dgrad=True)
    if op not in ("conv2d_dgrad", "conv2d_wgrad"):
        raise ValueError(f"not a backward op: {op!r}")
    X, Y, C, K, Fw, Fh = dims
    wgrad = op == "conv2d_wgrad"
    return conv_tile_candidates(X, Y, C, K, Fw, Fh, bytes_per_elem,
                                smem_budget_bytes, target, top,
                                stride=stride if wgrad else 1, wgrad=wgrad)


def _attn_mma_tile(extent: int, tiles: tuple[int, ...]) -> int:
    """A tile of the tensor-core instances' warp grid (``tiles``: one to
    four m16 tiles, one per warp, or as many k16 steps): the largest that
    divides ``extent``, else the largest within ``extent`` rounded up to
    16 (the ragged edge is masked)."""
    divs = [t for t in tiles if extent % t == 0]
    if divs:
        return max(divs)
    return max([t for t in tiles if t <= -(-extent // 16) * 16] or
               [min(tiles)])


@functools.lru_cache(maxsize=256)
def flash_tiles(seq_q: int, seq_kv: int, head_dim: int,
                bytes_per_elem: int = 2,
                smem_budget_bytes: int | None = None,
                target: HopperTarget = H100_SXM) -> tuple[int, int]:
    """``(block_q, block_kv)`` for flash attention, shared by the forward
    and both backward passes (the counterpart of
    ``tpu_adapter.flash_tiles``).

    In the paper's vocabulary the streamed tile is the kernel buffer,
    reused by every row of the block, and the running sums are the
    output buffer held across the stream: the forward and the dq pass
    own ``block_q`` query rows and stream K/V tiles of ``block_kv``
    keys, the dk/dv pass owns ``block_kv`` keys and streams (q, do)
    tiles of ``block_q`` rows.

    bf16 (the tensor-core instances, ``csrc/attn_mma.cuh``): both tiles
    lie on the mma warp grid (``flash_attention.MMA_TILES``: one m16
    tile per warp, up to four warps; a whole number of k16 steps),
    dividing their extents where one does.  Then, as on the TPU, the
    larger tile halves (``block_kv`` first on a tie) until every pass's
    footprint (``fwd_smem_bytes``, ``dq_smem_bytes``,
    ``dkv_smem_bytes``) fits the budget and its fp32 sums per thread
    (``*_accumulators``) fit ``target.attn_acc_per_thread``.

    fp32 (the CUDA-core instances): each tile starts large (512 query
    rows, 1024 keys, multiples of 32: one row or key per lane) and
    halves until its pass's footprint fits: ``block_q`` the dk/dv
    pass's, ``block_kv`` the dq pass's and the forward's.
    """
    from repro_torch.kernels.flash_attention import (MMA_TILES,
                                                     fwd_accumulators,
                                                     fwd_smem_bytes)
    from repro_torch.kernels.flash_attention_bwd import (dkv_accumulators,
                                                         dkv_smem_bytes,
                                                         dq_accumulators,
                                                         dq_smem_bytes)
    budget = default_smem_budget(target, smem_budget_bytes)
    d, esz = head_dim, bytes_per_elem
    if esz == 2:
        def fits(bq: int, bkv: int) -> bool:
            return (max(fwd_smem_bytes(bq, bkv, d, esz),
                        dq_smem_bytes(bq, bkv, d, esz),
                        dkv_smem_bytes(bq, bkv, d, esz)) <= budget
                    and max(fwd_accumulators(bq, bkv, d),
                            dq_accumulators(bq, bkv, d),
                            dkv_accumulators(bq, bkv, d))
                    <= target.attn_acc_per_thread)
        bq = _attn_mma_tile(seq_q, MMA_TILES)
        bkv = _attn_mma_tile(seq_kv, MMA_TILES)
        while not fits(bq, bkv):
            if bkv >= bq and bkv > min(MMA_TILES):
                bkv //= 2
            elif bq > min(MMA_TILES):
                bq //= 2
            else:
                break
        return bq, bkv
    mult = target.key_mult
    bq = _pick_tile(seq_q, 512, mult)
    bkv = _pick_tile(seq_kv, 1024, mult)
    while dkv_smem_bytes(bq, bkv, d, esz) > budget and bq > mult:
        bq = _shrink(seq_q, bq, mult)
    while (max(dq_smem_bytes(bq, bkv, d, esz),
               fwd_smem_bytes(bq, bkv, d, esz)) > budget and bkv > mult):
        bkv = _shrink(seq_kv, bkv, mult)
    return bq, bkv


def matmul_tiles(M: int, N: int, K: int, bytes_per_elem: int = 2,
                 smem_budget_bytes: int | None = None,
                 target: HopperTarget = H100_SXM) -> tuple[int, int, int]:
    """Top analytical (bm, bk, bn) tile (see matmul_tile_candidates)."""
    return matmul_tile_candidates(M, N, K, bytes_per_elem,
                                  smem_budget_bytes, target)[0]


@functools.lru_cache(maxsize=256)
def flash_decode_tile_candidates(groups: int, seq_kv: int, head_dim: int,
                                 bytes_per_elem: int = 2,
                                 smem_budget_bytes: int | None = None,
                                 target: HopperTarget = H100_SXM,
                                 top: int = 8, kv_bytes: int | None = None,
                                 split_core: bool = True
                                 ) -> tuple[tuple[int], ...]:
    """Ranked ``(page,)`` candidates for the paged flash-decode kernel.

    Decode attention per (batch, kv head) is the skinny GEMM
    ``out[G, D] = softmax(q[G, D] @ K^T[D, S]) @ V[S, D]``: a memory-bound
    nest whose only free blocking choice is how much of the S-long KV
    stream is resident per step.  The optimizer search runs on that nest
    (C = the KV reduction dim); each winner's C extent is snapped to
    multiples of 32 (one key per lane), to the footprint of the kernel
    that runs these widths (``flash_decode.page_smem_bytes``: the bf16
    decode core's ring of whole pages for bf16 q rows, ``attn_rows``'
    two-stage tiles in fp32), and to a divisor of ``seq_kv`` (a
    request's pages then tile ``max_seq`` exactly).  The chosen tile is
    the paged cache's page size.  ``kv_bytes``: the pages' own width (1
    for an fp8 pool, priced by the fp8 kernel's footprint; q rows keep
    ``bytes_per_elem``).  ``split_core=False`` prices ``attn_rows``'
    tiles whatever the widths (row 3's attention runs them).
    """
    from repro_torch.kernels.flash_decode import (ROWS_PER_BLOCK,
                                                  page_smem_bytes,
                                                  smem_bytes_required)

    def footprint(page: int) -> int:
        if split_core:
            return page_smem_bytes(page, head_dim, bytes_per_elem, kv_bytes)
        return smem_bytes_required(page, ROWS_PER_BLOCK, head_dim,
                                   bytes_per_elem, kv_bytes)

    budget = default_smem_budget(target, smem_budget_bytes)
    problem = Problem.gemm(M=groups, N_cols=head_dim, K_reduce=seq_kv,
                           bytes_per_elem=bytes_per_elem,
                           weight_bytes=kv_bytes)
    levels = [MemLevel.sram("SMEM", budget), MemLevel.dram("HBM")]
    align = {Dim.C: target.key_mult}
    raw = [e.C for e in ranked_level0_tiles(problem, levels, align=align,
                                            top=top)]
    raw.append(min(seq_kv, 64))                 # seed: two keys per lane
    mult = target.key_mult if seq_kv >= target.key_mult else 1
    out: list[tuple[int]] = []
    for page in raw:
        page = _pick_tile(seq_kv, max(page, mult), mult)
        while footprint(page) > budget and page > mult:
            page = _shrink(seq_kv, page, mult)
        # one key per lane is a preference: a wide head (D = 256 in fp32)
        # fits the budget only below it
        while footprint(page) > budget and page > 1:
            page = _shrink(seq_kv, page, 1)
        if seq_kv % page:
            page = max(d for d in divisors(seq_kv) if d <= page)
        if (page,) not in out:
            out.append((page,))
    return tuple(out[:top])


# the thinnest k step the fused QKV search falls back to: a whole number
# of 16-byte vectors in fp32 and in bf16
_MIN_BK = 16
_MIN_QKV_BN = 4   # fp32: one 16-byte column group of the GEMM tile core


def qkv_fits(M: int, bm: int, bk: int, bn: int, groups: int,
             bytes_per_elem: int, budget: int,
             target: HopperTarget = H100_SXM, *,
             Nkv: int | None = None) -> bool:
    """Whether the fused QKV kernel's instance for ``M`` rows holds these
    tiles: fp32, the GEMM core's staged tiles and accumulator at the
    joint width (G+2)*bn; bf16, row 9's tensor-core instance at one
    projection's (bm, bk, bn) (:func:`fused_fits`), at decode within
    :func:`decode_smem_limit` of the segment-major grid's blocks
    (``Nkv``)."""
    from repro_torch.kernels.qkv_fused import (accumulators_per_thread,
                                               blocks, smem_bytes_required)
    if bytes_per_elem == 2:
        return fused_fits(M, bm, bk, bn, 2, budget, target,
                          blocks=None if Nkv is None
                          else blocks(Nkv, groups, bn))
    return (smem_bytes_required(bm, bk, bn, groups, bytes_per_elem) <= budget
            and accumulators_per_thread(bm, bn, groups, bytes_per_elem)
            <= target.acc_per_thread)


def qkv_decode_tile(M: int, Nkv: int, K: int, groups: int, budget: int,
                    target: HopperTarget = H100_SXM
                    ) -> tuple[int, int, int]:
    """The bf16 QKV pass's tile at M <= 16, for the transposed instance:
    :func:`fused_decode_tile`'s rule over the segment-major grid's
    ``qkv_fused.blocks`` (the joint (G+2)*Nkv columns), bn of
    ``MMA_T_COLS`` dividing Nkv where one does (granite's decode: bn 32,
    192 blocks, bk 256; the reduced granite's Nkv 32: bn 16)."""
    from repro_torch.kernels.matmul_fused import MMA_T_COLS
    from repro_torch.kernels.qkv_fused import blocks
    cols = [c for c in MMA_T_COLS if Nkv % c == 0] or list(MMA_T_COLS)
    return _decode_tile(M, K, cols, lambda bn: blocks(Nkv, groups, bn),
                        budget, None, target)


@functools.lru_cache(maxsize=256)
def qkv_fused_tile_candidates(M: int, Nkv: int, K: int, groups: int,
                              bytes_per_elem: int = 2,
                              smem_budget_bytes: int | None = None,
                              target: HopperTarget = H100_SXM,
                              top: int = 8) -> tuple[tuple[int, int, int],
                                                     ...]:
    """Ranked (bm, bk, bn) candidates for the fused QKV pass, bn blocking
    the per-projection width Nkv.

    bf16 (row 9's tensor-core instances over the segment-major grid,
    where a block is a (bm, bn) tile of one projection): at M <= 16 the
    one decode tile of :func:`qkv_decode_tile`; above, the search's
    candidates for the joint GEMM ``(M, (G+2)*Nkv, K)`` under the fused
    GEMM's footprint (``matmul_tile_candidates(fused=True)``), each
    snapped to Nkv (a divisor where an aligned one fits) and again to the
    ``"mma"`` instance (:func:`fused_fits`).

    fp32 (the tile core over the joint tile): the search runs on the
    joint GEMM (one activation stream feeding every output column).
    Each winner's bn is then expressed per projection, ``bn_joint //
    (G+2)`` snapped to a divisor of Nkv in multiples of ``nk_mult`` (the
    TPU adapter snapped to its lane width), and the tile shrinks -- bk
    while the staged tiles overflow, then bm, then bn, then bk below
    ``nk_mult`` down to ``_MIN_BK`` -- until the joint (bm, (G+2)*bn)
    tile fits the GEMM core's shared memory and accumulator cap: at G = 4
    the cap allows bn <= 128, and only with bm <= 16; at granite's widths
    no tile with bk >= 64 fits the two-block budget.  Where the joint
    width alone overflows the cap (more than 1,024 columns: G + 2 > 16
    at bn 64), bn goes below ``nk_mult``, to a divisor of Nkv in
    multiples of 4 (one 16-byte fp32 column group): glm4-9b's G 16 takes
    bn 32 (576 columns), granite-34b's G 48 bn 16 (800).  A seed tile
    (JAX's) joins the search's list.
    """
    from repro_torch.kernels.matmul_fused import MMA_T_ROWS
    from repro_torch.kernels.qkv_fused import (accumulators_per_thread,
                                               joint_cols,
                                               smem_bytes_required)
    budget = default_smem_budget(target, smem_budget_bytes)
    mm, mk = target.m_mult, target.nk_mult
    if bytes_per_elem == 2:
        if M <= MMA_T_ROWS:
            return (qkv_decode_tile(M, Nkv, K, groups, budget, target),)
        out = []
        for bm, bk, bn in matmul_tile_candidates(
                M, joint_cols(Nkv, groups), K, 2, budget, target, top=top,
                fused=True):
            cand = _snap_matmul(bm, bk, bn, M, Nkv, K, 2, budget, target,
                                fused=True)
            if cand not in out:
                out.append(cand)
        return tuple(out[:top])
    joint = matmul_tile_candidates(M, joint_cols(Nkv, groups), K,
                                   bytes_per_elem, budget, target, top=top)
    seed = (min(M, 256), min(K, 512), joint_cols(min(Nkv, 128), groups))
    out: list[tuple[int, int, int]] = []
    for bm, bk, bn_joint in (*joint, seed):
        bn = _pick_tile(Nkv, max(bn_joint // (groups + 2), mk), mk)
        while not qkv_fits(M, bm, bk, bn, groups, bytes_per_elem, budget,
                           target):
            regs_ok = (accumulators_per_thread(bm, bn, groups,
                                               bytes_per_elem)
                       <= target.acc_per_thread)
            smem_over = smem_bytes_required(bm, bk, bn, groups,
                                            bytes_per_elem) > budget
            if regs_ok and smem_over and bk > mk:
                bk = _shrink(K, bk, mk)
            elif bm > mm:
                bm = _shrink(M, bm, mm)
            elif bn > mk:
                bn = _shrink(Nkv, bn, mk)
            elif not regs_ok and bn > _MIN_QKV_BN:
                bn = _shrink(Nkv, bn, _MIN_QKV_BN)
            elif bk > mk:
                bk = _shrink(K, bk, mk)
            elif bk > _MIN_BK:
                bk = _shrink(K, bk, _MIN_BK)
            else:
                break
        if (bm, bk, bn) not in out:
            out.append((bm, bk, bn))
    return tuple(out[:top])


@functools.lru_cache(maxsize=256)
def flash_decode_oproj_tile_candidates(groups: int, seq_kv: int,
                                       head_dim: int, d_model: int,
                                       bytes_per_elem: int = 2,
                                       smem_budget_bytes: int | None = None,
                                       target: HopperTarget = H100_SXM,
                                       top: int = 8) -> tuple[tuple[int],
                                                              ...]:
    """Ranked ``(page,)`` candidates for the oproj-fused decode kernel:
    the ``flash_decode`` family over ``attn_rows``' tiles (the attention
    core row 3 runs), searched under the budget less what this
    kernel adds to a block's shared memory (the G x D fp32 attention
    rows of a group of 16 batch rows, one split's rows, its statistics
    and the merge weights; ``oproj_smem_bytes_required``).  ``wo`` is
    streamed through a fixed ring that overlays the page's tiles, so E
    does not enter."""
    del d_model
    from repro_torch.kernels.flash_decode import (OPROJ_STEP_BYTES,
                                                  OPROJ_WO_STAGES,
                                                  oproj_smem_bytes_required)
    budget = default_smem_budget(target, smem_budget_bytes)
    # at page 0 the ring is the larger of the overlaid pair
    extra = (oproj_smem_bytes_required(0, groups, head_dim, bytes_per_elem)
             - OPROJ_WO_STAGES * OPROJ_STEP_BYTES)
    return flash_decode_tile_candidates(groups, seq_kv, head_dim,
                                        bytes_per_elem,
                                        max(budget - extra, 1), target, top,
                                        split_core=False)


def layer_sharding_advice(weight_bytes: int, activation_bytes: int) -> str:
    """Paper §3.3 / §5.3 rule at mesh scale: shard (partition) the LARGE
    operand so the small one is the broadcast; sharing the large buffer
    makes its broadcast free.  ``"model"`` shards the weights across the
    cards (tensor parallel), ``"data"`` the activations."""
    return "model" if weight_bytes >= activation_bytes else "data"
