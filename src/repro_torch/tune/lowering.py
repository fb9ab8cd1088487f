"""Lowering from the analytical blocking model to the port's kernel
schedules (the port of ``repro.tune.lowering``: ``"matmul"``,
``"matmul_dgrad"``, ``"flash_decode"``, the fused and quantized paths'
keys and the conv path's).  ``"matmul_dgrad"`` is the GEMM nest over the
cotangent's dims (``backward_tile_candidates``), ranked by element
counts as JAX ranks it, its tiles held to the dgrad kernels' own
footprint.  The conv keys (``CONV_OPS``) are the paper's own nest:
``"conv2d"`` and ``"conv2d_dgrad"`` held to row 12's footprint (the dgrad
runs the forward kernel at stride 1), ``"conv2d_wgrad"`` to row 13's.

1. :func:`candidates` runs the paper's schedule search for the op's loop
   nest on the Hopper hierarchy (``core.hopper_adapter``), keeps what the
   CUDA kernel holds on chip (:func:`fits_smem`) and ranks tiles that
   divide the problem by the model's predicted DRAM accesses;
2. :func:`schedule_to_string` maps a concrete tile tuple back onto the
   blocking string the kernel executes, so
3. :func:`predicted_dram_accesses` can score any candidate with the exact
   per-level access counts of paper section 3.4.

The fused keys (``FUSED_OPS``) rank by :func:`predicted_dram_bytes`, the
same walk weighted by each operand's width, as the reference does:
bytes, not element counts, are what fusion removes.  The quantized keys
(``NARROW_WEIGHT_BYTES``: ``"matmul_w8"``, ``"matmul_fused_w8"``,
``"flash_decode_fp8"``) rank
the same way, their one-byte operand weighted at its width (the
reference ranks them by element counts over its width-aware buffers):
what quantization removes is bytes too.

:func:`schedule_to_string`, :func:`predicted_dram_accesses`,
:func:`predicted_dram_bytes` and :func:`level0_dram_bytes` are the
model's arithmetic and have no target; they are the reference's,
restricted to the port's keys.
"""

from __future__ import annotations

from repro_torch.core.hierarchy import MemLevel, cache_accesses
from repro_torch.core.hopper_adapter import (
    H100_SXM, HopperTarget, backward_tile_candidates, conv_fits,
    conv_tile_candidates, default_smem_budget, dgrad_fits,
    flash_decode_oproj_tile_candidates, flash_decode_tile_candidates,
    fused_fits, matmul_fits, matmul_tile_candidates, qkv_fits,
    qkv_fused_tile_candidates)
from repro_torch.core.loopnest import BlockingString, Dim, Loop
from repro_torch.tune.schedule import (CONV_OPS, FUSED_OPS, GEMM_OPS,
                                       MMA_GEMM_OPS, NARROW_WEIGHT_BYTES,
                                       OpSpec, Schedule)

_GEMMS = GEMM_OPS
_PAGES = ("flash_decode", "flash_decode_oproj",
          "flash_decode_fp8")                     # tile = the page
_BY_BYTES = FUSED_OPS + tuple(NARROW_WEIGHT_BYTES)


def fits_smem(spec: OpSpec, tiles: tuple[int, ...], budget: int,
              target: HopperTarget = H100_SXM) -> bool:
    """Whether the op's CUDA kernel holds these tiles on chip: its own
    shared-memory footprint within ``budget`` and, for the GEMM, its
    fp32 accumulator within the target's register limit: the keys of
    ``MMA_GEMM_OPS`` (``"matmul_w8"`` among them) under the fused GEMM's
    instance for the spec's M, the fused QKV kernel's (in fp32 at its
    joint width; in bf16 the same instances at one projection's tile
    over its segment-major grid).  The quantized keys price their
    narrow operand at one byte (the int8 weight tile, the fp8 pages of
    ``flash_decode.smem_bytes_required``), and an int8 weight tile's bn
    must be a whole number of 16-byte copies.  A decode page is priced
    by the instance that runs (``flash_decode.page_smem_bytes``).  The conv
    keys: row 12's footprint and accumulator (``"conv2d"``, and
    ``"conv2d_dgrad"``, which runs it), row 13's for ``"conv2d_wgrad"``,
    each with the spec's stride."""
    if spec.op in CONV_OPS:
        bx, by, bc, bk = tiles
        _, _, C, _, Fw, Fh = spec.dims
        return conv_fits(bx, by, bc, bk, Fw, Fh, spec.itemsize, budget,
                         spec.stride, target,
                         wgrad=spec.op == "conv2d_wgrad", channels=C)
    if spec.op == "matmul_dgrad":
        bm, bk, bn = tiles
        return dgrad_fits(bm, bk, bn, spec.itemsize, budget, target)
    if spec.op in MMA_GEMM_OPS:
        bm, bk, bn = tiles
        return fused_fits(spec.dims[0], bm, bk, bn, spec.itemsize, budget,
                          target, NARROW_WEIGHT_BYTES.get(spec.op),
                          N=spec.dims[1])
    if spec.op in _GEMMS:
        bm, bk, bn = tiles
        return matmul_fits(bm, bk, bn, spec.itemsize, budget, target,
                           w_bytes=NARROW_WEIGHT_BYTES.get(spec.op))
    if spec.op == "qkv_fused":
        bm, bk, bn = tiles
        return qkv_fits(spec.dims[0], bm, bk, bn, spec.dims[3],
                        spec.itemsize, budget, target, Nkv=spec.dims[1])
    from repro_torch.kernels.flash_decode import (oproj_smem_bytes_required,
                                                  page_smem_bytes)
    (page,) = tiles
    if spec.op == "flash_decode_oproj":
        G, _, D, _ = spec.dims
        return oproj_smem_bytes_required(page, G, D, spec.itemsize) <= budget
    _, _, D = spec.dims
    return page_smem_bytes(page, D, spec.itemsize,
                           NARROW_WEIGHT_BYTES.get(spec.op)) <= budget


def divides(spec: OpSpec, tiles: tuple[int, ...]) -> bool:
    """True iff the tiles cover the problem in whole blocks (the model
    can score them; the kernels also run ragged tiles, masked)."""
    if spec.op in _GEMMS:
        M, N, K = spec.dims
        bm, bk, bn = tiles
        return M % bm == 0 and K % bk == 0 and N % bn == 0
    if spec.op == "qkv_fused":
        M, Nkv, K, _ = spec.dims
        bm, bk, bn = tiles
        return M % bm == 0 and K % bk == 0 and Nkv % bn == 0
    if spec.op in CONV_OPS:
        X, Y, C, K, _, _ = spec.dims
        bx, by, bc, bk = tiles
        return C % bc == 0 and K % bk == 0 and X % bx == 0 and Y % by == 0
    S = spec.dims[1]
    (page,) = tiles
    return S % page == 0


def schedule_to_string(spec: OpSpec,
                       tiles: tuple[int, ...]) -> BlockingString:
    """The blocking string the kernels execute for these tiles (inner ->
    outer).

    * matmul, matmul_fused: the level-0 (bk, bm, bn) block, then the grid
      (m, n, k) with k minor-most (the fp32 accumulator is the OB held
      across C);
    * qkv_fused: the same GEMM string over the joint width, one block
      touching (G+2)*bn columns from a single A tile;
    * flash_decode, flash_decode_oproj: one query block (all G rows, all
      D columns) resident while the kernel streams KV pages -- the
      running (m, l, acc) state is the OB held across the whole C (KV)
      reduction.  The fused projection's wo traffic does not depend on
      the page, so it cannot change the rank and is absent here;
    * conv2d, conv2d_dgrad: the Fw/Fh window loops inside the block, the
      (bx, by, bc, bk) block, then C inside K (the accumulator held
      across the reduction: the block's own loop), then the spatial
      tiles (X inside Y), as JAX's string;
    * conv2d_wgrad: the spatial tile is the innermost reduction (one
      (bx, by) tile reduces into the resident dW block per tap), then
      the channel blocks, the (k, c) tiles, and the spatial reduction
      tiles outermost.
    """
    p = spec.problem()
    if spec.op in CONV_OPS:
        X, Y, C, K, Fw, Fh = spec.dims
        bx, by, bc, bk = tiles
        window = [Loop(d, e) for d, e in ((Dim.FW, Fw), (Dim.FH, Fh))
                  if e > 1]
        space = [Loop(Dim.X, bx), Loop(Dim.Y, by)]
        loops = (space + window if spec.op == "conv2d_wgrad"
                 else window + space)
        loops += [Loop(Dim.C, bc), Loop(Dim.K, bk), Loop(Dim.C, C),
                  Loop(Dim.K, K), Loop(Dim.X, X), Loop(Dim.Y, Y)]
    elif spec.op in _GEMMS:
        M, N, K = spec.dims
        bm, bk, bn = tiles
        loops = [Loop(Dim.C, bk), Loop(Dim.X, bm), Loop(Dim.K, bn),
                 Loop(Dim.C, K), Loop(Dim.K, N), Loop(Dim.X, M)]
    elif spec.op == "qkv_fused":
        M, Nkv, K, G = spec.dims
        bm, bk, bn = tiles
        loops = [Loop(Dim.C, bk), Loop(Dim.X, bm),
                 Loop(Dim.K, (G + 2) * bn),
                 Loop(Dim.C, K), Loop(Dim.K, (G + 2) * Nkv), Loop(Dim.X, M)]
    else:
        G, S, D = spec.dims[:3]
        (page,) = tiles
        loops = [Loop(Dim.C, page), Loop(Dim.X, G), Loop(Dim.K, D),
                 Loop(Dim.C, S)]
    return BlockingString(loops, p)


def predicted_dram_accesses(spec: OpSpec, tiles: tuple[int, ...],
                            smem_budget_bytes: int | None = None,
                            target: HopperTarget = H100_SXM) -> int:
    """HBM-boundary accesses (elements) of this schedule under the paper's
    access model with a shared-memory-sized on-chip level (working sets
    that overflow the budget spill, as in the Fig. 3/4 methodology)."""
    if not divides(spec, tiles):
        raise ValueError(
            f"tiles {tiles} do not divide {spec.op} dims {spec.dims}; "
            "the blocking model cannot score a ragged schedule")
    budget = default_smem_budget(target, smem_budget_bytes)
    levels = [MemLevel.sram("SMEM", budget), MemLevel.dram("HBM")]
    s = schedule_to_string(spec, tiles)
    return cache_accesses(s, levels)[levels[-1].name]


def predicted_dram_bytes(spec: OpSpec, tiles: tuple[int, ...],
                         smem_budget_bytes: int | None = None,
                         target: HopperTarget = H100_SXM) -> int:
    """HBM-boundary traffic in bytes: :func:`predicted_dram_accesses`'s
    walk with each operand's accesses weighted by its own width
    (``core.buffers.operand_bytes``), so the two ranks cannot disagree
    about the miss-path rules."""
    if not divides(spec, tiles):
        raise ValueError(
            f"tiles {tiles} do not divide {spec.op} dims {spec.dims}")
    from repro_torch.core.buffers import Operand, operand_bytes
    budget = default_smem_budget(target, smem_budget_bytes)
    levels = [MemLevel.sram("SMEM", budget), MemLevel.dram("HBM")]
    s = schedule_to_string(spec, tiles)
    weights = {op: operand_bytes(s.problem, op) for op in Operand}
    return cache_accesses(s, levels,
                          operand_weights=weights)[levels[-1].name]


def _operand_level0_traffic(s: BlockingString, op, footprint: int) -> int:
    """Parent-side traffic (elements) of the outermost model buffer that
    fits the kernel's level-0 tile footprint for this operand (including
    the degenerate pos=-1 register when no placed buffer fits: a streamed
    operand with no reuse pays the full compulsory stream)."""
    from repro_torch.core.access import analyze
    from repro_torch.core.buffers import buffers_by_operand, place_buffers
    rep = analyze(s)
    chain = buffers_by_operand(place_buffers(s))[op]     # inner -> outer
    fitting = [b for b in chain if b.size_elems <= footprint]
    pick = fitting[-1]
    for bt in rep.per_buffer:
        if bt.buffer.name == pick.name and bt.buffer.operand is op:
            return bt.parent_traffic
    raise KeyError(pick.name)


def _level0_footprints(s: BlockingString) -> dict:
    """Level-0 tile footprint (elements) per operand, read off the
    innermost extent of each dim in the blocking string."""
    from repro_torch.core.buffers import OPERAND_DIMS, Operand
    inner: dict[Dim, int] = {}
    for loop in s.loops:
        inner.setdefault(loop.dim, loop.extent)
    out = {}
    for op in Operand:
        fp = 1
        for d in OPERAND_DIMS[op]:
            fp *= inner.get(d, 1)
        out[op] = fp
    return out


def level0_dram_bytes(spec: OpSpec, tiles: tuple[int, ...]) -> int:
    """The blocking model's level-0 HBM traffic (bytes) for the nest(s)
    the kernel executes with ``tiles``, with no finite on-chip packing:
    per operand, the parent traffic of the outermost placed buffer that
    fits the kernel's level-0 block."""
    from repro_torch.core.buffers import Operand, operand_bytes
    if not divides(spec, tiles):
        raise ValueError(
            f"tiles {tiles} do not divide {spec.op} dims {spec.dims}")
    if spec.op in ("flash_decode", "flash_decode_fp8"):
        return _flash_decode_level0_bytes(spec, tiles)
    if spec.op == "flash_decode_oproj" or spec.op in CONV_OPS:
        raise ValueError(
            "level0_dram_bytes covers the GEMM family and flash_decode, "
            f"not {spec.op!r} (the conv kernels count their halo "
            "refetches in their own hbm_bytes)")
    s = schedule_to_string(spec, tiles)
    fps = _level0_footprints(s)
    return sum(_operand_level0_traffic(s, op, fps[op])
               * operand_bytes(s.problem, op) for op in Operand)


def _flash_decode_level0_bytes(spec: OpSpec, tiles: tuple[int, ...]) -> int:
    """Two-nest decomposition of the decode-attention kernel: ``scores =
    q @ K^T`` (count q and K; the score output is an on-chip
    intermediate) and ``out = P @ V`` (count V and the output; P is the
    same intermediate), sharing the KV block loop.  Per (batch, kv-head)
    row; block tables and lengths are excluded.  An fp8 cache streams its
    K/V at one byte and adds its two per-head fp32 scales."""
    from repro_torch.core.buffers import Operand, operand_bytes
    from repro_torch.core.loopnest import Problem
    G, S, D = spec.dims
    (page,) = tiles
    kvb = NARROW_WEIGHT_BYTES.get(spec.op)
    p1 = Problem.gemm(M=G, N_cols=S, K_reduce=D,
                      bytes_per_elem=spec.itemsize, weight_bytes=kvb)
    s1 = BlockingString([Loop(Dim.C, D), Loop(Dim.X, G), Loop(Dim.K, page),
                         Loop(Dim.C, D), Loop(Dim.K, S), Loop(Dim.X, G)],
                        p1)
    p2 = Problem.gemm(M=G, N_cols=D, K_reduce=S,
                      bytes_per_elem=spec.itemsize, weight_bytes=kvb)
    s2 = BlockingString([Loop(Dim.C, page), Loop(Dim.X, G), Loop(Dim.K, D),
                         Loop(Dim.C, S), Loop(Dim.K, D), Loop(Dim.X, G)],
                        p2)
    total = 0
    for s, counted in ((s1, (Operand.INPUT, Operand.WEIGHT)),
                       (s2, (Operand.WEIGHT, Operand.OUTPUT))):
        fps = _level0_footprints(s)
        for op in counted:
            total += _operand_level0_traffic(s, op, fps[op]) \
                * operand_bytes(s.problem, op)
    if spec.op == "flash_decode_fp8":
        total += 2 * 4        # the per-head dequant scales, one row
    return total


def candidates(spec: OpSpec,
               smem_budget_bytes: int | None = None,
               target: HopperTarget = H100_SXM,
               top: int = 8) -> list[Schedule]:
    """Analytically-ranked kernel schedules for one op instance.

    Always returns at least one schedule.  When no fitting candidate
    divides the problem, the top fitting one is returned unscored
    (``predicted_dram_accesses`` unset): the kernel runs it with its
    ragged edges masked.
    """
    budget = default_smem_budget(target, smem_budget_bytes)
    if spec.op == "conv2d":
        X, Y, C, K, Fw, Fh = spec.dims
        raw = conv_tile_candidates(X, Y, C, K, Fw, Fh, spec.itemsize,
                                   budget, target, top=top,
                                   stride=spec.stride)
    elif spec.op in ("matmul_dgrad", "conv2d_dgrad", "conv2d_wgrad"):
        raw = backward_tile_candidates(spec.op, spec.dims, spec.itemsize,
                                       budget, target, top=top,
                                       stride=spec.stride)
    elif spec.op in _GEMMS:
        M, N, K = spec.dims
        raw = matmul_tile_candidates(
            M, N, K, spec.itemsize, budget, target, top=top,
            w_bytes=NARROW_WEIGHT_BYTES.get(spec.op),
            fused=spec.op in MMA_GEMM_OPS)
    elif spec.op == "qkv_fused":
        M, Nkv, K, G = spec.dims
        raw = qkv_fused_tile_candidates(M, Nkv, K, G, spec.itemsize, budget,
                                        target, top=top)
    elif spec.op == "flash_decode_oproj":
        G, S, D, E = spec.dims
        raw = flash_decode_oproj_tile_candidates(G, S, D, E, spec.itemsize,
                                                 budget, target, top=top)
    else:
        G, S, D = spec.dims
        raw = flash_decode_tile_candidates(
            G, S, D, spec.itemsize, budget, target, top=top,
            kv_bytes=NARROW_WEIGHT_BYTES.get(spec.op))
    fitting = [t for t in raw if fits_smem(spec, t, budget, target)]
    if not fitting:
        raise ValueError(
            f"no {spec.op} tile for dims {spec.dims} fits a shared-memory "
            f"budget of {budget} bytes on {target.name}")
    usable = [t for t in fitting if divides(spec, t)]
    if not usable:
        return [Schedule(spec, fitting[0], source="analytic")]
    scored = [Schedule(spec, t, source="analytic",
                       predicted_dram_accesses=predicted_dram_accesses(
                           spec, t, budget, target))
              for t in usable]

    # fewest predicted DRAM accesses first (bytes for the fused keys, as
    # in the reference, and for the quantized ones); break ties toward
    # bigger blocks (fewer grid
    # steps) -- except for the paged kernels, where the KV stream touches
    # every element once at any page size (the model ties) and the tile
    # doubles as the paged cache's allocation granule: smaller pages
    # waste fewer slots per request.
    def tile_product(s: Schedule) -> int:
        prod = 1
        for t in s.tiles:
            prod *= t
        return prod
    sign = 1 if spec.op in _PAGES else -1
    if spec.op in _BY_BYTES:
        scored.sort(key=lambda s: (predicted_dram_bytes(
            spec, s.tiles, budget, target), sign * tile_product(s)))
    else:
        scored.sort(key=lambda s: (s.predicted_dram_accesses,
                                   sign * tile_product(s)))
    return scored[:top]
