"""Direct blocked convolution (kernel row 12): the CUDA kernel's wrapper,
its level-1 driver and its plain version.

Port of ``repro.kernels.conv2d_blocked``.  The paper's two-level
blocking of a direct convolution, NHWC x HWIO -> NHWC, VALID padding,
any stride:

* level 1: spatial tiles of ``bx`` x ``by`` outputs with their input
  halo (the paper's outer ``X1/Y1`` loops);
* level 0: channel tiles ``bc`` and kernel tiles ``bk`` staged in shared
  memory, the fp32 accumulator held across the whole C reduction, the
  Fh x Fw window run over the staged input (the sliding-window reuse of
  paper section 4.2).

In JAX the level-1 tiles are host slices concatenated after the Pallas
call, and the batch is vmapped.  Here one launch covers the whole
``(N, H, W, C)`` batch: the grid is (spatial tile, K tile, image), each
block finds its halo from ``blockIdx`` and the stride, and the C
reduction is a loop inside the block (``csrc/conv2d_blocked.cu``; design
and bound in its header comment).  bf16 multiplies on the tensor cores,
an implicit GEMM over the staged tiles (``mma.sync``); fp32 keeps the
CUDA-core loop (TF32 would break the fp32 tolerances).  Ragged C, K and
spatial edges are masked in the kernel, so every shape launches (JAX
sends ragged channel tiles to its oracle and collapses ragged space to
one tile).  Output in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

THREADS = 256             # threads a block (csrc: conv::kThreads)
STAGES = 2                # C tiles in flight: the current one and the next
# fp32, the CUDA-core loop
COLS_PER_THREAD = 4       # K columns a thread holds (csrc: conv::kCols)
MAX_ROWS_PER_THREAD = 16  # output pixels a thread holds: 64 fp32 sums
# bf16, the tensor cores (mma.sync m16n8k16)
WARPS = THREADS // 32
MMA_M, MMA_N = 16, 8      # one fragment: 16 pixels x 8 output channels
CHUNK = 8                 # reduction chunk: 8 channels of one tap
K_STEP = 16               # reduction depth of one mma: two chunks
MAX_FRAGMENTS = 16        # fragments a warp holds: 64 fp32 sums a thread
MAX_N_TILES = 8           # n8 fragments a warp holds

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def pixel_stride(bc: int, itemsize: int) -> int:
    """Elements between two staged pixels of the input tile: ``bc``
    rounded up to whole 16-byte vectors, an odd number of them, so that
    reads of neighbouring pixels fall into different bank groups (csrc:
    ``conv::pixel_stride``)."""
    vec = 16 // itemsize
    chunks = _ceil(bc, vec)
    return (chunks + (chunks % 2 == 0)) * vec


def mma_layout(pixels: int, bk: int) -> tuple[int, int, int, int] | None:
    """The bf16 kernel's warp grid for a ``pixels`` x ``bk`` output tile:
    ``(wm, wn, mt, nt)``, ``wn`` warps across the channels and ``wm =
    8 // wn`` down the pixels, each holding ``mt`` m16 x ``nt`` n8
    fragments: the fewest warps across N (so each A fragment feeds the
    most n8 tiles) with ``nt <= 8`` whose fragments fit (``mt * nt <=
    16``), else the fewest with ``nt <= 8`` (then the tile needs more
    sums than a thread holds).  None past 512 channels.  csrc:
    ``mma_layout`` in ``conv2d_blocked.cu``."""
    mt_all, nt_all = _ceil(pixels, MMA_M), _ceil(bk, MMA_N)
    grids = [(WARPS // wn, wn, _ceil(mt_all, WARPS // wn), _ceil(nt_all, wn))
             for wn in (1, 2, 4, 8)]
    grids = [g for g in grids if g[3] <= MAX_N_TILES]
    fits = [g for g in grids if g[2] * g[3] <= MAX_FRAGMENTS]
    return (fits or grids or [None])[0]


def empty_row_share(pixels: int, bk: int) -> float:
    """Share of the bf16 kernel's M rows (``16 wm mt``, the pixels its
    warps compute) that lie past the ``pixels`` of the tile: computed and
    never stored (1 past 512 channels, where no grid holds the tile)."""
    layout = mma_layout(pixels, bk)
    if layout is None:
        return 1.0
    wm, _, mt, _ = layout
    return 1 - pixels / (MMA_M * wm * mt)


def weight_rows(bc: int, fh: int, fw: int) -> int:
    """Rows of the bf16 weight tile: ``fh * fw`` taps of ``bc`` channels
    rounded up to 8-channel chunks, the chunks rounded up to whole
    16-deep k-steps (the pad rows are zero)."""
    return _ceil(fh * fw * _ceil(bc, CHUNK) * CHUNK, K_STEP) * K_STEP


def weight_vectors(bk: int) -> int:
    """16-byte vectors between two rows of the bf16 weight tile: the 8
    rows of one ``ldmatrix`` sub-matrix must fall into distinct bank
    groups, so a power of two (2 or more) is XOR-swizzled, unpadded, an
    odd count needs nothing, and any other count is padded by one vector
    to odd (csrc: ``weight_vectors``)."""
    v = _ceil(bk, 8)
    return v if v % 2 or v & (v - 1) == 0 else v + 1


def staged_vector(v: int, L: int) -> int:
    """Where logical 16-byte vector ``L`` (row ``L // v``, column ``L %
    v``) of a staged tile of :func:`weight_vectors` ``v`` a row sits: a
    power of two ``v >= 8`` XORs the column with the row's low three
    bits, ``v = 2`` and ``4`` with the row's 128-byte line, any other
    ``v`` is as it is (csrc: ``conv::row_swizzle``; row 12's weight tile,
    row 13's cotangent tile)."""
    if v < 2 or v & (v - 1):
        return L
    return L ^ ((L >> max(3, v.bit_length() - 1)) & 7)


def smem_bytes_required(bx: int, by: int, bc: int, bk: int, fh: int,
                        fw: int, itemsize: int = 2, stride: int = 1,
                        channels: int | None = None) -> int:
    """Dynamic shared memory of one block, two stages deep (in bf16 one
    where ``channels``, the input's C, takes one step of bc): the haloed
    input tile (``(by-1)*stride+fh`` x ``(bx-1)*stride+fw`` pixels of
    :func:`pixel_stride` elements) and the weight tile.  bf16 (the
    tensor cores): :func:`weight_rows` rows of :func:`weight_vectors`
    16-byte vectors, then one 4-byte offset per 8-channel chunk (the
    table the A fragments are addressed from).  fp32 (the CUDA cores): ``fh*fw``
    taps of ``bc`` channels rounded up to 4, each a row of ``bk`` rounded
    up to a 16-byte vector.  The fp32 sums are in registers
    (:func:`accumulators_per_thread`)."""
    vec = 16 // itemsize
    ih = (by - 1) * stride + fh
    iw = (bx - 1) * stride + fw
    x_tile = ih * iw * pixel_stride(bc, itemsize)
    if itemsize == 2:
        rows = weight_rows(bc, fh, fw)
        w_tile = rows * weight_vectors(bk) * vec
        stages = 1 if channels is not None and channels <= bc else STAGES
        return stages * (x_tile + w_tile) * itemsize + rows // CHUNK * 4
    w_tile = fh * fw * _ceil(bc, 4) * 4 * _ceil(bk, vec) * vec
    return STAGES * (x_tile + w_tile) * itemsize


def accumulators_per_thread(pixels: int, bk: int, itemsize: int = 2) -> int:
    """fp32 sums each thread holds for an output tile of ``pixels``
    (``bx * by``) positions by ``bk`` channels.  bf16: four per fragment
    of :func:`mma_layout` (above the limit when no grid fits).  fp32: the
    block's threads tile it as ``THREADS // ceil(bk / 4)`` thread-rows
    of pixels by ``ceil(bk / 4)`` column groups of 4; above the kernel's
    limit (``4 * MAX_ROWS_PER_THREAD``) when bk is too wide for one
    column group per thread."""
    if itemsize == 2:
        layout = mma_layout(pixels, bk)
        if layout is None:
            return 4 * _ceil(pixels, MMA_M) * _ceil(bk, MMA_N)
        return 4 * layout[2] * layout[3]
    groups = _ceil(bk, COLS_PER_THREAD)
    if groups > THREADS:
        return THREADS * COLS_PER_THREAD * pixels
    return COLS_PER_THREAD * _ceil(pixels, THREADS // groups)


def _out_hw(h: int, w: int, fh: int, fw: int, stride: int):
    return (h - fh) // stride + 1, (w - fw) // stride + 1


def clipped_extent(extent: int, out: int, tile: int, halo: int,
                   stride: int) -> int:
    """Input rows (or columns) loaded over all tiles of one axis: each
    tile's haloed window of ``halo`` rows, from output row ``t`` (input
    row ``t * stride``), clipped to the image's ``extent``."""
    return sum(min(extent, t * stride + halo) - t * stride
               for t in range(0, out, tile))


def hbm_bytes(n: int, h: int, w: int, c: int, k: int, fh: int, fw: int,
              bx: int, by: int, bc: int, bk: int, itemsize: int = 2,
              stride: int = 1) -> int:
    """Global-memory bytes the kernel's loads and stores move for
    ``x (n, h, w, c)``: every (image, spatial tile, K tile) block reads
    its haloed input window (clipped to the image: what lies outside is
    zero-filled, not loaded) across all of C, and its ``bk`` columns of
    every weight; each output is written once.  ``bc`` does not change
    the count (it is the staging step, not a reuse boundary)."""
    oh, ow = _out_hw(h, w, fh, fw, stride)
    rows = clipped_extent(h, oh, by, (by - 1) * stride + fh, stride)
    cols = clipped_extent(w, ow, bx, (bx - 1) * stride + fw, stride)
    tiles = _ceil(oh, by) * _ceil(ow, bx)
    x_reads = n * _ceil(k, bk) * rows * cols * c
    w_reads = n * tiles * fh * fw * c * k
    return (x_reads + w_reads + n * oh * ow * k) * itemsize


def conv2d_blocked_ref(x: torch.Tensor, w: torch.Tensor,
                       stride: int = 1) -> torch.Tensor:
    """Plain version of the kernel's arithmetic (JAX's ``_conv_kernel``):
    Fh * Fw shifted-window products ``(N, OH, OW, C) @ (C, K)`` summed in
    fp32, cast to x's dtype.  x: (N, H, W, C), w: (Fh, Fw, C, K)."""
    fh, fw, _, k = w.shape
    n, h, wd, _ = x.shape
    oh, ow = _out_hw(h, wd, fh, fw, stride)
    acc = torch.zeros((n, oh, ow, k), dtype=torch.float32, device=x.device)
    wf = w.float()
    for i in range(fh):
        for j in range(fw):
            patch = x[:, i:i + (oh - 1) * stride + 1:stride,
                      j:j + (ow - 1) * stride + 1:stride, :]
            acc += patch.float() @ wf[i, j]
    return acc.to(x.dtype)


def conv2d_block(x: torch.Tensor, w: torch.Tensor, *, bc: int, bk: int,
                 stride: int = 1, bx: int | None = None,
                 by: int | None = None) -> torch.Tensor:
    """The kernel: ``x (N, H, W, C)`` or one haloed tile ``(H, W, C)`` (as
    JAX's block takes it) convolved with ``w (Fh, Fw, C, K)``, channel
    tiles ``bc``/``bk`` and spatial tiles ``bx``/``by`` (default: the
    whole output, one tile, as JAX's block).  Any C, K, H, W launch.

    CUDA tensors launch the kernel (or raise: there is no fallback);
    CPU tensors take :func:`conv2d_blocked_ref`.  Forward only: the
    differentiable conv is ``ops.conv2d``."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x.unsqueeze(0)
    _check_args("conv2d_block", x, w, stride)
    n, h, wd, c = x.shape
    fh, fw, _, k = w.shape
    oh, ow = _out_hw(h, wd, fh, fw, stride)
    bx, by = bx or ow, by or oh
    if x.device.type == "cpu":
        out = conv2d_blocked_ref(x, w, stride)
    else:
        _check(x, w, bx, by, bc, bk, stride)
        out = torch.empty((n, oh, ow, k), dtype=x.dtype, device=x.device)
        fn = _build.load("conv2d_blocked", "conv2d_blocked_fwd", _ARGTYPES)
        err = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                 out.data_ptr(), n, h, wd, c, k, fh, fw, stride, bx, by, bc,
                 bk, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "conv2d_block")
        conv2d_block.launches += 1
    return out[0] if squeeze else out


conv2d_block.launches = 0


def conv2d_tiled(x: torch.Tensor, w: torch.Tensor, *, bx: int, by: int,
                 bc: int, bk: int, stride: int = 1) -> torch.Tensor:
    """The level-1 driver (JAX's ``conv2d_tiled``): ``(bx, by)`` spatial
    tiles with their halo around the level-0 ``(bc, bk)`` block, over the
    whole batch ``x (N, H, W, C)``.  On the card the spatial tiles are the
    kernel's grid, so nothing is sliced or concatenated on the host; a
    ragged last tile is masked, not collapsed into one.  Shared by the
    forward op and the dgrad driver (``conv2d_bwd.conv2d_dgrad``), whose
    transposed conv is this same nest at stride 1."""
    return conv2d_block(x, w, bc=bc, bk=bk, stride=stride, bx=bx, by=by)


def _check_args(name, x, w, stride, *, weight=True):
    """Raise, on any device, on what neither the kernel nor its plain
    version takes: one dtype of fp32 and bf16, 4-D NHWC and HWIO (or
    NHWC cotangent) operands whose channels agree, a filter no larger
    than the input, a positive stride, and inputs that require grad
    (the raw kernels are forward only)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            f"{name} has no backward: the differentiable conv is "
            "ops.conv2d (its backward runs conv2d_dgrad and conv2d_wgrad)")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{name}: operands must share one of "
                        f"{sorted(map(str, _DTYPES))}; got {x.dtype}, "
                        f"{w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be (N, H, W, C) and the other "
                         f"operand 4-D; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"{name}: stride must be >= 1, got {stride}")
    if weight:
        fh, fw, c, _ = w.shape
        if c != x.shape[3]:
            raise ValueError(f"{name}: x has {x.shape[3]} channels, w "
                             f"expects {c}")
        if fh > x.shape[1] or fw > x.shape[2]:
            raise ValueError(f"{name}: filter {(fh, fw)} is larger than "
                             f"the input {tuple(x.shape[1:3])}")


def _check(x, w, bx, by, bc, bk, stride):
    """Raise on what the CUDA kernel does not take: contiguous operands
    on one CUDA device, tiles whose accumulator fits the register limit
    and whose staged tiles fit the card's shared memory, and a grid
    within CUDA's limits."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv2d_block runs on cuda or cpu; x is on "
                         f"{x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_block: x and w must be contiguous "
                         "(NHWC, HWIO)")
    if min(bx, by, bc, bk) < 1:
        raise ValueError(f"tiles must be positive, got {(bx, by, bc, bk)}")
    acc = accumulators_per_thread(bx * by, bk, x.element_size())
    if acc > COLS_PER_THREAD * MAX_ROWS_PER_THREAD:
        raise ValueError(
            f"output tile {bx} x {by} x {bk} needs {acc} fp32 accumulators "
            f"per thread; the kernel holds at most "
            f"{COLS_PER_THREAD * MAX_ROWS_PER_THREAD}")
    fh, fw, _, k = w.shape
    need = smem_bytes_required(bx, by, bc, bk, fh, fw, x.element_size(),
                               stride, channels=x.shape[3])
    have = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"tiles {(bx, by, bc, bk)} need {need} bytes of "
                         f"shared memory per block; this card allows {have}")
    if _ceil(k, bk) > 65535 or x.shape[0] > 65535:
        raise ValueError(f"grid of {_ceil(k, bk)} K tiles and {x.shape[0]} "
                         "images exceeds CUDA's 65535")
