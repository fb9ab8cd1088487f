"""Backward of the direct blocked convolution: the wgrad kernel (kernel
row 13) with its wrapper and plain version, and the dgrad and wgrad
drivers.

Port of ``repro.kernels.conv2d_bwd``.  For ``y = conv2d(x, w, stride)``
(NHWC x HWIO, VALID):

* **wgrad** ``dW[i,j,c,k] = sum_{n,y,x} X[n, y*s+i, x*s+j, c] *
  g[n, y, x, k]``: the forward's (Fw, Fh, X, Y, C, K) nest with the
  weights written and the output space reduced.  ``csrc/conv2d_wgrad.cu``
  (design in its header comment) reduces fixed, contiguous ranges of
  (image, spatial tile) pairs into fp32 partials in a first pass and sums
  them in split order in a second: no atomics, bit-equal from launch to
  launch.  bf16 multiplies on the tensor cores, an implicit GEMM of the
  dW tile's (tap, channel) rows by the cotangent's columns over the
  staged pixels (``mma.sync``; warp grid :func:`mma_layout`); fp32 keeps
  the CUDA-core loop (TF32 would break the fp32 tolerances).  JAX writes
  a partial per spatial tile and sums them in a ``scan``, so the two sum
  in different orders.
* **dgrad** ``dX = conv(dilate_s(g) padded by (Fh-1, Fw-1),
  rot180(W)^T)``: a transposed conv, i.e. another direct conv with the
  channel roles swapped (K in, C out).  The dilation, padding, flip and
  transpose are torch ops on the host; the conv itself is kernel row 12
  (``conv2d_blocked.conv2d_tiled``) at stride 1 under its own
  ``"conv2d_dgrad"`` schedule key.

Tiles come from ``repro_torch.tune.best_schedule`` under
``"conv2d_wgrad"`` / ``"conv2d_dgrad"`` unless given.  The kernels mask
ragged channel and spatial tiles, so no shape falls back to an oracle
(JAX's drivers take ``ref`` for channel tiles that do not divide).
``use_kernel=False`` runs the plain versions: the yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.hopper_adapter import H100_SXM, MAX_EMPTY_ROWS
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_blocked import (STAGES, THREADS,
                                                _check_args, _DTYPES,
                                                _out_hw, clipped_extent,
                                                conv2d_blocked_ref,
                                                conv2d_tiled, pixel_stride,
                                                weight_vectors)

# fp32, the CUDA-core loop
COLS_PER_THREAD = 4       # K columns a thread holds (csrc: conv::kCols)
MAX_GROUPS_PER_THREAD = 4  # (tap, 4-channel) groups: 64 fp32 sums
MAX_SPLITS = 64           # partials of the first pass, at most
# bf16, the tensor cores (mma.sync m16n8k16): M the dW tile's (tap,
# channel) rows, N its bk columns, the reduction 16 staged pixels a step
WARPS = THREADS // 32
MMA_M, MMA_N = 16, 8      # one fragment: 16 dW rows x 8 output channels
CHUNK = 8                 # dW rows: 8-channel chunks of one tap
K_STEP = 16               # pixels one mma reduces
MAX_FRAGMENTS = 16        # fragments a warp holds: 64 fp32 sums a thread
MAX_N_TILES = 8           # n8 fragments a warp holds

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
             + [ctypes.c_void_p])


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def dw_rows(bc: int, fh: int, fw: int) -> int:
    """M of the bf16 instance: ``fh * fw`` taps of ``bc`` channels rounded
    up to 8-channel chunks (C = 3 is one chunk; the pad rows are computed
    and never stored)."""
    return fh * fw * _ceil(bc, CHUNK) * CHUNK


def _sparse(rows: int, layout: tuple[int, int, int, int]) -> bool:
    """Whether a grid leaves more than ``MAX_EMPTY_ROWS`` of its computed
    rows past the dW tile's."""
    computed = MMA_M * layout[0] * layout[2]
    return computed - rows > MAX_EMPTY_ROWS * computed


def mma_layout(bc: int, bk: int, fh: int,
               fw: int) -> tuple[int, int, int, int] | None:
    """The bf16 instance's warp grid for a ``(fh, fw, bc, bk)`` dW tile:
    ``(wm, wn, mt, nt)``, ``wn`` warps across the bk columns and ``wm = 8
    // wn`` down the :func:`dw_rows`, each holding ``mt`` m16 x ``nt`` n8
    fragments.  Of the grids with no more warps across N than n8 tiles
    (a warp past them would only repeat clamped columns) and ``nt <= 8``
    whose fragments fit
    (``mt * nt <= 16``): the one that leaves at most ``MAX_EMPTY_ROWS`` of
    its computed rows empty, then needs the fewest ``ldmatrix.x4`` a
    k-step (``mt + ceil(nt / 2)``: the kernel is bound by its shared
    memory reads), then computes the fewest fragments, then has the
    fewest warps across N.  If none fits, the first with ``nt <= 8``
    (then the tile needs more sums than a thread holds); None past 512
    columns.  csrc: ``mma_layout`` in ``conv2d_wgrad.cu``."""
    rows = dw_rows(bc, fh, fw)
    mt_all, nt_all = _ceil(rows, MMA_M), _ceil(bk, MMA_N)
    grids = [(WARPS // wn, wn, _ceil(mt_all, WARPS // wn), _ceil(nt_all, wn))
             for wn in (1, 2, 4, 8) if wn == 1 or wn <= nt_all]
    grids = [g for g in grids if g[3] <= MAX_N_TILES]
    fits = [g for g in grids if g[2] * g[3] <= MAX_FRAGMENTS]
    if fits:
        return min(fits, key=lambda g: (_sparse(rows, g),
                                        g[2] + _ceil(g[3], 2), g[2] * g[3],
                                        g[1]))
    return grids[0] if grids else None


def empty_row_share(bc: int, bk: int, fh: int, fw: int) -> float:
    """Share of the bf16 instance's computed dW rows (``16 wm mt``) past
    :func:`dw_rows`: computed and never stored (1 past 512 columns)."""
    layout = mma_layout(bc, bk, fh, fw)
    if layout is None:
        return 1.0
    return 1 - dw_rows(bc, fh, fw) / (MMA_M * layout[0] * layout[2])


def padded_pixel_share(bx: int, by: int) -> float:
    """Share of the bf16 instance's reduction slots (``bx * by`` rounded up
    to whole 16-pixel k-steps) that are padding: zero cotangent rows
    against the last real pixel, multiplied and adding nothing."""
    p = bx * by
    return 1 - p / (_ceil(p, K_STEP) * K_STEP)


def smem_bytes_required(bx: int, by: int, bc: int, bk: int, fh: int,
                        fw: int, itemsize: int = 2, stride: int = 1) -> int:
    """Dynamic shared memory of one wgrad block, two stages deep: the
    haloed input tile (as the forward stages it) and the (by, bx)
    cotangent tile.  bf16 (the tensor cores): ``bx * by`` cotangent rows
    rounded up to whole 16-pixel k-steps, each of
    ``conv2d_blocked.weight_vectors(bk)`` 16-byte vectors, then one 4-byte
    offset per pixel slot (the table the A fragments are addressed from),
    each stage's 4-byte padding mask per k-step (rounded up to 16 bytes)
    and one zeroed 16-byte chunk, which the slots without an output pixel
    read.
    fp32 (the CUDA cores): one row per pixel of ``bk`` rounded up to a
    16-byte vector.  The fp32 dW tile is in registers
    (:func:`accumulators_per_thread`)."""
    vec = 16 // itemsize
    ih = (by - 1) * stride + fh
    iw = (bx - 1) * stride + fw
    x_tile = ih * iw * pixel_stride(bc, itemsize)
    if itemsize == 2:
        slots = _ceil(bx * by, K_STEP) * K_STEP
        g_tile = slots * weight_vectors(bk) * vec
        masks = _ceil(STAGES * slots // K_STEP, 4) * 4
        return (STAGES * (x_tile + g_tile) * itemsize + slots * 4
                + masks * 4 + 16)
    g_tile = bx * by * _ceil(bk, vec) * vec
    return STAGES * (x_tile + g_tile) * itemsize


def accumulators_per_thread(bc: int, bk: int, fh: int, fw: int,
                            itemsize: int = 2) -> int:
    """fp32 sums each thread holds for a ``(fh, fw, bc, bk)`` dW tile.
    bf16: four per fragment of :func:`mma_layout` (above the limit when
    no grid fits).  fp32: the block's threads tile it as ``THREADS //
    ceil(bk / 4)`` thread-rows of (tap, 4-channel) groups by ``ceil(bk /
    4)`` column groups, 16 sums per group; above the kernel's limit
    (``16 * MAX_GROUPS_PER_THREAD``) when bk is too wide for one column
    group per thread."""
    if itemsize == 2:
        layout = mma_layout(bc, bk, fh, fw)
        if layout is None:
            return 4 * _ceil(dw_rows(bc, fh, fw), MMA_M) * _ceil(bk, MMA_N)
        return 4 * layout[2] * layout[3]
    return 16 * fma_rows(bc, bk, fh, fw)


def fma_rows(bc: int, bk: int, fh: int, fw: int) -> int:
    """(tap, 4-channel) groups a thread of the fp32 instance holds (all of
    them on one thread when bk is too wide for one column group per
    thread)."""
    groups = _ceil(bk, COLS_PER_THREAD)
    rows = fh * fw * _ceil(bc, 4)
    if groups > THREADS:
        return rows
    return _ceil(rows, THREADS // groups)


def splits_for(n_blocks: int, pairs: int, sms: int) -> int:
    """Partials of the first pass: enough that ``n_blocks * splits``
    blocks fill two blocks per SM, at most one per (image, tile) pair and
    ``MAX_SPLITS``."""
    return max(1, min(pairs, MAX_SPLITS, _ceil(2 * sms, n_blocks)))


def hbm_bytes(n: int, h: int, w: int, c: int, k: int, fh: int, fw: int,
              bx: int, by: int, bc: int, bk: int, itemsize: int = 2,
              stride: int = 1, sms: int = H100_SXM.sms) -> int:
    """Global-memory bytes of one :func:`conv2d_wgrad_block` call (both
    passes) for ``x (n, h, w, c)``: the first pass's (C tile, K tile,
    split) blocks together stage every (image, spatial tile) pair's
    haloed input window (clipped to the image, as the forward's) once
    per K tile across all of C, and its cotangent tile once per C tile
    across all of K; each split writes an fp32 (Fh, Fw, C, K) partial
    (:func:`splits_for` on ``sms`` SMs), which the second pass reads
    back before writing dW once.  JAX's count is one image through the
    single-pass TPU kernel."""
    oh, ow = _out_hw(h, w, fh, fw, stride)
    rows = clipped_extent(h, oh, by, (by - 1) * stride + fh, stride)
    cols = clipped_extent(w, ow, bx, (bx - 1) * stride + fw, stride)
    pairs = n * _ceil(oh, by) * _ceil(ow, bx)
    splits = splits_for(_ceil(c, bc) * _ceil(k, bk), pairs, sms)
    x_reads = n * _ceil(k, bk) * rows * cols * c
    g_reads = n * _ceil(c, bc) * oh * ow * k
    dw = fh * fw * c * k * 4
    return (x_reads + g_reads) * itemsize + (2 * splits + 1) * dw


def conv2d_wgrad_block_ref(x: torch.Tensor, g: torch.Tensor, fh: int,
                           fw: int, stride: int = 1) -> torch.Tensor:
    """Plain version of the wgrad arithmetic (JAX's ``_wgrad_kernel``):
    per tap, the strided window of x ``(N*OH*OW, C)`` transposed times
    the cotangent ``(N*OH*OW, K)``, in fp32.  Returns fp32 (Fh, Fw, C,
    K); only the stride-reachable interior of x is read."""
    n, oh, ow, k = g.shape
    c = x.shape[3]
    gf = g.float().reshape(-1, k)
    out = torch.empty((fh, fw, c, k), dtype=torch.float32, device=g.device)
    for i in range(fh):
        for j in range(fw):
            patch = x[:, i:i + (oh - 1) * stride + 1:stride,
                      j:j + (ow - 1) * stride + 1:stride, :]
            out[i, j] = patch.float().reshape(-1, c).T @ gf
    return out


def conv2d_wgrad_block(x: torch.Tensor, g: torch.Tensor, fh: int, fw: int,
                       *, bx: int, by: int, bc: int, bk: int,
                       stride: int = 1) -> torch.Tensor:
    """The kernel's two passes: fp32 ``dW (fh, fw, C, K)`` from ``x (N, H,
    W, C)`` and the cotangent ``g (N, OH, OW, K)``, spatial reduction
    tiles ``bx``/``by``, channel tiles ``bc``/``bk``.  Rows and columns of
    x past the stride-reachable interior (the forward never read them)
    meet no output pixel in the kernel's loop, so they add nothing.

    CUDA tensors launch the kernel (or raise: there is no fallback):
    bf16 its tensor-core instance, fp32 its CUDA-core one, recorded in
    ``instance`` (``("mma", (wm, wn, mt, nt))`` or ``("fma", groups a
    thread holds)``); CPU tensors take :func:`conv2d_wgrad_block_ref`.
    ``launches`` counts both passes."""
    _check_args("conv2d_wgrad_block", x, g, stride, weight=False)
    n, h, wd, c = x.shape
    oh = (h - fh) // stride + 1
    ow = (wd - fw) // stride + 1
    if fh < 1 or fw < 1 or tuple(g.shape) != (n, oh, ow, g.shape[3]):
        raise ValueError(
            f"conv2d_wgrad_block: cotangent {tuple(g.shape)} is not the "
            f"output of a {fh} x {fw} stride-{stride} conv of "
            f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return conv2d_wgrad_block_ref(x, g, fh, fw, stride)
    k = g.shape[3]
    _check(x, g, fh, fw, bx, by, bc, bk, stride)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = splits_for(_ceil(c, bc) * _ceil(k, bk),
                        n * _ceil(oh, by) * _ceil(ow, bx), sms)
    part = torch.empty((splits, fh, fw, c, k), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((fh, fw, c, k), dtype=torch.float32, device=x.device)
    fn = _build.load("conv2d_wgrad", "conv2d_wgrad", _ARGTYPES)
    err = fn(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), part.data_ptr(),
             out.data_ptr(), n, h, wd, c, k, fh, fw, stride, bx, by, bc, bk,
             splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv2d_wgrad_block")
    conv2d_wgrad_block.launches += 2      # the partial pass and the sum
    conv2d_wgrad_block.instance = _instance(x.dtype, bc, bk, fh, fw)
    return out


conv2d_wgrad_block.launches = 0
conv2d_wgrad_block.instance = None


def _instance(dtype, bc, bk, fh, fw):
    """What a launch ran: ``("mma", (wm, wn, mt, nt))`` in bf16, ``("fma",
    groups a thread holds)`` in fp32."""
    if dtype == torch.bfloat16:
        return "mma", mma_layout(bc, bk, fh, fw)
    return "fma", fma_rows(bc, bk, fh, fw)


def _check_operands(x, g):
    """Raise unless x and g are contiguous and on one CUDA device."""
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"conv2d_wgrad_block runs on cuda or cpu; x is on "
                         f"{x.device}, g on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv2d_wgrad_block: x and g must be contiguous "
                         "(NHWC)")


def _check(x, g, fh, fw, bx, by, bc, bk, stride):
    """Raise on what the wgrad kernel does not take: the operands
    (:func:`_check_operands`), tiles whose dW tile fits the register
    limit (in bf16: on a warp grid of :func:`mma_layout`) and whose
    staged tiles fit the card's shared memory."""
    _check_operands(x, g)
    if min(bx, by, bc, bk) < 1:
        raise ValueError(f"tiles must be positive, got {(bx, by, bc, bk)}")
    acc = accumulators_per_thread(bc, bk, fh, fw, x.element_size())
    if acc > 16 * MAX_GROUPS_PER_THREAD:
        raise ValueError(
            f"dW tile {fh} x {fw} x {bc} x {bk} needs {acc} fp32 "
            f"accumulators per thread; the kernel holds at most "
            f"{16 * MAX_GROUPS_PER_THREAD}")
    need = smem_bytes_required(bx, by, bc, bk, fh, fw, x.element_size(),
                               stride)
    have = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"tiles {(bx, by, bc, bk)} need {need} bytes of "
                         f"shared memory per block; this card allows {have}")


def conv2d_wgrad(x: torch.Tensor, g: torch.Tensor, fh: int, fw: int,
                 stride: int = 1,
                 tiles: tuple[int, int, int, int] | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """fp32 ``dW (Fh, Fw, C, K)`` for ``y = conv2d(x, w, stride)`` at the
    NHWC cotangent g (JAX's driver :122): row 13 under the
    ``"conv2d_wgrad"`` key's ``(bx, by, bc, bk)`` (the forward's dims:
    ``(OW, OH, C, K, Fw, Fh)`` at the forward's stride).  Only the
    stride-reachable interior of x contributes, as in the forward."""
    from repro_torch.tune import best_schedule
    if not use_kernel:
        return conv2d_wgrad_block_ref(x, g, fh, fw, stride)
    _, oh, ow, k = g.shape
    c = x.shape[3]
    bx, by, bc, bk = tiles or best_schedule(
        "conv2d_wgrad", (ow, oh, c, k, fw, fh), _dtype_name(g),
        stride=stride).tiles
    return conv2d_wgrad_block(x.contiguous(), g.contiguous(), fh, fw, bx=bx,
                              by=by, bc=bc, bk=bk, stride=stride)


def dgrad_operands(g: torch.Tensor, w: torch.Tensor,
                   stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The dgrad's transposed conv as a stride-1 direct conv: the NHWC
    cotangent g dilated by the stride and padded by the filter minus one,
    and the weights flipped and transposed to ``(Fh, Fw, K, C)``."""
    n, oh, ow, k = g.shape
    fh, fw = w.shape[:2]
    if stride > 1:                       # transposed conv: input dilation
        gd = g.new_zeros((n, (oh - 1) * stride + 1, (ow - 1) * stride + 1,
                          k))
        gd[:, ::stride, ::stride, :] = g
    else:
        gd = g
    gp = F.pad(gd, (0, 0, fw - 1, fw - 1, fh - 1, fh - 1)).contiguous()
    return gp, w.flip(0, 1).transpose(2, 3).contiguous()


def conv2d_dgrad(g: torch.Tensor, w: torch.Tensor,
                 x_shape: tuple[int, ...], stride: int = 1,
                 tiles: tuple[int, int, int, int] | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """``dX (N, H, W, C)`` for ``y = conv2d(x, w, stride)`` at the NHWC
    cotangent g (JAX's driver :165).

    On the host: dilate g by the stride, pad it by the filter minus one,
    and flip and transpose the weights to ``(Fh, Fw, K, C)``; the rest is
    a stride-1 direct conv with K in and C out, row 12 under the
    ``"conv2d_dgrad"`` key (dims ``(W_d, H_d, K, C, Fw, Fh)`` in its own
    output space).  Rows and columns the strided forward never read get
    zero gradient."""
    from repro_torch.tune import best_schedule
    _, h, wd, c = x_shape
    fh, fw, _, k = w.shape
    _, oh, ow, _ = g.shape
    gp, w_t = dgrad_operands(g, w, stride)
    oh_d = (oh - 1) * stride + fh        # == H less the remainder rows
    ow_d = (ow - 1) * stride + fw
    if use_kernel:
        bx, by, bc, bk = tiles or best_schedule(
            "conv2d_dgrad", (ow_d, oh_d, k, c, fw, fh),
            _dtype_name(g)).tiles
        dx = conv2d_tiled(gp, w_t, bx=bx, by=by, bc=bc, bk=bk, stride=1)
    else:
        dx = conv2d_blocked_ref(gp, w_t, 1)
    return F.pad(dx, (0, 0, 0, wd - ow_d, 0, h - oh_d))
