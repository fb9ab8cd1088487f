"""Port vs JAX: the paper's conv path on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX package (its
Pallas kernels in interpret mode, its oracles) and through the port (the
plain versions of kernel rows 12 and 13, which the wrappers take for CPU
tensors, and ``ops.conv2d``'s autograd Function).  Shapes stay small (at
most 14 per spatial axis).  Tolerance: fp32, 2e-4 abs / 2e-3 rel, the
JAX kernel tests' own: the two sum in different orders (the port's wgrad
splits against JAX's scan over tiles; the dgrad's dilation and the
shifted-window products against the Pallas grid).

The model's side of the conv path (``PAPER_LAYERS``, ``simulate_fills``,
``gemm_lowering``) is held equal to JAX's in ``test_torch_blocking.py``,
the tuner's conv keys in ``test_torch_tune.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.conv2d_blocked import conv2d_block as j_conv2d_block
from repro.kernels.conv2d_bwd import conv2d_dgrad as j_conv2d_dgrad
from repro.kernels.conv2d_bwd import conv2d_wgrad as j_conv2d_wgrad
from repro_torch.configs import PAPER_LAYERS
from repro_torch.core.hopper_adapter import (H100_SXM,
                                             backward_tile_candidates,
                                             conv_fits, conv_tile_candidates,
                                             default_smem_budget)
from repro_torch.kernels import conv2d_blocked as CB
from repro_torch.kernels import conv2d_bwd as CW
from repro_torch.kernels import ops, ref
from repro_torch.tune import ScheduleCache, best_schedule

TOL = dict(rtol=2e-3, atol=2e-4)


def rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL)


# -------------------------- row 12: the forward ----------------------------


@pytest.mark.parametrize("h,w,c,k,fh,fw,bc,bk,stride", [
    (8, 8, 4, 8, 3, 3, 4, 8, 1),
    (12, 10, 8, 16, 3, 3, 4, 8, 1),
    (9, 9, 2, 4, 2, 2, 2, 4, 1),
    (14, 14, 4, 8, 3, 3, 2, 4, 2),
    (8, 8, 4, 8, 1, 1, 4, 8, 1),   # 1x1 conv == GEMM
])
def test_conv2d_block(h, w, c, k, fh, fw, bc, bk, stride):
    """``test_kernels.py``'s block cases: one haloed tile (H, W, C)."""
    rng = np.random.default_rng(h * 100 + c)
    x, wgt = rand(rng, (h, w, c)), rand(rng, (fh, fw, c, k), 0.5)
    got = CB.conv2d_block(t(x), t(wgt), bc=bc, bk=bk, stride=stride)
    close(got, j_conv2d_block(jnp.asarray(x), jnp.asarray(wgt), bc=bc,
                              bk=bk, stride=stride, interpret=True))
    close(got, jref.conv2d_ref(jnp.asarray(x)[None], jnp.asarray(wgt),
                               stride)[0])
    close(got, ref.conv2d_ref(t(x)[None], t(wgt), stride)[0])


def test_conv2d_spatial_tiling_with_halo():
    """``ops.conv2d`` with pinned spatial tiles: the halo of every tile
    agrees with JAX's host-sliced tiles and the oracle."""
    rng = np.random.default_rng(3)
    x, w = rand(rng, (2, 20, 20, 4)), rand(rng, (3, 3, 4, 8), 0.5)
    got = ops.conv2d(t(x), t(w), tiles=(6, 6, 4, 8))
    close(got, jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                           tiles=(6, 6, 4, 8), interpret=True))
    close(got, ref.conv2d_ref(t(x), t(w)))


def test_im2col_equals_direct():
    rng = np.random.default_rng(4)
    x, w = rand(rng, (2, 10, 10, 3)), rand(rng, (4, 4, 3, 5))
    got = ref.conv2d_im2col(t(x), t(w))
    close(got, ref.conv2d_ref(t(x), t(w)))
    close(got, jref.conv2d_im2col(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_conv2d_ref_and_plain_version_match_jax(stride):
    rng = np.random.default_rng(stride)
    x, w = rand(rng, (2, 13, 11, 5)), rand(rng, (3, 2, 5, 7), 0.5)
    want = jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride)
    close(ref.conv2d_ref(t(x), t(w), stride), want)
    close(CB.conv2d_blocked_ref(t(x), t(w), stride), want)


def test_conv2d_tiled_takes_ragged_tiles():
    """Tiles that divide nothing (C = 3, K = 5, 7 x 5 outputs in tiles of
    4 x 3): the kernel masks them, so the driver keeps them (JAX takes
    its oracle); on the CPU the plain version gives the oracle's
    values."""
    rng = np.random.default_rng(5)
    x, w = rand(rng, (2, 9, 7, 3)), rand(rng, (3, 3, 3, 5), 0.5)
    got = CB.conv2d_tiled(t(x), t(w), bx=4, by=3, bc=2, bk=4)
    close(got, jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w)))


# ------------------------- gradients: rows 12, 13 --------------------------


def grads_match(n, h, w, c, k, fh, fw, stride, seed, use_kernel=True):
    rng = np.random.default_rng(seed)
    x, wgt = rand(rng, (n, h, w, c)), rand(rng, (fh, fw, c, k), 0.5)

    def j_loss(a, b):
        return jnp.sum(jops.conv2d(a, b, stride=stride, interpret=True) ** 2)
    jy = jops.conv2d(jnp.asarray(x), jnp.asarray(wgt), stride=stride,
                     interpret=True)
    jdx, jdw = jax.grad(j_loss, (0, 1))(jnp.asarray(x), jnp.asarray(wgt))
    xt, wt = t(x, grad=True), t(wgt, grad=True)
    y = ops.conv2d(xt, wt, stride=stride, use_kernel=use_kernel)
    (y ** 2).sum().backward()
    close(y, jy)
    close(xt.grad, jdx)
    close(wt.grad, jdw)
    assert xt.grad.dtype == wt.grad.dtype == torch.float32


@pytest.mark.parametrize("n,h,w,c,k,fh,fw,stride", [
    (2, 10, 10, 4, 8, 3, 3, 1),    # clean channels
    (1, 8, 8, 4, 8, 1, 1, 1),      # 1x1 conv == GEMM nest
    (1, 14, 14, 4, 8, 3, 3, 2),    # strided: dilated dgrad, strided wgrad
    (1, 11, 11, 4, 8, 3, 3, 2),    # strided with remainder rows/cols
    (2, 9, 9, 3, 5, 2, 2, 1),      # ragged channels (JAX: its oracle)
])
def test_conv2d_grad_vs_jax(n, h, w, c, k, fh, fw, stride):
    """``test_gradients.py``'s conv cases: forward and both cotangents of
    ``sum(y ** 2)`` against ``jax.grad`` of JAX's ``ops.conv2d``."""
    grads_match(n, h, w, c, k, fh, fw, stride, seed=h + c + stride)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_grad_plain_path_vs_jax(stride):
    """``use_kernel=False`` names the plain versions, forward and
    backward: the same values."""
    grads_match(1, 11, 11, 4, 8, 3, 3, stride, seed=11, use_kernel=False)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_wgrad_driver_vs_jax(stride):
    rng = np.random.default_rng(20 + stride)
    x = rand(rng, (2, 12, 12, 4))
    oh = (12 - 3) // stride + 1
    g = rand(rng, (2, oh, oh, 8))
    got = CW.conv2d_wgrad(t(x), t(g), 3, 3, stride=stride)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 4, 8)
    close(got, j_conv2d_wgrad(jnp.asarray(x), jnp.asarray(g), 3, 3,
                              stride=stride, interpret=True))
    close(got, ref.conv2d_wgrad_ref(t(x), t(g), (3, 3, 4, 8), stride))
    close(got, jref.conv2d_wgrad_ref(jnp.asarray(x), jnp.asarray(g),
                                     (3, 3, 4, 8), stride))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_dgrad_driver_vs_jax(stride):
    rng = np.random.default_rng(30 + stride)
    w = rand(rng, (3, 3, 4, 8), 0.5)
    oh = (12 - 3) // stride + 1
    g = rand(rng, (2, oh, oh, 8))
    got = CW.conv2d_dgrad(t(g), t(w), (2, 12, 12, 4), stride=stride)
    assert got.shape == (2, 12, 12, 4)
    close(got, j_conv2d_dgrad(jnp.asarray(g), jnp.asarray(w),
                              (2, 12, 12, 4), stride=stride,
                              interpret=True))
    close(got, ref.conv2d_dgrad_ref(t(g), t(w), (2, 12, 12, 4), stride))
    close(got, CW.conv2d_dgrad(t(g), t(w), (2, 12, 12, 4), stride=stride,
                               use_kernel=False))


def test_conv2d_wgrad_spatially_tiled():
    """Pinned spatial tiles: four reduction tiles per image."""
    rng = np.random.default_rng(40)
    x, g = rand(rng, (1, 14, 14, 4)), rand(rng, (1, 12, 12, 8))
    got = CW.conv2d_wgrad(t(x), t(g), 3, 3, tiles=(6, 6, 4, 8))
    close(got, j_conv2d_wgrad(jnp.asarray(x), jnp.asarray(g), 3, 3,
                              tiles=(6, 6, 4, 8), interpret=True))
    close(got, ref.conv2d_wgrad_ref(t(x), t(g), (3, 3, 4, 8)))


def test_wgrad_plain_version_reads_only_the_reachable_interior():
    """Rows and columns past the last stride-reachable one change
    nothing (the forward never reads them)."""
    rng = np.random.default_rng(41)
    x, g = rand(rng, (1, 12, 12, 3)), rand(rng, (1, 4, 4, 5))
    clipped = CW.conv2d_wgrad_block_ref(t(x[:, :10, :10]), t(g), 3, 3, 2)
    assert torch.equal(CW.conv2d_wgrad_block_ref(t(x), t(g), 3, 3, 2),
                       clipped)


# ------------------------------ refusals -----------------------------------


def test_raw_kernels_refuse_grad_and_wrong_dtypes():
    x = torch.randn(1, 6, 6, 4)
    w = torch.randn(3, 3, 4, 8)
    g = torch.randn(1, 4, 4, 8)
    with pytest.raises(NotImplementedError, match="ops.conv2d"):
        CB.conv2d_block(x.requires_grad_(), w, bc=4, bk=8)
    x = x.detach()
    with pytest.raises(NotImplementedError, match="ops.conv2d"):
        CW.conv2d_wgrad_block(x, g.requires_grad_(), 3, 3, bx=4, by=4, bc=4,
                              bk=8)
    g = g.detach()
    with pytest.raises(TypeError):
        CB.conv2d_block(x.half(), w.half(), bc=4, bk=8)
    with pytest.raises(TypeError):
        CB.conv2d_block(x, w.bfloat16(), bc=4, bk=8)
    with pytest.raises(TypeError):
        CW.conv2d_wgrad_block(x.double(), g.double(), 3, 3, bx=4, by=4,
                              bc=4, bk=8)
    with pytest.raises(ValueError, match="channels"):
        CB.conv2d_block(x, torch.randn(3, 3, 5, 8), bc=4, bk=8)
    with pytest.raises(ValueError, match="cotangent"):
        CW.conv2d_wgrad_block(x, torch.randn(1, 5, 4, 8), 3, 3, bx=4, by=4,
                              bc=4, bk=8)
    with torch.no_grad():              # not under grad: no refusal
        CB.conv2d_block(x.requires_grad_(), w, bc=4, bk=8)


def test_ops_conv2d_launches_nothing_on_the_cpu():
    """CPU tensors take the plain versions: no kernel launch is
    counted, forward or backward."""
    before = (CB.conv2d_block.launches, CW.conv2d_wgrad_block.launches)
    x = torch.randn(1, 7, 7, 3, requires_grad=True)
    w = torch.randn(2, 2, 3, 4, requires_grad=True)
    ops.conv2d(x, w).sum().backward()
    assert x.grad is not None and w.grad is not None
    assert (CB.conv2d_block.launches,
            CW.conv2d_wgrad_block.launches) == before


# --------------------------- footprints ------------------------------------


# the paper's Table-4 conv layers and AlexNet conv1 (stride 4): name,
# the forward's output X, Y, C, K, Fw, Fh and stride
CONV_LAYERS = [(n, p.X, p.Y, p.C, p.K, p.Fw, p.Fh, 1)
               for n, p in PAPER_LAYERS.items() if n.startswith("Conv")] + \
    [("AlexNet conv1", 55, 55, 3, 96, 11, 11, 4)]


@pytest.mark.parametrize("op", ["conv2d", "conv2d_dgrad"])
@pytest.mark.parametrize("layer", CONV_LAYERS, ids=[c[0] for c in CONV_LAYERS])
def test_snapped_bf16_tiles_fit_the_tensor_core_kernel(layer, op, tmp_path):
    """Every bf16 tile the model emits for row 12 (the forward, and the
    dgrad's transposed conv at stride 1) fits the tensor-core instance:
    its staged tiles within the two-block budget and its fragments within
    64 fp32 sums a thread; bc in whole 8-channel chunks (C = 3 whole), bk
    in whole n8 fragments of every warp across N (K = 3 whole); at most
    1/8 of the M rows its warps compute past bx * by.  The tuner's pick
    is one of them."""
    _, X, Y, C, K, Fw, Fh, s = layer
    if op == "conv2d_dgrad":
        X, Y, C, K, s_key = (X - 1) * s + Fw, (Y - 1) * s + Fh, K, C, 1
    else:
        s_key = s
    dims = (X, Y, C, K, Fw, Fh)
    budget = default_smem_budget()
    if op == "conv2d":
        tiles = conv_tile_candidates(*dims, 2, budget, H100_SXM, top=8,
                                     stride=s_key)
    else:
        tiles = backward_tile_candidates(op, dims, 2, budget, H100_SXM,
                                         top=8)
    assert tiles
    for bx, by, bc, bk in tiles:
        assert conv_fits(bx, by, bc, bk, Fw, Fh, 2, budget, s_key,
                         channels=C)
        assert CB.smem_bytes_required(bx, by, bc, bk, Fh, Fw, 2, s_key,
                                      channels=C) <= budget
        assert CB.accumulators_per_thread(bx * by, bk) <= 64
        assert bc % 8 == 0 or bc == C < 8
        _, wn, _, nt = CB.mma_layout(bx * by, bk)
        assert bk % (8 * wn) == 0 or bk == K < 8
        assert CB.empty_row_share(bx * by, bk) <= 1 / 8, (bx, by, bk)
    assert best_schedule(op, dims, "bfloat16", cache=ScheduleCache(
        str(tmp_path / "empty.json")), stride=s_key).tiles in tiles


@pytest.mark.parametrize("bc,itemsize,want", [
    (3, 2, 8), (8, 2, 8), (16, 2, 24), (32, 2, 40), (4, 4, 4), (8, 4, 12),
    (32, 4, 36)])
def test_pixel_stride_is_an_odd_number_of_vectors(bc, itemsize, want):
    assert CB.pixel_stride(bc, itemsize) == want


def test_footprints_and_traffic_count_the_kernels_tiles():
    # Conv1's 11 x 11 weight tile on the tensor cores (bf16) at bc = 8,
    # bk = 16: 121 taps of one 8-channel chunk, rounded up to whole
    # 16-deep k-steps (976 rows, the last 8 zero), each row 2 vectors
    # (XOR-swizzled, unpadded); two stages with the 26 x 26 input tile of
    # one vector a pixel, then a 4-byte offset per chunk: 84,584 B
    assert CB.weight_rows(8, 11, 11) == 976
    assert CB.smem_bytes_required(16, 16, 8, 16, 11, 11, 2) == \
        2 * (26 * 26 * 8 + 976 * 16) * 2 + 122 * 4 == 84_584
    # weight rows: powers of two swizzled, odd counts as they are, other
    # counts padded to odd; input pixels: odd counts
    assert [CB.weight_vectors(bk) for bk in (3, 8, 16, 24, 32, 48, 64,
                                             96, 128)] == \
        [1, 1, 2, 3, 4, 7, 8, 13, 16]
    assert CB.pixel_stride(16, 2) == 24
    # no pad chunk: 3 x 3 taps of 16 channels, 144 rows
    assert CB.weight_rows(16, 3, 3) == 144
    # one stage where C takes one step of bc (AlexNet conv1's C = 3 at
    # stride 4: a 51 x 51 input tile, bk = 32 in 4 swizzled vectors)
    assert CB.smem_bytes_required(11, 11, 3, 32, 11, 11, 2, 4,
                                  channels=3) == \
        (51 * 51 * 8 + 976 * 32) * 2 + 122 * 4
    assert CB.smem_bytes_required(11, 11, 3, 32, 11, 11, 2, 4,
                                  channels=6) == \
        2 * (51 * 51 * 8 + 976 * 32) * 2 + 122 * 4
    # fp32 keeps the CUDA-core loop's footprint: 121 taps of bc = 8 by
    # bk = 32 (61,952 B a stage in bf16 terms, 123,904 in fp32)
    assert CB.smem_bytes_required(16, 16, 8, 32, 11, 11, 4) == \
        2 * (26 * 26 * 12 + 121 * 8 * 32) * 4
    assert CB.accumulators_per_thread(16 * 16, 64, 4) == 64
    assert CB.accumulators_per_thread(16 * 16, 128, 4) == 128
    # bf16: 8 warps down M, each 2 m16 x 8 n8 fragments (64 sums); at bk
    # = 128 two warps across N, each 4 x 8: over the limit
    assert CB.mma_layout(16 * 16, 64) == (8, 1, 2, 8)
    assert CB.accumulators_per_thread(16 * 16, 64) == 64
    assert CB.mma_layout(16 * 16, 128) == (4, 2, 4, 8)
    assert CB.accumulators_per_thread(16 * 16, 128) == 128
    # the dgrad's old Conv1 tile (7, 19): 133 pixels take 9 m16 tiles,
    # 2 a warp, so 123 of 256 rows are empty; 128 pixels leave none
    assert CB.mma_layout(7 * 19, 16) == (8, 1, 2, 2)
    assert CB.empty_row_share(7 * 19, 16) == 1 - 133 / 256
    assert CB.empty_row_share(16 * 8, 16) == 0
    # AlexNet's dgrad writes 3 channels: one n8 tile, 5 columns clamped
    assert CB.mma_layout(128, 3) == (8, 1, 1, 1)
    # wide K tiles spread warps across N; past 512 no grid holds one
    assert CB.mma_layout(64, 256) == (2, 4, 2, 8)
    assert CB.mma_layout(16, 520) is None
    assert CB.accumulators_per_thread(16, 520) > 64
    assert CW.accumulators_per_thread(8, 16, 11, 11) == 64
    assert CW.accumulators_per_thread(16, 16, 11, 11) > 64
    assert CW.smem_bytes_required(8, 8, 8, 16, 3, 3, 4, stride=2) == \
        2 * (17 * 17 * 12 + 64 * 16) * 4
    # one tile in every dimension: each input, weight and output once
    n, h, w, c, k = 2, 10, 10, 4, 8
    assert CB.hbm_bytes(n, h, w, c, k, 3, 3, 8, 8, 4, 8, 4) == \
        (n * h * w * c + n * 3 * 3 * c * k + n * 8 * 8 * k) * 4
    # a remainder column the stride never reaches is still loaded once a
    # tile's window covers it; windows past the image are not
    assert CB.clipped_extent(11, 5, 2, 5, 2) == 5 + 5 + 3
    assert CW.splits_for(768, 512, 132) == 1
    assert CW.splits_for(32, 2 * 16, 132) == 9
    assert CW.splits_for(1, 4, 132) == 4
