"""Row 13's bf16 tensor-core instance (``csrc/conv2d_wgrad.cu``,
``wgrad_mma``) and its tiles, on the CPU.

* The warp grid: ``conv2d_bwd.mma_layout`` at every bf16
  ``"conv2d_wgrad"`` candidate of the six phase-12 layers (the Table-4
  convolutions and AlexNet conv1): eight warps, fragments and fp32 sums a
  thread within the instance's limits, at most ``MAX_EMPTY_ROWS`` of the
  computed dW rows empty, at most ``MAX_PADDED_PIXELS`` of a pair's
  reduction slots padding, the staged tiles within the two-block budget.
  The fp32 tiles (the CUDA-core instance) are pinned as they were.
* The lane arithmetic: a numpy emulation of one launch -- the staging
  into NaN-filled shared memory (it is not initialised on the card), the
  pixel-offset table, the (tap, chunk) offsets, ``ldmatrix.x4.trans`` of
  A and B, ``mma.sync`` m16n8k16 with fp32 sums, the masked store and the
  sum over splits -- against ``conv2d_wgrad_block_ref`` and JAX's
  ``conv2d_wgrad_block`` in interpret mode.
* The bank groups of the staged A and B operands.
* The launch: ``conv2d_wgrad`` asks ``best_schedule`` and the wrapper
  launches its tiles and records the instance (the loader
  monkeypatched, meta tensors: no card); tiles the instance does not
  hold raise.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_bwd import conv2d_wgrad_block as j_wgrad_block
from repro_torch.configs import PAPER_LAYERS
from repro_torch.core.hopper_adapter import (H100_SXM, MAX_EMPTY_ROWS,
                                             MAX_PADDED_PIXELS,
                                             backward_tile_candidates,
                                             conv_fits, default_smem_budget)
from repro_torch.kernels import _build
from repro_torch.kernels import conv2d_blocked as CB
from repro_torch.kernels import conv2d_bwd as CW
from repro_torch.tune import ScheduleCache, best_schedule

# name, the forward's output X, Y, C, K, Fw, Fh, stride
CONV_LAYERS = [(n, p.X, p.Y, p.C, p.K, p.Fw, p.Fh, 1)
               for n, p in PAPER_LAYERS.items() if n.startswith("Conv")] + \
    [("AlexNet conv1", 55, 55, 3, 96, 11, 11, 4)]
LAYER_IDS = [c[0] for c in CONV_LAYERS]


def _ceil(a, b):
    return -(-a // b)


# ------------------------------ the warp grid -------------------------------


@pytest.mark.parametrize("layer", CONV_LAYERS, ids=LAYER_IDS)
def test_adapter_tiles_sit_on_the_warp_grid(layer, tmp_path):
    """Every bf16 wgrad tile the model emits for a phase-12 layer: bc in
    whole 8-channel chunks (C = 3 whole), bk of 16 or more in whole n8
    fragments of every warp across N, the dW tile on a grid of 64 sums a
    thread that leaves at most 1/8 of its rows empty, the pair's pixels
    padded by at most 1/8, both stages within the two-block budget; the
    tuner's pick is one of them."""
    _, X, Y, C, K, Fw, Fh, s = layer
    dims = (X, Y, C, K, Fw, Fh)
    budget = default_smem_budget()
    tiles = backward_tile_candidates("conv2d_wgrad", dims, 2, budget,
                                     H100_SXM, top=8, stride=s)
    assert tiles
    for bx, by, bc, bk in tiles:
        assert bc % 8 == 0 or bc == C < 8
        wm, wn, mt, nt = CW.mma_layout(bc, bk, Fh, Fw)
        assert wm * wn == CW.WARPS
        assert 16 * wm * mt >= CW.dw_rows(bc, Fh, Fw) and 8 * wn * nt >= bk
        assert mt * nt <= CW.MAX_FRAGMENTS and nt <= CW.MAX_N_TILES
        assert bk >= 16 and bk % (8 * wn) == 0
        assert CW.accumulators_per_thread(bc, bk, Fh, Fw) == 4 * mt * nt \
            <= H100_SXM.acc_per_thread
        assert CW.empty_row_share(bc, bk, Fh, Fw) <= MAX_EMPTY_ROWS
        assert CW.padded_pixel_share(bx, by) <= MAX_PADDED_PIXELS
        assert CW.smem_bytes_required(bx, by, bc, bk, Fh, Fw, 2, s) <= budget
        assert conv_fits(bx, by, bc, bk, Fw, Fh, 2, budget, s, wgrad=True)
        assert bx * by >= 16
    assert best_schedule("conv2d_wgrad", dims, "bfloat16", cache=ScheduleCache(
        str(tmp_path / "empty.json")), stride=s).tiles in tiles


def test_conv1_tile_puts_the_reuse_on_bk():
    """Conv1's 11 x 11 dW tile at bc = 8, bk = 16: 121 taps of one chunk
    (968 rows, 61 m16 tiles) over 8 warps of 8 m16 x 2 n8 fragments, so
    each A fragment feeds two mma (bc = 16, bk = 8 would feed one); 32 x
    16 pixels a pair, 32 k-steps."""
    tiles = backward_tile_candidates("conv2d_wgrad",
                                     (256, 256, 256, 384, 11, 11), 2)
    assert tiles[0] == (32, 16, 8, 16)
    assert CW.mma_layout(8, 16, 11, 11) == (8, 1, 8, 2)
    assert CW.empty_row_share(8, 16, 11, 11) == 1 - 968 / 1024
    assert CW.accumulators_per_thread(16, 16, 11, 11) > 64


@pytest.mark.parametrize("tile,layout", [
    ((8, 16, 11, 11), (8, 1, 8, 2)),    # Conv1: fewest ldmatrix
    ((32, 32, 3, 3), (4, 2, 5, 2)),     # 288 rows: wn = 1 leaves 1/4 empty
    ((8, 16, 9, 9), (4, 2, 11, 1)),     # Conv2: 648 rows
    ((24, 40, 4, 4), (8, 1, 3, 5)),     # Conv3's channels: an odd nt
    ((8, 128, 3, 3), (1, 8, 5, 2)),     # wide bk: 8 warps across N
    ((3, 3, 3, 3), (8, 1, 1, 1)),       # C = K = 3 at 3 x 3: 72 rows
    ((4, 8, 1, 1), (8, 1, 1, 1)),       # one chunk: under one fragment
    ((16, 16, 11, 11), (8, 1, 16, 2)),  # 128 sums a thread: refused
    ((8, 520, 3, 3), None),             # past 512 columns
])
def test_layout_rule(tile, layout):
    assert CW.mma_layout(*tile) == layout
    if layout is None or layout[2] * layout[3] > CW.MAX_FRAGMENTS:
        assert CW.accumulators_per_thread(*tile) > H100_SXM.acc_per_thread


def test_footprint_of_conv1s_tile():
    """(32, 16, 8, 16) at 11 x 11: a 42 x 26 input tile of one vector a
    pixel and 512 cotangent rows of two (XOR-swizzled) vectors a stage,
    two stages, then a 4-byte offset per pixel slot: 69,760 B, within
    the two-block budget of 115,712 B.  A ragged pair (7 x 19 = 133
    pixels) stages 144 rows and pads 11 slots."""
    assert CW.smem_bytes_required(32, 16, 8, 16, 11, 11) == \
        2 * (42 * 26 * 8 + 512 * 2 * 8) * 2 + 512 * 4 == 69_760
    assert CW.smem_bytes_required(7, 19, 8, 16, 3, 3) == \
        2 * (21 * 9 * 8 + 144 * 2 * 8) * 2 + 144 * 4
    assert CW.padded_pixel_share(7, 19) == 1 - 133 / 144
    # fp32 keeps the CUDA-core footprint: rows of bk rounded to a vector
    assert CW.smem_bytes_required(8, 8, 8, 16, 3, 3, 4, stride=2) == \
        2 * (17 * 17 * 12 + 64 * 16) * 4
    assert CW.accumulators_per_thread(8, 16, 11, 11, 4) == 64
    assert CW.fma_rows(8, 16, 11, 11) == 4


# the fp32 "conv2d_wgrad" candidates of the six layers (the CUDA-core
# instance): the same as before the bf16 instance had its own snap
FP32_TILES = {
    "Conv1": ((8, 16, 16, 8), (16, 16, 8, 12)),
    "Conv2": ((10, 15, 16, 12), (50, 1, 16, 12), (10, 5, 16, 12)),
    "Conv3": ((1, 32, 12, 20), (1, 1, 12, 20), (16, 16, 12, 20)),
    "Conv4": ((7, 14, 32, 32), (1, 1, 32, 32)),
    "Conv5": ((1, 1, 32, 32), (7, 14, 32, 32)),
    "AlexNet conv1": ((1, 1, 3, 32), (11, 5, 3, 32), (55, 1, 3, 32),
                      (11, 11, 3, 32)),
}


@pytest.mark.parametrize("layer", CONV_LAYERS, ids=LAYER_IDS)
def test_fp32_tiles_are_unchanged(layer):
    name, X, Y, C, K, Fw, Fh, s = layer
    assert backward_tile_candidates("conv2d_wgrad", (X, Y, C, K, Fw, Fh),
                                    4, stride=s) == FP32_TILES[name]


# ------------------------- the lane arithmetic ------------------------------


LANES = np.arange(32)


def ldmatrix_x4_trans(smem, addrs):
    """``ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16``: lanes 8i..8i+7
    address the 8 rows of sub-matrix i (8 bf16 each, 16-byte aligned);
    lane t receives, in register i, that sub-matrix's column t // 4 at
    rows 2 (t % 4) and 2 (t % 4) + 1.  Returns (4, 32, 2)."""
    assert np.all(addrs % 16 == 0)
    rows = smem[(addrs // 2)[:, None] + np.arange(8)]            # (32, 8)
    r = 8 * np.arange(4)[:, None, None] + 2 * (LANES % 4)[None, :, None] \
        + np.arange(2)[None, None, :]
    return rows[r, (LANES // 4)[None, :, None]]


def mma_16816(acc, a, b0, b1):
    """``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` on one
    warp's fragments (mma_frag.cuh's layouts): acc (32, 4) fp32."""
    g, t2 = LANES // 4, 2 * (LANES % 4)
    A = np.zeros((16, 16), np.float64)
    B = np.zeros((16, 8), np.float64)
    for j in range(2):
        A[g, t2 + j] = a[0, :, j]
        A[g + 8, t2 + j] = a[1, :, j]
        A[g, 8 + t2 + j] = a[2, :, j]
        A[g + 8, 8 + t2 + j] = a[3, :, j]
        B[t2 + j, g] = b0[:, j]
        B[8 + t2 + j, g] = b1[:, j]
    d = (A @ B).astype(np.float32)
    for j in range(2):
        acc[:, j] += d[g, t2 + j]
        acc[:, 2 + j] += d[g + 8, t2 + j]


def emulate_wgrad_mma(x, g, fh, fw, stride, tiles, splits):
    """One launch of ``wgrad_mma`` and ``wgrad_sum`` lane by lane: x (N,
    H, W, C) and g (N, OH, OW, K) float32 holding bf16 values.  Shared
    memory starts as NaN and keeps what earlier pairs staged."""
    bx, by, bc, bk = tiles
    n, H, W, C = x.shape
    _, OH, OW, K = g.shape
    s = stride
    ih, iw = (by - 1) * s + fh, (bx - 1) * s + fw
    pst = CB.pixel_stride(bc, 2)
    bcp = _ceil(bc, 8) * 8
    nch = bcp // 8
    taps, rows = fh * fw, CW.dw_rows(bc, fh, fw)
    P = bx * by
    P16 = _ceil(P, 16) * 16
    gvs, gv = CB.weight_vectors(bk), _ceil(bk, 8)
    in_size = ih * iw * pst
    stage = in_size + P16 * gvs * 8
    wm_n, wn_n, MT, NT = CW.mma_layout(bc, bk, fh, fw)
    assert MT * NT <= CW.MAX_FRAGMENTS
    ntx, nty = _ceil(OW, bx), _ceil(OH, by)
    nsp = ntx * nty
    pairs = n * nsp
    part = np.full((splits, fh, fw, C, K), np.nan, np.float32)

    # the per-block tables (the kernel's registers and its pixel table)
    q = np.minimum(np.arange(P16), P - 1)
    pix_off = ((q // bx) * s * iw + (q % bx) * s) * pst * 2
    a_pix = (LANES & 7) + ((LANES >> 4) << 3)

    def a_off(wm, mt):
        # in 16-byte units, two 16-bit offsets to a register
        q = (wm * MT + mt) * 2 + ((LANES >> 3) & 1)
        tap, cc = q // nch, q % nch
        off = np.where(q < taps * nch,
                       (tap // fw * iw + tap % fw) * (pst // 8) + cc, 0)
        assert off.max() < 1 << 16
        packed = off.astype(np.uint32) << (16 * (mt & 1))
        return ((packed >> (16 * (mt & 1))) & 0xffff) << 4

    def b_vec(wn, j):
        return (LANES & 15) * gvs + np.minimum(wn * NT + 2 * j + (LANES >> 4),
                                               gv - 1)

    for ct in range(_ceil(C, bc)):
        for kt in range(_ceil(K, bk)):
            c0, k0 = ct * bc, kt * bk
            kn = min(bk, K - k0)
            for split in range(splits):
                smem = np.full(2 * stage, np.nan, np.float32)
                acc = np.zeros((CW.WARPS, MT, NT, 32, 4), np.float32)
                q0, q1 = pairs * split // splits, pairs * (split + 1) // splits
                for pq in range(q0, q1):
                    base = ((pq - q0) & 1) * stage
                    img, t = divmod(pq, nsp)
                    ty, tx = divmod(t, ntx)
                    # stage_input: the first nch vectors of each pixel
                    for pix in range(ih * iw):
                        h = ty * by * s + pix // iw
                        w = tx * bx * s + pix % iw
                        for e in range(nch * 8):
                            ok = h < H and w < W and e < bc and c0 + e < C
                            smem[base + pix * pst + e] = \
                                x[img, h, w, c0 + e] if ok else 0.0
                    # the cotangent rows, swizzled; zero past the tile,
                    # the image, bk and K
                    for p in range(P16):
                        oy, ox = ty * by + p // bx, tx * bx + p % bx
                        live = p < P and oy < OH and ox < OW
                        for c in range(gv):
                            dst = base + in_size + 8 * CB.staged_vector(
                                gvs, p * gvs + c)
                            for e in range(8):
                                kk = c * 8 + e
                                smem[dst + e] = g[img, oy, ox, k0 + kk] \
                                    if live and kk < kn else 0.0
                    xs, gs = base * 2, (base + in_size) * 2
                    for warp in range(CW.WARPS):
                        wm, wn = divmod(warp, wn_n)
                        for ks in range(P16 // 16):
                            xk = xs + pix_off[ks * 16 + a_pix]
                            b = [ldmatrix_x4_trans(smem, gs + 16 * np.array(
                                [CB.staged_vector(gvs, L) for L in
                                 ks * 16 * gvs + b_vec(wn, j)]))
                                for j in range((NT + 1) // 2)]
                            for mt in range(MT):
                                a = ldmatrix_x4_trans(smem, xk + a_off(wm, mt))
                                for nt in range(NT):
                                    bj = b[nt // 2]
                                    mma_16816(acc[warp, mt, nt], a,
                                              bj[(nt & 1) * 2],
                                              bj[(nt & 1) * 2 + 1])
                # the masked store
                for warp, mt, nt, e in itertools.product(
                        range(CW.WARPS), range(MT), range(NT), range(4)):
                    wm, wn = divmod(warp, wn_n)
                    r = (wm * MT + mt) * 16 + LANES // 4 + (e // 2) * 8
                    kk = (wn * NT + nt) * 8 + 2 * (LANES % 4) + e % 2
                    tap, cc = r // bcp, r % bcp
                    live = (r < rows) & (cc < bc) & (c0 + cc < C) & (kk < kn)
                    part[split, tap[live] // fw, tap[live] % fw,
                         c0 + cc[live], k0 + kk[live]] = \
                        acc[warp, mt, nt, live, e]
    out = part[0].copy()
    for sp in range(1, splits):
        out += part[sp]
    return out


def bf16_values(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32).bfloat16().float().numpy()


EMULATED = [  # n, h, w, c, k, fh, fw, stride, (bx, by, bc, bk), splits
    # bc = 8 at 11 x 11: an m16 fragment spans two taps; 3 x 3 = 9 pixels
    # a pair, 7 of its 16 slots padding; ragged image edges; two splits
    (1, 14, 14, 8, 16, 11, 11, 1, (3, 3, 8, 16), 2),
    # C = 3 at stride 4 (one chunk, 5 channels padding); K = 24 in tiles
    # of 16 (a ragged 8); three splits over 8 pairs
    (2, 19, 19, 3, 24, 11, 11, 4, (2, 2, 3, 16), 3),
    # stride 2 with a remainder row; C = 20 in tiles of 16 (a ragged 4);
    # bk = 40: five n8 tiles, an odd count (a clamped pair)
    (2, 12, 9, 20, 40, 3, 3, 2, (4, 3, 16, 40), 1),
    # K = 3: one n8 tile, 5 columns clamped; 64 pixels, 4 k-steps
    (1, 10, 10, 16, 3, 3, 3, 1, (8, 8, 16, 3), 1),
    # bk = 64: rows of 8 vectors, XOR-swizzled by the row; 2 x 2 taps
    (1, 9, 9, 8, 64, 2, 2, 1, (8, 8, 8, 64), 2),
    # bk = 32 (4 vectors, swizzled by the 128-byte line); bx = 5 wraps
    # sub-matrices across tile rows
    (2, 8, 8, 16, 32, 3, 3, 1, (5, 4, 16, 32), 2),
]


@pytest.mark.parametrize("n,h,w,c,k,fh,fw,stride,tiles,splits", EMULATED)
def test_emulated_instance_matches_plain_and_jax(n, h, w, c, k, fh, fw,
                                                 stride, tiles, splits):
    rng = np.random.default_rng(h * 100 + k)
    oh, ow = (h - fh) // stride + 1, (w - fw) // stride + 1
    x = bf16_values(rng, (n, h, w, c))
    g = bf16_values(rng, (n, oh, ow, k))
    got = emulate_wgrad_mma(x, g, fh, fw, stride, tiles, splits)
    assert np.all(np.isfinite(got))
    want = CW.conv2d_wgrad_block_ref(torch.tensor(x).bfloat16(),
                                     torch.tensor(g).bfloat16(), fh, fw,
                                     stride).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    tol = 2e-6 * (n * oh * ow) ** 0.5 * scale
    np.testing.assert_allclose(got, want, atol=tol, rtol=1e-5)
    # JAX's block on each image's reachable interior, one tile each
    hr, wr = (oh - 1) * stride + fh, (ow - 1) * stride + fw
    jax_dw = sum(np.asarray(j_wgrad_block(
        jnp.asarray(x[i, :hr, :wr], jnp.bfloat16),
        jnp.asarray(g[i], jnp.bfloat16), bc=c, bk=k, stride=stride,
        interpret=True)) for i in range(n))
    np.testing.assert_allclose(got, jax_dw, atol=tol, rtol=1e-5)


# ------------------------------ the bank groups -----------------------------


def a_bank_ways(bx, by, bc, s, fh=3, fw=3):
    """The most rows of one A sub-matrix (8 consecutive pixel slots of a
    k-step at one chunk) that share a 16-byte bank group, over the pair's
    k-steps."""
    iw = (bx - 1) * s + fw
    pstv = CB.pixel_stride(bc, 2) // 8
    P = bx * by
    slots = np.minimum(np.arange(_ceil(P, 16) * 16), P - 1)
    vec = ((slots // bx) * s * iw + (slots % bx) * s) * pstv
    ways = 1
    for p0 in range(0, len(slots), 8):
        live = slots[p0:p0 + 8]
        groups = vec[p0:p0 + 8][np.r_[True, live[1:] != live[:-1]]] % 8
        ways = max(ways, int(np.bincount(groups).max()))
    return ways


@pytest.mark.parametrize("bx,by,bc,s,ways", [
    (32, 16, 8, 1, 1),     # Conv1's tile: 8 pixels of one tile row
    (8, 28, 32, 1, 1),     # Conv4's: 5 vectors a pixel, odd
    (14, 14, 32, 1, 2),    # Conv5's: a sub-matrix wraps a tile row
    (32, 16, 8, 2, 2),     # an even stride pairs the rows
    (11, 11, 3, 4, 4),     # AlexNet conv1's stride 4: 4-way
])
def test_a_staging_bank_groups(bx, by, bc, s, ways):
    assert a_bank_ways(bx, by, bc, s) == ways


@pytest.mark.parametrize("bk", [3, 8, 16, 24, 32, 40, 48, 64, 96, 128])
def test_b_staging_bank_groups(bk):
    """The 8 cotangent rows of every B sub-matrix (8 consecutive pixels
    from a multiple of 8, one column of 8 channels) fall into 8 bank
    groups, and the swizzle permutes the staged vectors."""
    v, gv = CB.weight_vectors(bk), _ceil(bk, 8)
    for r0 in range(0, 64, 8):
        for c in range(gv):
            assert len({CB.staged_vector(v, (r0 + j) * v + c) % 8
                        for j in range(8)}) == 8
    assert sorted(CB.staged_vector(v, L) for L in range(64 * v)) == \
        list(range(64 * v))


# ------------------------------ the launch ----------------------------------


class FakeStream:
    cuda_stream = 0


class Props:
    shared_memory_per_block_optin = H100_SXM.smem_optin_bytes
    multi_processor_count = H100_SXM.sms


class Sched:
    def __init__(self, tiles):
        self.tiles = tiles


@pytest.fixture
def fake_card(monkeypatch):
    """``_build.load`` returning a C function that records its arguments
    and reports success (nothing is built or launched), and meta tensors
    standing in for CUDA ones (the operand check is the card's)."""
    calls = []

    def load(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (symbol, len(args))
            calls.append((symbol, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: FakeStream())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props())
    monkeypatch.setattr(CW, "_check_operands", lambda x, g: None)
    return calls


@pytest.mark.parametrize("dtype,dims,stride", [
    (torch.bfloat16, (256, 256, 256, 384, 11, 11), 1),
    (torch.bfloat16, (56, 56, 128, 256, 3, 3), 1),
    (torch.bfloat16, (55, 55, 3, 96, 11, 11), 4),
    (torch.float32, (56, 56, 128, 256, 3, 3), 1),
])
def test_wgrad_launches_best_schedules_tiles(monkeypatch, fake_card, dtype,
                                             dims, stride, tmp_path):
    """``conv2d_wgrad`` asks ``best_schedule`` for the forward's dims at
    its stride and launches the model's tiles; the wrapper records the
    instance: the warp grid in bf16, the groups a thread holds in fp32."""
    import repro_torch.tune as tune
    X, Y, C, K, Fw, Fh = dims
    name = str(dtype).removeprefix("torch.")
    tiles = best_schedule("conv2d_wgrad", dims, name, stride=stride,
                          cache=ScheduleCache(str(tmp_path / "s.json"))).tiles
    asked = []

    def best(op, d, dtype_name, stride=1):
        asked.append((op, d, dtype_name, stride))
        return Sched(tiles)
    monkeypatch.setattr(tune, "best_schedule", best)
    n = 2
    h, w = (Y - 1) * stride + Fh, (X - 1) * stride + Fw
    x = torch.empty((n, h, w, C), dtype=dtype, device="meta")
    g = torch.empty((n, Y, X, K), dtype=dtype, device="meta")
    dw = CW.conv2d_wgrad(x, g, Fh, Fw, stride)
    assert dw.shape == (Fh, Fw, C, K) and dw.dtype == torch.float32
    assert asked == [("conv2d_wgrad", dims, name, stride)]
    (symbol, args), = fake_card
    assert symbol == "conv2d_wgrad"
    assert args[0] == (1 if dtype == torch.bfloat16 else 0)
    assert args[5:13] == (n, h, w, C, K, Fh, Fw, stride)
    assert args[13:17] == tiles
    bx, by, bc, bk = tiles
    assert args[17] == CW.splits_for(_ceil(C, bc) * _ceil(K, bk),
                                     n * _ceil(X, bx) * _ceil(Y, by),
                                     H100_SXM.sms)
    if dtype == torch.bfloat16:
        assert CW.conv2d_wgrad_block.instance == \
            ("mma", CW.mma_layout(bc, bk, Fh, Fw))
    else:
        assert CW.conv2d_wgrad_block.instance == \
            ("fma", CW.fma_rows(bc, bk, Fh, Fw))


def test_refusals(fake_card):
    """A bf16 dW tile no warp grid holds within 64 sums a thread, one past
    512 columns, staged tiles over the card's shared memory, and tiles
    under one: each raises before a launch."""
    x = torch.empty((1, 40, 40, 64), dtype=torch.bfloat16, device="meta")
    g = torch.empty((1, 30, 30, 600), dtype=torch.bfloat16, device="meta")
    g3 = torch.empty((1, 38, 38, 600), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="accumulators"):
        CW.conv2d_wgrad_block(x, g, 11, 11, bx=8, by=8, bc=16, bk=16)
    with pytest.raises(ValueError, match="accumulators"):
        CW.conv2d_wgrad_block(x, g, 11, 11, bx=8, by=8, bc=8, bk=520)
    with pytest.raises(ValueError, match="shared memory"):
        CW.conv2d_wgrad_block(x, g3, 3, 3, bx=38, by=38, bc=64, bk=16)
    with pytest.raises(ValueError, match="positive"):
        CW.conv2d_wgrad_block(x, g, 11, 11, bx=0, by=8, bc=8, bk=16)
    assert fake_card == []
    CW.conv2d_wgrad_block(x, g, 11, 11, bx=8, by=8, bc=8, bk=16)
    assert CW.conv2d_wgrad_block.instance == ("mma", (8, 1, 8, 2))
    assert len(fake_card) == 1


def test_cpu_tensors_take_the_plain_version(fake_card):
    rng = np.random.default_rng(0)
    x = torch.tensor(bf16_values(rng, (1, 6, 6, 4))).bfloat16()
    g = torch.tensor(bf16_values(rng, (1, 4, 4, 8))).bfloat16()
    assert torch.equal(
        CW.conv2d_wgrad_block(x, g, 3, 3, bx=4, by=4, bc=8, bk=16),
        CW.conv2d_wgrad_block_ref(x, g, 3, 3))
    assert fake_card == []
