"""The bf16 tensor-core instances of the forward GEMM
(``csrc/gemm_mma_inst.cuh``: ``mma_kernel``, M > 16, and
``mma_t_kernel``, M <= 16) that rows 9 (``matmul_fused``), 10
(``matmul_w8``) and 11 (``qkv_fused``) run, their tiles and footprints,
on the CPU.

* The lane arithmetic: a numpy emulation of each instance lane by lane
  over a per-block weight source and a store map -- the staging into
  NaN-filled shared memory (it is not initialised on the card) with
  ``gemm_mma::Tile``'s swizzle, an int8 weight staged raw and widened
  into the swizzled bf16 tile, the fragment addressing (``ldmatrix`` for
  A's rows, ``ldmatrix.trans`` for W's, ``.x2`` for an odd n8 count; in
  the transposed instance the other way round), ``mma.sync`` m16n8k16
  with fp32 sums, the warps' split of the k16 steps and their sum in
  warp order, the swapped (token, column) store through the map --
  against JAX's Pallas kernels in interpret mode and the plain
  versions: row 9 wide and int8 with its fused epilogue, row 11's
  segment-major QKV grid (``QkvBlocks``: G 1, 2 and 4, ragged Nkv), row
  10's scale-only int8 store (``W8Map``: per-channel and per-tensor).
* The tiles: the ``"matmul"`` candidates and fp32 ``"matmul_w8"`` ones
  at granite's projections are pinned as they were, bf16
  ``"matmul_w8"`` at row 9's int8 tiles; the fused, QKV and int8 keys'
  decode tiles fill the card; the bf16 candidates above 16 rows fit the
  ``mma`` instance that runs them.
* The footprints mirror the ``.cu``'s ``mma_smem`` / ``mma_t_smem``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_blocked import matmul_blocked as j_matmul_blocked
from repro.kernels.matmul_fused import matmul_fused as j_matmul_fused
from repro.kernels.matmul_q import matmul_w8 as j_matmul_w8
from repro.kernels.qkv_fused import qkv_fused as j_qkv_fused
from repro_torch.core.hopper_adapter import (H100_SXM, MAX_EMPTY_ROWS,
                                             decode_smem_limit,
                                             default_smem_budget, fused_fits,
                                             matmul_tile_candidates,
                                             qkv_fits)
from repro_torch.kernels import matmul_blocked as MB
from repro_torch.kernels import matmul_fused as MF
from repro_torch.kernels import matmul_q as MQ
from repro_torch.kernels import qkv_fused as QF
from repro_torch.kernels.matmul_bwd import (chunk_at, empty_row_share,
                                            mma_layout, staged_chunks)
from repro_torch.tune import OpSpec, best_schedule, candidates, fits_smem

LANES = np.arange(32)
WARPS = 8


def _ceil(a, b):
    return -(-a // b)


# ------------------------------ the lane arithmetic -------------------------


def ldmatrix(smem, addrs, trans, n=4):
    """``ldmatrix.sync.aligned.m8n8.x{n}[.trans].shared.b16``: lanes
    8i..8i+7 address the rows of sub-matrix i (8 bf16 each, 16-byte
    aligned; with n = 2 lanes 0-15 alone); lane t receives in register i
    that sub-matrix's row t // 4 at columns 2 (t % 4) and 2 (t % 4) + 1,
    or with ``trans`` its column t // 4 at rows 2 (t % 4), 2 (t % 4) + 1.
    Returns (n, 32, 2)."""
    addrs = np.asarray(addrs)
    assert np.all(addrs[:8 * n] % 16 == 0)
    rows = smem[(addrs[:8 * n] // 2)[:, None] + np.arange(8)]     # (8n, 8)
    lo = 8 * np.arange(n)[:, None, None]
    j = np.arange(2)[None, None, :]
    if trans:
        return rows[lo + 2 * (LANES % 4)[None, :, None] + j,
                    (LANES // 4)[None, :, None]]
    return rows[lo + (LANES // 4)[None, :, None],
                2 * (LANES % 4)[None, :, None] + j]


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


def swz(w, r):
    """``Tile(w).swz(r)``."""
    _, shift, mask = staged_chunks(w)
    return (r >> shift) & mask


def stage_rows(data, r_ok, c_ok, rows, w):
    """A staged tile of ``rows`` rows of ``w`` chunks from ``data`` (rows
    x columns, bf16 values as fp32), zero past ``r_ok`` rows and ``c_ok``
    columns, NaN in the chunks no row owns (an odd ``ld``'s pad)."""
    ld = staged_chunks(w)[0]
    t = np.full(rows * ld * 8, np.nan, np.float32)
    for r in range(rows):
        for c in range(w):
            base = chunk_at(w, r, c) * 8
            for e in range(8):
                col = c * 8 + e
                t[base + e] = data[r, col] if r < r_ok and col < c_ok else 0.0
    return t


def stage_w(w, k0, k_ok, n0, n_ok, bkp, bn, w8):
    """One step of W as the kernel leaves it for the fragments: a wide W
    staged straight into the swizzled bf16 tile; an int8 W staged raw,
    ``bn / 16`` 16-byte chunks a row (zero past the step and N), then
    widened chunk by chunk into chunks 2c and 2c + 1 of the swizzled
    tile (exact: |q| <= 127 is a bf16)."""
    tww = _ceil(bn, 8)
    block = np.zeros((bkp, tww * 8), np.float32)
    sub = w[k0:k0 + k_ok, n0:n0 + n_ok].astype(np.float32)
    if not w8:
        block[:k_ok, :n_ok] = sub
        return stage_rows(block, k_ok, n_ok, bkp, tww)
    raw = np.zeros((bkp, bn), np.int8)
    raw[:k_ok, :n_ok] = w[k0:k0 + k_ok, n0:n0 + n_ok]
    ld = staged_chunks(tww)[0]
    t = np.full(bkp * ld * 8, np.nan, np.float32)
    for r in range(bkp):
        for c in range(bn // 16):
            vals = raw[r, 16 * c:16 * c + 16].astype(np.float32)
            assert np.all(torch.tensor(vals).bfloat16().float().numpy()
                          == vals)
            t[chunk_at(tww, r, 2 * c) * 8 + np.arange(8)] = vals[:8]
            t[chunk_at(tww, r, 2 * c + 1) * 8 + np.arange(8)] = vals[8:]
    return t


def epilogue(y, col, row, scale, bias, mul, res, act):
    """``FusedMap::store`` in fp32: scale, bias, activation, mul,
    residual (before the cast)."""
    y = np.float32(y)
    if scale is not None:
        y = np.float32(y * scale[col])
    if bias is not None:
        y = np.float32(y + bias[col])
    if act == "relu":
        y = np.float32(max(y, 0.0))
    elif act == "gelu":
        c = np.float32(0.7978845608028654)
        y = np.float32(0.5 * y * (1.0 + np.tanh(c * (y + 0.044715 * y ** 3))))
    elif act == "silu":
        y = np.float32(y / (1.0 + np.exp(-y)))
    if mul is not None:
        y = np.float32(y * mul[row, col])
    if res is not None:
        y = np.float32(y + res[row, col])
    return y


def one_w(w, bn):
    """``OneW``: the column blocks of one weight matrix, each (segment 0,
    the matrix, its first column, its columns in range)."""
    n = w.shape[1]
    return [(0, w, n0, min(bn, n - n0)) for n0 in range(0, n, bn)]


def qkv_blocks(wq, wk, wv, bn):
    """``QkvBlocks``: the segment-major grid -- the q blocks, then the k
    blocks, then the v blocks, each of one projection's matrix."""
    return [blk for seg, w in enumerate((wq, wk, wv))
            for blk in [(seg, *b[1:]) for b in one_w(w, bn)]]


def fused_map(out, epi):
    """``FusedMap::store``: the fused epilogue at (row, col)."""
    def store(seg, row, col, acc):
        out[row, col] = epilogue(acc, col, row, **epi)
    return store


def w8_map(out, scale):
    """``W8Map::store``: the per-column scale once, in fp32."""
    def store(seg, row, col, acc):
        out[row, col] = np.float32(np.float32(acc) * scale[col])
    return store


def qkv_map(outs):
    """``QkvBlocks::store``: the sum into the block's own projection."""
    def store(seg, row, col, acc):
        outs[seg][row, col] = acc
    return store


def emulate_mma(a, blocks, tiles, w8, store):
    """One launch of ``mma_kernel`` (M > 16) block by block, warp by
    warp, lane by lane: column block x of ``blocks`` (the per-block
    weight source: segment, matrix, first column, columns in range) and
    row block y; ``store(segment, row, column, sum)`` is the map."""
    M, K = a.shape
    bm, bk, bn = tiles
    bkp = _ceil(bk, 16) * 16
    txw, tww = bkp // 8, _ceil(bn, 8)
    tx_ld, tw_ld = staged_chunks(txw)[0], staged_chunks(tww)[0]
    wm_n, wn_n, MT, NT = mma_layout(bm, bn)
    NP = (NT + 1) // 2
    for m0, (seg, w, n0, n_ok) in itertools.product(range(0, M, bm),
                                                    blocks):
        m_ok = min(bm, M - m0)
        acc = np.zeros((WARPS, MT, NT, 32, 4), np.float32)
        for k0 in range(0, K, bk):
            k_ok = min(bk, K - k0)
            xa = np.zeros((bm, txw * 8), np.float32)
            xa[:m_ok, :k_ok] = a[m0:m0 + m_ok, k0:k0 + k_ok]
            xs = stage_rows(xa, m_ok, k_ok, bm, txw)
            ws = stage_w(w, k0, k_ok, n0, n_ok, bkp, bn, w8)
            for warp in range(WARPS):
                wm, wn = divmod(warp, wn_n)
                for ks in range(bkp // 16):
                    b = []
                    for j in range(NP):
                        i = LANES >> 3
                        kb = (LANES & 7) + ((i & 1) << 3)
                        c = np.minimum(wn * NT + 2 * j + (i >> 1), tww - 1)
                        b_off = kb * tw_ld + (c ^ swz(tww, kb))
                        addr = ks * 16 * tw_ld + b_off
                        # the swizzle of row 16 ks + kb is that of kb
                        assert np.all(addr == chunk_at(tww, 16 * ks + kb, c))
                        x2 = NT % 2 == 1 and j == NP - 1
                        bj = ldmatrix(ws, addr * 16, True, 2 if x2 else 4)
                        b.append(bj)
                    for mt in range(MT):
                        r = np.minimum((wm * MT + mt) * 16 + (LANES & 15),
                                       bm - 1)
                        a_x = (LANES >> 4) ^ swz(txw, r)
                        addr = r * tx_ld + ((2 * ks) ^ a_x)
                        af = ldmatrix(xs, addr * 16, False)
                        for nt in range(NT):
                            bj = b[nt // 2]
                            mma_16816(acc[warp, mt, nt], af,
                                      bj[(nt & 1) * 2], bj[(nt & 1) * 2 + 1])
        for warp, mt, nt, e in itertools.product(
                range(WARPS), range(MT), range(NT), range(4)):
            wm, wn = divmod(warp, wn_n)
            for lane in range(32):
                r = (wm * MT + mt) * 16 + lane // 4 + (e // 2) * 8
                c = (wn * NT + nt) * 8 + 2 * (lane % 4) + e % 2
                if r < m_ok and c < n_ok:
                    store(seg, m0 + r, n0 + c, acc[warp, mt, nt, lane, e])


def emulate_mma_t(a, blocks, bk, bn, w8, store):
    """One launch of ``mma_t_kernel`` (M <= 16): Y^T = W^T . A^T over the
    column blocks of ``blocks``, the 8 warps on k16 steps w, w + 8, ...
    of each step, their sums added in warp order, the (column, token)
    fragments stored to (token, column) through ``store``."""
    M, K = a.shape
    assert M <= MF.MMA_T_ROWS and bn in MF.MMA_T_COLS
    NT, MT = MF.token_tiles(M), bn // 16
    XR = 8 * NT
    bkp = _ceil(bk, 16) * 16
    txw, tww = bkp // 8, bn // 8
    tx_ld, tw_ld = staged_chunks(txw)[0], staged_chunks(tww)[0]
    for seg, w, n0, n_ok in blocks:
        acc = np.zeros((WARPS, MT, NT, 32, 4), np.float32)
        for k0 in range(0, K, bk):
            k_ok = min(bk, K - k0)
            xa = np.zeros((XR, txw * 8), np.float32)
            xa[:M, :k_ok] = a[:, k0:k0 + k_ok]
            xs = stage_rows(xa, M, k_ok, XR, txw)
            ws = stage_w(w, k0, k_ok, n0, n_ok, bkp, bn, w8)
            for warp in range(WARPS):
                for ks in range(warp, bkp // 16, WARPS):
                    rb = (LANES & 7) + (((LANES >> 4) << 3) if NT == 2 else 0)
                    b_x = ((LANES >> 3) & 1) ^ swz(txw, rb)
                    addr = rb * tx_ld + ((2 * ks) ^ b_x)
                    bf = ldmatrix(xs, addr * 16, False, 2 * NT)
                    i = LANES >> 3
                    ka = (LANES & 7) + ((i >> 1) << 3)
                    for mt in range(MT):
                        a_off = ka * tw_ld + ((2 * mt + (i & 1)) ^ swz(tww,
                                                                     ka))
                        af = ldmatrix(ws, (ks * 16 * tw_ld + a_off) * 16,
                                      True)
                        for nt in range(NT):
                            mma_16816(acc[warp, mt, nt], af, bf[2 * nt],
                                      bf[2 * nt + 1])
        total = acc[0].copy()
        for warp in range(1, WARPS):
            total += acc[warp]
        for mt, nt, e, lane in itertools.product(range(MT), range(NT),
                                                 range(4), range(32)):
            col = mt * 16 + (lane >> 2) + 8 * (e >> 1)
            tok = nt * 8 + 2 * (lane & 3) + (e & 1)
            if tok < M and col < n_ok:
                store(seg, tok, n0 + col, total[mt, nt, lane, e])


def emulate(a, blocks, tiles, w8, store):
    """The launch of the instance a bf16 wrapper picks for ``a``'s M."""
    if MF.instance_kind(torch.bfloat16, a.shape[0]) == "mma_t":
        emulate_mma_t(a, blocks, tiles[1], tiles[2], w8, store)
    else:
        emulate_mma(a, blocks, tiles, w8, store)


def bf16_values(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32).bfloat16().float().numpy()


EMULATED = [  # M, N, K, (bm, bk, bn), int8, act, jax tiles
    # mma_t: 8 tokens (one n8 tile), bn 32, two steps of 4 k16 steps:
    # warps 4-7 idle on each step
    (8, 64, 128, (8, 64, 32), False, "silu", (8, 64, 32)),
    # mma_t: 13 tokens (two n8 tiles, 3 empty slots), ragged K, ragged N
    # (the last block's 24 of 32 columns), bn 32
    (13, 88, 200, (13, 128, 32), False, "gelu", None),
    # mma_t int8: 3 tokens, bn 16 (one m16 tile), K = 64 in two steps
    (3, 48, 64, (3, 32, 16), True, "none", (3, 32, 16)),
    # mma_t int8: 16 tokens, bn 64 (four m16 tiles)
    (16, 64, 96, (16, 96, 64), True, "relu", (16, 96, 64)),
    # mma: 40 rows in tiles of 32 (a ragged 8), bn 48 (six n8 tiles on
    # the warp grid, an odd pair loaded by x2.trans where the layout has
    # an odd nt), ragged K
    (40, 48, 72, (32, 32, 48), False, "gelu", None),
    # mma int8: 32 x 64 tile, two steps
    (32, 64, 64, (32, 32, 64), True, "silu", (32, 32, 64)),
    # mma: bm 16 (one m16 tile), bn 8 (one n8 tile: x2.trans), ragged K
    (24, 8, 40, (16, 32, 8), False, "none", None),
    # mma_t: N = 20, not a multiple of 8 (the scalar staging path): the
    # second block's 4 of 16 columns end inside a chunk
    (5, 20, 48, (5, 48, 16), False, "silu", None),
    # mma: N = 20 in one bn 24 tile (three n8 tiles, the last partial);
    # warps 3-7 read the clamped last chunk and store nothing
    (24, 20, 40, (16, 32, 24), False, "relu", None),
]


@pytest.mark.parametrize("m,n,k,tiles,w8,act,jtiles", EMULATED)
def test_emulated_instance_matches_jax_and_plain(m, n, k, tiles, w8, act,
                                                 jtiles):
    """The emulated launch of the instance the wrapper picks for ``m``
    equals the plain version and JAX's Pallas kernel in interpret mode
    (where the tiles divide) to bf16 output rounding, with every
    epilogue operand on."""
    rng = np.random.default_rng(m * 1000 + n + k)
    a = bf16_values(rng, (m, k))
    if w8:
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        scale = (rng.uniform(0.5, 1.5, n) * k ** -0.5 / 64).astype(np.float32)
    else:
        w = bf16_values(rng, (k, n), k ** -0.5)
        scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    mul = bf16_values(rng, (m, n))
    res = bf16_values(rng, (m, n))
    epi = dict(scale=scale, bias=bias, mul=mul, res=res, act=act)
    got = np.full((m, n), np.nan, np.float32)
    emulate(a, one_w(w, tiles[2]), tiles, w8, fused_map(got, epi))
    got = torch.tensor(got).bfloat16().float().numpy()
    assert np.all(np.isfinite(got))
    t = torch.tensor
    want = MF.matmul_fused_ref(
        t(a).bfloat16(), t(w) if w8 else t(w).bfloat16(), t(scale),
        t(bias), t(mul).bfloat16(), t(res).bfloat16(),
        act=act).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    if jtiles is not None:
        bm, bk, bn = jtiles
        jw = jnp.asarray(w) if w8 else jnp.asarray(w, jnp.bfloat16)
        jax_y = np.asarray(j_matmul_fused(
            jnp.asarray(a, jnp.bfloat16), jw, jnp.asarray(scale),
            jnp.asarray(bias), jnp.asarray(mul, jnp.bfloat16),
            jnp.asarray(res, jnp.bfloat16), act=act, bm=bm, bk=bk, bn=bn,
            interpret=True)).astype(np.float32)
        np.testing.assert_allclose(got, jax_y, atol=2e-2, rtol=1e-2)


def test_staged_chunk_rows_hit_eight_bank_groups():
    """Each instance's ldmatrix reads 8 rows at one logical chunk: in the
    staged tiles the model picks (x: bk / 8 chunks a row; W: bn / 8) those
    rows fall in 8 distinct 16-byte bank groups."""
    for w in (2, 4, 8, 16, 32, 64):
        for r0 in range(0, 64, 8):
            for c in range(w):
                groups = {chunk_at(w, r0 + r, c) % 8 for r in range(8)}
                assert len(groups) == 8, (w, r0, c)


# ------------------------------ tiles and footprints ------------------------


GRANITE_NK = ((4096, 4096), (1024, 4096), (12800, 4096), (4096, 12800))

# the candidates of rows 6 ("matmul") and 10 ("matmul_w8") at granite's
# projections: their fp32 ones as they were before the fused key had a
# footprint of its own (the tile core's); their bf16 ones those of row
# 9's tensor-core instances, which both run -- row 6 wide, row 10 with
# its int8 weight (at decode one tile whose column blocks fill the card;
# above 16 rows row 6's equal the tile core's, now snapped to the "mma"
# instance):
# (key, M, N, K, bytes per element) -> (bm, bk, bn) in rank order
PINNED = {
    ("matmul", 8, 1024, 4096, 2): ((8, 512, 16),),
    ("matmul", 8, 1024, 4096, 4): ((8, 128, 64), (8, 64, 64), (8, 64, 128)),
    ("matmul", 8, 4096, 4096, 2): ((8, 256, 32),),
    ("matmul", 8, 4096, 4096, 4): ((8, 128, 64), (8, 64, 128)),
    ("matmul", 8, 4096, 12800, 2): ((8, 256, 32),),
    ("matmul", 8, 4096, 12800, 4): ((8, 64, 128), (8, 128, 64)),
    ("matmul", 8, 12800, 4096, 2): ((8, 128, 64),),
    ("matmul", 8, 12800, 4096, 4): ((8, 128, 64), (8, 64, 128)),
    ("matmul", 512, 1024, 4096, 2): ((16, 64, 64), (256, 64, 64),
                                     (16, 256, 64), (128, 64, 128)),
    ("matmul", 512, 1024, 4096, 4): ((16, 64, 64), (128, 64, 64),
                                     (16, 128, 64), (64, 64, 128)),
    ("matmul", 512, 4096, 4096, 2): ((16, 64, 64), (256, 64, 64),
                                     (16, 256, 64), (128, 64, 128)),
    ("matmul", 512, 4096, 4096, 4): ((16, 128, 64), (64, 64, 64),
                                     (64, 64, 128)),
    ("matmul", 512, 4096, 12800, 2): ((16, 64, 64), (256, 64, 64),
                                      (16, 320, 64), (128, 64, 128)),
    ("matmul", 512, 4096, 12800, 4): ((16, 128, 64), (64, 64, 64),
                                      (64, 64, 128)),
    ("matmul", 512, 12800, 4096, 2): ((16, 64, 64), (256, 64, 64),
                                      (16, 128, 128), (16, 256, 64),
                                      (128, 64, 128)),
    ("matmul", 512, 12800, 4096, 4): ((16, 128, 64), (16, 64, 128),
                                      (64, 64, 64), (64, 64, 128)),
    ("matmul_w8", 8, 1024, 4096, 2): ((8, 512, 16),),
    ("matmul_w8", 8, 1024, 4096, 4): ((8, 512, 64), (8, 64, 64),
                                      (8, 64, 128)),
    ("matmul_w8", 8, 4096, 4096, 2): ((8, 512, 32),),
    ("matmul_w8", 8, 4096, 4096, 4): ((8, 512, 64), (8, 64, 512),
                                      (8, 64, 128)),
    ("matmul_w8", 8, 4096, 12800, 2): ((8, 512, 32),),
    ("matmul_w8", 8, 4096, 12800, 4): ((8, 64, 512), (8, 320, 64),
                                       (8, 64, 128)),
    ("matmul_w8", 8, 12800, 4096, 2): ((8, 256, 64),),
    ("matmul_w8", 8, 12800, 4096, 4): ((8, 512, 64), (8, 64, 128)),
    ("matmul_w8", 512, 1024, 4096, 2): ((16, 64, 64), (256, 64, 64),
                                        (128, 64, 128)),
    ("matmul_w8", 512, 1024, 4096, 4): ((16, 64, 512), (16, 256, 64),
                                        (128, 64, 128)),
    ("matmul_w8", 512, 4096, 4096, 2): ((16, 64, 64), (256, 64, 64),
                                        (16, 256, 64), (128, 64, 128)),
    ("matmul_w8", 512, 4096, 4096, 4): ((16, 256, 128), (16, 256, 64),
                                        (128, 64, 64), (128, 64, 128)),
    ("matmul_w8", 512, 4096, 12800, 2): ((16, 128, 128), (128, 64, 128),
                                         (64, 64, 256), (64, 128, 64)),
    ("matmul_w8", 512, 4096, 12800, 4): ((16, 128, 128), (128, 64, 128)),
    ("matmul_w8", 512, 12800, 4096, 2): ((16, 128, 128), (16, 128, 64),
                                         (256, 64, 64), (16, 256, 64),
                                         (128, 64, 128)),
    ("matmul_w8", 512, 12800, 4096, 4): ((16, 256, 128), (16, 256, 64),
                                         (128, 64, 64), (128, 64, 128)),
}


@pytest.mark.parametrize("key", sorted(PINNED), ids=str)
def test_rows_6_and_10_take_the_instances(key):
    """fp32 rows 6 and 10 keep the tile core's candidates; in bf16 both
    take row 9's instances' (the ``"matmul"`` and ``"matmul_w8"`` keys
    snap as ``"matmul_fused"`` and ``"matmul_fused_w8"`` do,
    ``fused=True``; in fp32 the flag changes nothing), and each key's
    ranked schedules are drawn from these tiles."""
    op, m, n, k, esz = key
    w8 = op == "matmul_w8"
    assert matmul_tile_candidates(m, n, k, esz, w_bytes=1 if w8 else None,
                                  fused=True) == PINNED[key]
    if esz == 4:
        assert matmul_tile_candidates(m, n, k, esz, w_bytes=1 if w8
                                      else None) == PINNED[key]
    dn = "bfloat16" if esz == 2 else "float32"
    got = {s.tiles for s in candidates(OpSpec(op, (m, n, k), dn))}
    assert got and got <= set(PINNED[key])


@pytest.mark.parametrize("op", ["matmul_fused", "matmul_fused_w8"])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_decode_tiles_fill_the_card(op, m):
    """At M <= 16 the fused keys hold one tile for the transposed
    instance: bm = M, bn of ``MMA_T_COLS`` with at least
    ``DECODE_BLOCKS`` column blocks at granite's N (4096: 32, 128 blocks;
    12800: 64, 200), every stage of W within ``DECODE_W_BYTES``, the
    footprint within the two-block budget, or the opt-in of one block
    where the column blocks are one wave."""
    for n, k in GRANITE_NK:
        tiles = best_schedule(op, (m, n, k), "bfloat16").tiles
        bm, bk, bn = tiles
        assert bm == m and bn in MF.MMA_T_COLS
        assert _ceil(n, bn) >= MF.DECODE_BLOCKS >= _ceil(n, 2 * bn) \
            or bn == min(MF.MMA_T_COLS)
        w_bytes = 1 if op == "matmul_fused_w8" else 2
        assert MF.MMA_T_STAGES * bk * bn * w_bytes <= MF.DECODE_W_BYTES
        limit = decode_smem_limit(n, bn, default_smem_budget())
        assert limit == (H100_SXM.smem_optin_bytes if _ceil(n, bn) <= 132
                         else default_smem_budget())
        assert MF.smem_bytes_required(bm, bk, bn, 2, w_bytes, m=m) <= limit
        assert fused_fits(m, bm, bk, bn, 2, default_smem_budget(),
                          w_bytes=1 if w_bytes == 1 else None, N=n)
    assert best_schedule(op, (8, 4096, 12800), "bfloat16").tiles[2] == 32
    assert best_schedule(op, (8, 12800, 4096), "bfloat16").tiles[2] == 64
    # the int8 down projection, one wave: 25 steps of 512, not 50 of 256
    if op == "matmul_fused_w8":
        assert best_schedule(op, (8, 4096, 12800), "bfloat16").tiles[1] \
            == 512


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("m", [24, 512, 2048])
def test_mma_candidates_fit_the_instance(m, w8):
    """Every bf16 fused candidate above 16 rows sits on the ``"mma"``
    instance's warp grid with at most ``MAX_EMPTY_ROWS`` of its computed
    rows empty, 64 sums a thread, and its stages within the budget."""
    budget = default_smem_budget()
    for n, k in GRANITE_NK:
        cands = matmul_tile_candidates(m, n, k, 2, w_bytes=1 if w8 else None,
                                       fused=True)
        assert cands
        for bm, bk, bn in cands:
            assert mma_layout(bm, bn) is not None
            assert empty_row_share(bm, bn) <= MAX_EMPTY_ROWS
            assert MF.accumulators_per_thread(bm, bn, 2, m=m) \
                <= H100_SXM.acc_per_thread
            assert MF.smem_bytes_required(bm, bk, bn, 2,
                                          1 if w8 else None, m=m) <= budget


def test_footprints_mirror_the_kernel():
    """``smem_bytes_required`` at the tiles phase 8 times: the csrc
    ``mma_t_smem`` / ``mma_smem`` arithmetic (stages of A rows and W, the
    widened tile of an int8 W, the warp sums of ``mma_t``)."""
    # mma_t, 8 tokens, bk 256, bn 32, 4 stages: x 8 x 32 chunks, W 256 x
    # 4 chunks (Tile(4): ld 4) a stage
    assert MF.smem_bytes_required(8, 256, 32, 2, m=8) == \
        4 * (8 * 32 + 256 * 4) * 16 == 81920
    # the same, int8: W raw 256 x 2 chunks a stage, one widened 256 x 4
    assert MF.smem_bytes_required(8, 256, 32, 2, 1, m=8) == \
        (4 * (8 * 32 + 256 * 2) + 256 * 4) * 16 == 65536
    # 16 tokens, bn 128, bk 16: the warp sums (8 x 8 x 2 x 128 fp32) are
    # the larger
    assert MF.smem_bytes_required(16, 16, 128, 2, m=16) == 8 * 8 * 2 * 128 * 4
    # mma at (128, 64, 128), 3 stages: 128 x 8 (Tile(8): ld 8) + 64 x 16
    assert MF.mma_stages(128, 64, 128) == 3
    assert MF.smem_bytes_required(128, 64, 128, 2) == \
        3 * (128 * 8 + 64 * 16) * 16 == 98304
    # a chunk count that is neither odd nor a power of two pads its rows
    # by one chunk (w = 6: ld 7)
    assert staged_chunks(6)[0] == 7
    assert MF.smem_bytes_required(32, 48, 48, 2, stages=2) == \
        2 * (32 * 7 + 48 * 7) * 16
    # fp32 is the blocked GEMM's footprint
    assert MF.smem_bytes_required(64, 64, 128, 4) == \
        2 * (64 * 64 + 64 * 128) * 4


def test_instance_kinds_and_refusals():
    """fp32 runs "fma", bf16 "mma_t" up to 16 rows and "mma" above;
    ``check_tiles`` refuses what the instances do not hold."""
    assert MF.instance_kind(torch.float32, 8) == "fma"
    assert MF.instance_kind(torch.bfloat16, 16) == "mma_t"
    assert MF.instance_kind(torch.bfloat16, 17) == "mma"
    optin = H100_SXM.smem_optin_bytes
    assert MF.check_tiles(torch.bfloat16, 8, (8, 256, 32), False,
                          optin) == MF.MMA_T_STAGES
    assert MF.check_tiles(torch.bfloat16, 512, (128, 64, 128), True,
                          optin) == MF.mma_stages(128, 64, 128, 1) == 3
    assert MF.check_tiles(torch.float32, 8, (8, 64, 64), False, optin) == 2
    with pytest.raises(ValueError, match="transposed"):
        MF.check_tiles(torch.bfloat16, 8, (8, 256, 48), False, optin)
    with pytest.raises(ValueError, match="warp grid"):
        MF.check_tiles(torch.bfloat16, 512, (512, 64, 256), False, optin)
    with pytest.raises(ValueError, match="shared memory"):
        MF.check_tiles(torch.bfloat16, 8, (8, 4096, 128), False, optin)
    assert MF.instance(torch.bfloat16, 8, 8, 32, 4) == ("mma_t", (2, 1), 4)
    assert MF.instance(torch.bfloat16, 512, 128, 128, 3) == \
        ("mma", (4, 2, 2, 8), 3)


# ------------------------- rows 10 and 11 on the same instances -------------


QKV_EMULATED = [  # M, Nkv, K, G, (bm, bk, bn), jax tiles
    # mma_t: 8 tokens, G 4: 8 q blocks of 16, then 2 k and 2 v blocks
    (8, 32, 64, 4, (8, 64, 16), (8, 32, 16)),
    # mma_t: 13 tokens (two n8 tiles), G 2, ragged Nkv (24: the last k
    # and v blocks hold 8 of 16 columns), ragged K (72 = 48 + 24)
    (13, 24, 72, 2, (13, 48, 16), None),
    # mma_t: one token, G 1, Nkv 40 in blocks of 32 (a ragged 8)
    (1, 40, 40, 1, (1, 32, 32), None),
    # mma: 24 rows in tiles of 16 (a ragged 8), G 2
    (24, 32, 64, 2, (16, 32, 32), (8, 32, 16)),
    # mma: bn 48 (six n8 tiles) over Nkv 48, G 1, ragged M and K
    (40, 48, 40, 1, (32, 32, 48), None),
    # mma: Nkv 20, not a multiple of 8 (the scalar staging path), G 4
    (20, 20, 40, 4, (16, 32, 24), None),
]


@pytest.mark.parametrize("m,nkv,k,g,tiles,jtiles", QKV_EMULATED)
def test_emulated_qkv_matches_jax_and_plain(m, nkv, k, g, tiles, jtiles):
    """Row 11's bf16 launch (``QkvBlocks``: the segment-major grid, each
    block reading its own projection's weight and storing into its own
    output) emulated lane by lane on the instance the wrapper picks for
    ``m``, against the plain version and JAX's Pallas kernel in
    interpret mode (where the tiles divide) to bf16 output rounding
    (atol 2e-2, rtol 1e-2); every output element is stored once."""
    rng = np.random.default_rng(m * 100 + nkv + k + g)
    a = bf16_values(rng, (m, k))
    ws = [bf16_values(rng, (k, c), k ** -0.5) for c in (g * nkv, nkv, nkv)]
    blocks = qkv_blocks(*ws, tiles[2])
    assert len(blocks) == QF.blocks(nkv, g, tiles[2])
    outs = [np.full((m, w.shape[1]), np.nan, np.float32) for w in ws]
    emulate(a, blocks, tiles, False, qkv_map(outs))
    t = torch.tensor
    want = QF.qkv_fused_ref(t(a).bfloat16(), *[t(w).bfloat16() for w in ws])
    jax_out = None
    if jtiles is not None:
        bm, bk, bn = jtiles
        jax_out = j_qkv_fused(jnp.asarray(a, jnp.bfloat16),
                              *[jnp.asarray(w, jnp.bfloat16) for w in ws],
                              bm=bm, bk=bk, bn=bn, interpret=True)
    for i, got in enumerate(outs):
        assert np.all(np.isfinite(got))
        got = t(got).bfloat16().float().numpy()
        np.testing.assert_allclose(got, want[i].float().numpy(), atol=2e-2,
                                   rtol=1e-2)
        if jax_out is not None:
            np.testing.assert_allclose(
                got, np.asarray(jax_out[i]).astype(np.float32), atol=2e-2,
                rtol=1e-2)


W8_EMULATED = [  # M, N, K, (bm, bk, bn), per-channel, jax tiles
    # mma_t: 8 tokens, bn 32, two steps
    (8, 64, 96, (8, 64, 32), True, (8, 32, 32)),
    # mma_t: 13 tokens (two n8 tiles), bn 16, ragged K, per-tensor
    (13, 48, 70, (13, 64, 16), False, None),
    # mma_t: one token, bn 64 over N 96 (a ragged 32)
    (1, 96, 64, (1, 32, 64), True, None),
    # mma: a 16 x 64 tile over 24 rows, per-tensor
    (24, 64, 64, (16, 32, 64), False, (8, 32, 64)),
    # mma: 32 x 48 tiles over 40 rows, ragged K
    (40, 48, 72, (32, 32, 48), True, None),
]


@pytest.mark.parametrize("m,n,k,tiles,per_channel,jtiles", W8_EMULATED)
def test_emulated_w8_matches_jax_and_plain(m, n, k, tiles, per_channel,
                                           jtiles):
    """Row 10's bf16 launch (one int8 matrix, ``OneW``; the scale-only
    ``W8Map`` store: the scale once in fp32, then one cast) emulated lane
    by lane, the int8 rows staged raw and widened, against the plain
    version and JAX's Pallas kernel in interpret mode (where the tiles
    divide) to bf16 output rounding, per-channel and per-tensor."""
    rng = np.random.default_rng(m * 100 + n + k)
    a = bf16_values(rng, (m, k))
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, n if per_channel else 1)
             * k ** -0.5 / 64).astype(np.float32)
    row = np.broadcast_to(scale, (n,))       # the wrapper's fp32 row
    got = np.full((m, n), np.nan, np.float32)
    emulate(a, one_w(w, tiles[2]), tiles, True, w8_map(got, row))
    assert np.all(np.isfinite(got))
    got = torch.tensor(got).bfloat16().float().numpy()
    t = torch.tensor
    s_in = t(scale) if per_channel else t(scale[0])
    want = MQ.matmul_w8_ref(t(a).bfloat16(), t(w), s_in).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    if jtiles is not None:
        bm, bk, bn = jtiles
        jax_y = np.asarray(j_matmul_w8(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(w),
            jnp.asarray(scale if per_channel else scale[0]), bm=bm, bk=bk,
            bn=bn, interpret=True)).astype(np.float32)
        np.testing.assert_allclose(got, jax_y, atol=2e-2, rtol=1e-2)


def blocked_map(out):
    """``BlockedMap::store`` (row 6): the fp32 sum as it is, cast once by
    the caller."""
    def store(seg, row, col, acc):
        out[row, col] = acc
    return store


BLOCKED_EMULATED = [  # M, N, K, (bm, bk, bn), jax tiles
    # mma_t: one token, bn 16, three steps
    (1, 32, 48, (1, 16, 16), (1, 16, 16)),
    # mma_t: 8 tokens (one n8 tile), bn 32, two steps of 4 k16 steps
    (8, 64, 128, (8, 64, 32), (8, 64, 32)),
    # mma_t: 16 tokens (two full n8 tiles), bn 16, one step of 96
    (16, 48, 96, (16, 96, 16), (16, 32, 16)),
    # mma: 17 rows (a ragged row block of 1), ragged K (72 = 2 x 32 + 8)
    # and N (40 = 24 + 16: the second block's last n8 tile partial)
    (17, 40, 72, (16, 32, 24), None),
    # mma: a 512-token span, four row blocks of 128 (8 warps down)
    (512, 16, 32, (128, 32, 16), (128, 32, 16)),
    # mma_t: 13 tokens, ragged K and N (the last block 24 of 32 columns)
    (13, 88, 200, (13, 128, 32), None),
    # N = 20, not a multiple of 8 (the scalar staging path), both
    # instances
    (5, 20, 48, (5, 48, 16), None),
    (24, 20, 40, (16, 32, 24), None),
]


@pytest.mark.parametrize("m,n,k,tiles,jtiles", BLOCKED_EMULATED)
def test_emulated_blocked_matches_jax_and_plain(m, n, k, tiles, jtiles):
    """Row 6's bf16 launch, emulated lane by lane on the instance the
    wrapper picks for ``m`` (``mma_t`` up to 16 rows, ``mma`` above) over
    one weight matrix with ``BlockedMap``'s plain store, equals
    ``matmul_ref`` and JAX's ``matmul_blocked`` in interpret mode (where
    the tiles divide) to bf16 output rounding (2e-2 abs + 1e-2 rel: the
    fp32 sums differ only in order, the outputs O(1) by B's K ** -0.5)."""
    rng = np.random.default_rng(m * 1000 + n + k + 6)
    a = bf16_values(rng, (m, k))
    w = bf16_values(rng, (k, n), k ** -0.5)
    got = np.full((m, n), np.nan, np.float32)
    emulate(a, one_w(w, tiles[2]), tiles, False, blocked_map(got))
    assert np.all(np.isfinite(got))
    got = torch.tensor(got).bfloat16().float().numpy()
    want = MB.matmul_ref(torch.tensor(a).bfloat16(),
                         torch.tensor(w).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    if jtiles is not None:
        bm, bk, bn = jtiles
        jax_y = np.asarray(j_matmul_blocked(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            bm=bm, bk=bk, bn=bn, interpret=True)).astype(np.float32)
        np.testing.assert_allclose(got, jax_y, atol=2e-2, rtol=1e-2)


class _Props:
    shared_memory_per_block_optin = H100_SXM.smem_optin_bytes


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,m,tiles,symbol,instance", [
    (torch.bfloat16, 8, (8, 256, 32), "matmul_blocked_fwd",
     ("mma_t", (2, 1), MF.MMA_T_STAGES)),
    (torch.bfloat16, 16, (16, 512, 16), "matmul_blocked_fwd",
     ("mma_t", (1, 2), MF.MMA_T_STAGES)),
    (torch.bfloat16, 17, (16, 64, 64), "matmul_blocked_mma_fwd",
     ("mma", (1, 8, 1, 1), 3)),
    (torch.bfloat16, 512, (128, 64, 128), "matmul_blocked_mma_fwd",
     ("mma", (4, 2, 2, 8), 3)),
    (torch.float32, 64, (16, 128, 64), "matmul_blocked_fwd",
     ("fma", 1, 2)),
])
def test_blocked_launches_the_instance(monkeypatch, dtype, m, tiles, symbol,
                                       instance):
    """``ops.matmul`` asks the ``"matmul"`` key and launches its tiles on
    the instance ``instance_kind`` names (the ``"mma"`` one from its own
    library), at the instance's stages, and records it in
    ``matmul_blocked.instance``; bf16 tiles are checked against the
    instance, not the tile core (the loader monkeypatched, meta tensors:
    no card)."""
    from repro_torch.kernels import _build, ops
    calls, asked = [], []

    def load(name, sym, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((name, sym, args))
            return 0
        return fn

    def best(op, dims, dtype_name):
        asked.append((op, dims, dtype_name))
        return type("S", (), {"tiles": tiles})()
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: _Props())
    monkeypatch.setattr(MB, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ops, "best_schedule", best)
    n, k = 96, 80
    a = torch.zeros((m, k), dtype=dtype, device="meta")
    b = torch.zeros((k, n), dtype=dtype, device="meta")
    with torch.no_grad():
        assert ops.matmul(a, b).shape == (m, n)
    name = str(dtype).removeprefix("torch.")
    assert asked == [("matmul", (m, n, k), name)]
    (lib, sym, args), = calls
    assert sym == symbol and lib == symbol.removesuffix("_fwd")
    assert args[0] == (1 if dtype == torch.bfloat16 else 0)
    assert args[4:7] == (m, n, k) and args[7:10] == tiles
    assert args[10] == instance[2]
    assert MB.matmul_blocked.instance == instance
    if dtype == torch.bfloat16:   # tiles off the instance raise
        bad = (m, 64, 256) if m <= 16 else (512, 64, 256)
        with pytest.raises(ValueError, match="transposed|warp grid"):
            MB.matmul_blocked(a, b, bm=bad[0], bk=bad[1], bn=bad[2])
        assert len(calls) == 1


def test_qkv_and_w8_footprints_mirror_the_kernel():
    """Rows 10 and 11 in bf16 have row 9's footprint (``mma_smem`` /
    ``mma_t_smem``) at one projection's (bm, bk, bn) tile; in fp32 the
    tile core's (row 11 at its joint width)."""
    # row 11's decode tile: mma_t, 8 tokens, 4 stages of 8 x 32 and 256 x
    # 4 chunks; 192 segment-major blocks at granite's Nkv 1024, G 4
    assert QF.smem_bytes_required(8, 256, 32, 4, 2, m=8) == \
        MF.smem_bytes_required(8, 256, 32, 2, m=8) == 81920
    assert QF.blocks(1024, 4, 32) == 128 + 32 + 32
    assert QF.blocks(96, 1, 64) == 2 + 2 + 2          # ragged Nkv
    assert QF.accumulators_per_thread(8, 32, 4, 2, m=8) == 4 * 2 * 1
    # mma at (128, 64, 128): the warp grid's 2 x 8 fragments
    assert QF.smem_bytes_required(128, 64, 128, 4, 2) == 98304
    assert QF.accumulators_per_thread(128, 128, 4, 2, m=512) == 64
    # fp32: the tile core at the joint (G + 2) * bn width
    assert QF.smem_bytes_required(8, 32, 64, 4, 4) == \
        MB.smem_bytes_required(8, 32, 6 * 64, 4) == 2 * (8 * 32 + 32 * 384) * 4
    assert QF.accumulators_per_thread(8, 64, 4, 4) == \
        MB.accumulators_per_thread(8, 384)
    # row 10's decode tile: mma_t int8, 4 stages of 8 x 64 chunks of A and
    # 512 x 2 raw chunks of W, one widened 512 x 4 tile
    assert MQ.smem_bytes_required(8, 512, 32, 2, 1, m=8) == \
        (4 * (8 * 64 + 512 * 2) + 512 * 4) * 16 == 131072
    assert MQ.smem_bytes_required(128, 64, 128, 2, 1) == \
        MF.smem_bytes_required(128, 64, 128, 2, 1)
    assert MQ.smem_bytes_required(8, 64, 512, 4, 1) == \
        MB.smem_bytes_required(8, 64, 512, 4, 1)


@pytest.mark.parametrize("m", [1, 8, 16])
def test_qkv_and_w8_decode_tiles_fill_the_card(m):
    """At M <= 16 the ``"qkv_fused"`` key holds one tile for the
    transposed instance: at granite's (Nkv 1024, G 4) bn 32, whose 192
    segment-major blocks reach ``DECODE_BLOCKS`` (bn 64 would give 96),
    bk 256 (4 stages of 32 bf16 columns: ``DECODE_W_BYTES``); at the
    reduced granite's (Nkv 32, G 2) the narrowest bn dividing Nkv.  The
    ``"matmul_w8"`` key takes ``"matmul_fused_w8"``'s tile at each of
    granite's projections."""
    budget = default_smem_budget()
    bm, bk, bn = best_schedule("qkv_fused", (m, 1024, 4096, 4),
                               "bfloat16").tiles
    assert (bm, bk, bn) == (m, 256, 32)
    assert QF.blocks(1024, 4, bn) >= MF.DECODE_BLOCKS > QF.blocks(1024, 4,
                                                                  2 * bn)
    assert MF.MMA_T_STAGES * bk * bn * 2 <= MF.DECODE_W_BYTES
    assert QF.smem_bytes_required(bm, bk, bn, 4, 2, m=m) <= budget
    assert best_schedule("qkv_fused", (m, 32, 64, 2), "bfloat16").tiles == \
        (m, 64, 16)
    for n, k in GRANITE_NK:
        tiles = best_schedule("matmul_w8", (m, n, k), "bfloat16").tiles
        assert tiles == best_schedule("matmul_fused_w8", (m, n, k),
                                      "bfloat16").tiles
        bm, bk, bn = tiles
        assert bm == m and bn in MF.MMA_T_COLS
        assert _ceil(n, bn) >= MF.DECODE_BLOCKS or bn == min(MF.MMA_T_COLS)
        assert MQ.smem_bytes_required(bm, bk, bn, 2, 1, m=m) <= \
            decode_smem_limit(n, bn, budget)


@pytest.mark.parametrize("op", ["qkv_fused", "matmul_w8"])
@pytest.mark.parametrize("m", [24, 512, 2048])
def test_qkv_and_w8_mma_candidates_fit_the_instance(op, m):
    """Every bf16 candidate of the two keys above 16 rows sits on the
    ``"mma"`` instance's warp grid with at most ``MAX_EMPTY_ROWS`` of its
    computed rows empty, 64 sums a thread and its stages within the
    budget; row 11's bn divides Nkv (no block straddles a projection
    boundary inside a segment) and at most Nkv."""
    budget = default_smem_budget()
    shapes = ([(1024, 4096, 4)] if op == "qkv_fused" else GRANITE_NK)
    for dims in shapes:
        cands = candidates(OpSpec(op, (m, *dims), "bfloat16"))
        assert cands
        for sched in cands:
            bm, bk, bn = sched.tiles
            assert mma_layout(bm, bn) is not None
            assert empty_row_share(bm, bn) <= MAX_EMPTY_ROWS
            assert MF.accumulators_per_thread(bm, bn, 2, m=m) \
                <= H100_SXM.acc_per_thread
            if op == "qkv_fused":
                assert dims[0] % bn == 0
                assert QF.smem_bytes_required(bm, bk, bn, 4, 2, m=m) <= budget
            else:
                assert MQ.smem_bytes_required(bm, bk, bn, 2, 1, m=m) <= budget


def test_qkv_and_w8_footprint_checks_refuse():
    """The two keys' footprint checks refuse what row 9's instances do
    not hold: a transposed-instance bn off ``MMA_T_COLS``, an mma tile
    off the warp grid; row 11's fp32 tile core keeps its joint-width
    cap."""
    budget = default_smem_budget()
    assert not qkv_fits(8, 8, 64, 48, 4, 2, budget)
    assert qkv_fits(8, 8, 256, 32, 4, 2, budget, Nkv=1024)
    assert not qkv_fits(512, 512, 64, 256, 4, 2, budget)
    assert not qkv_fits(8, 8, 64, 256, 4, 4, 10 ** 9)  # 1536 joint columns
    w8 = OpSpec("matmul_w8", (8, 4096, 4096), "bfloat16")
    assert not fits_smem(w8, (8, 64, 48), budget)
    assert fits_smem(w8, (8, 512, 32), budget)
