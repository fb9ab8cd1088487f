"""The wide query groups of glm4-9b (Hkv 2, G 16) and granite-34b (MQA,
G 48) at head_dim 128: what the host decides for kernel rows 3
(``flash_decode_oproj``) and 11 (``qkv_fused``) there.

* Row 3 runs the query heads in chunks (``oproj_head_chunk``) so that a
  chunk's fp32 attention rows fit the two-block budget beside the wo
  ring: the footprint fits at G 16 and 48 for B 1 to 20, and the fused
  page is chosen for both archs.  Each chunk is a partial of its own on
  the grid (``oproj_chunks``), so the wide groups fill the card.  The
  chunked launch's arithmetic is
  emulated in ``test_torch_oproj.py`` (cases at G 16 and 48), where the
  wrapper's arguments are checked too; here the plain version at G 48
  against JAX's ``paged_attention_oproj_ref``.
* Row 11's fp32 tile core takes bn below 64 where the joint (G + 2) bn
  tile would overflow its accumulators: ``best_schedule`` returns a
  tile at G 16 and 48 that the core holds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import \
    paged_attention_oproj_ref as j_oproj_ref
from repro_torch.configs import get_config
from repro_torch.core.hopper_adapter import H100_SXM, default_smem_budget
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import matmul_blocked as MB
from repro_torch.kernels import qkv_fused as QF
from repro_torch.serve.kv_cache import choose_page_size
from repro_torch.tune import best_schedule

WIDE = ("glm4-9b", "granite-34b")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_seq", [512, 4352])
@pytest.mark.parametrize("arch", WIDE)
def test_fused_page_for_wide_groups(arch, max_seq, dtype):
    """``choose_page_size(fused=True)`` returns a whole-page divisor of
    max_seq whose oproj footprint fits the budget (it raised before the
    head chunks), the same page as the unfused key's here."""
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    g = cfg.n_heads // cfg.n_kv_heads
    page = choose_page_size(cfg, max_seq, fused=True)
    assert max_seq % page == 0
    assert FD.oproj_smem_bytes_required(page, g, cfg.head_dim,
                                        dtype.itemsize) \
        <= default_smem_budget()
    assert page == choose_page_size(cfg, max_seq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [16, 48])
def test_oproj_footprint_fits_for_every_batch(g, dtype):
    """At page 32 (the fused page at max_seq 512) and D 128, every batch
    from 1 to 20 rows fits the two-block budget: the chunk is 8 query
    heads up to 8 rows (8 row slots), 4 above (16 slots); a chunk is a
    whole number of warps' rows; the passes cover G."""
    for b in range(1, 21):
        chunk = FD.oproj_head_chunk(g, 128, b)
        assert chunk == (8 if b <= 8 else 4)
        assert chunk % FD.ROWS_PER_BLOCK == 0 and chunk < g
        need = FD.oproj_smem_bytes_required(32, g, 128, dtype.itemsize,
                                            batch=b)
        assert need <= default_smem_budget()
        rows = FD.oproj_group_rows(b) + 1
        assert need == max(FD.smem_bytes_required(32, 4, 128,
                                                  dtype.itemsize),
                           FD.OPROJ_WO_STAGES * FD.OPROJ_STEP_BYTES) + \
            (rows * 128 + 2) * chunk * 4


@pytest.mark.parametrize("g,d,b,chunk", [
    (4, 128, 8, 4), (4, 128, 20, 4),     # granite-3-8b: one pass
    (2, 256, 8, 2), (8, 256, 8, 4),      # gemma2-9b; a wide head dim
    (16, 16, 20, 16), (48, 16, 20, 44),  # narrow heads: most at once
    (3, 256, 20, 2),                     # fewer fit than a warp's rows
    (16, 256, 8, 4), (16, 256, 20, 2),   # recurrentgemma-9b's local layers
])
def test_head_chunk_rule(g, d, b, chunk):
    """All G where they fit, else the most that do in whole warps' rows;
    where not one warp's rows fit beside the ring (D 256 in 16-row
    groups), the most heads that do.  Every chunk's footprint is within
    the two-block budget."""
    assert FD.oproj_head_chunk(g, d, b) == chunk
    assert FD.oproj_smem_bytes_required(0, g, d, 2, batch=b) \
        <= default_smem_budget()


def test_oproj_hbm_bytes_count_a_workspace_pass_per_chunk():
    """Each chunk writes its partial to the workspace and the head sum
    reads it back: granite-34b's decode (B 8, G 48 in 6 chunks of 8)
    moves q, K and V once per cluster of slices, wo once, the (6, 8,
    6144) fp32 workspace out and back, and out."""
    b, g, d, e, seq, page = 8, 48, 128, 6144, 512, 32
    _, n, c = FD.oproj_grid(1, e, 6)
    assert FD.oproj_head_chunk(g, d, b) == 8
    assert FD.oproj_chunks(g, d, b) == 6
    want = (b * g * d * 2 + 2 * b * (seq // page) * page * d * 2 * (n // c)
            + g * d * e * 2 + 2 * 6 * b * e * 4 + b * e * 2)
    assert FD.oproj_hbm_bytes(b, 1, g, d, e, seq, page) == want


@pytest.mark.parametrize("hkv,g,e,b,chunks,grid", [
    (2, 16, 4096, 1, 2, (128, 32, 16)),     # glm4-9b: 128 blocks
    (2, 16, 4096, 8, 2, (128, 32, 16)),
    (2, 16, 4096, 20, 4, (256, 16, 16)),    # 128 blocks
    (1, 48, 6144, 8, 6, (256, 24, 12)),     # granite-34b: 144 blocks
    (1, 48, 6144, 20, 12, (256, 24, 12)),   # 288 blocks
    (8, 4, 4096, 8, 1, (256, 16, 16)),      # granite-3-8b: one chunk
])
def test_oproj_grid_spreads_the_chunks(hkv, g, e, b, chunks, grid):
    """The chunks of a kv head are partials side by side on the grid:
    Hkv x chunks partials by the slices, the slice picked so that they
    reach ``OPROJ_BLOCKS`` (one chunk: the grid of one pass)."""
    assert FD.oproj_chunks(g, 128, b) == chunks
    assert FD.oproj_grid(hkv, e, chunks) == grid
    width, n, _ = grid
    assert hkv * chunks * n >= FD.OPROJ_BLOCKS
    if chunks == 1:
        assert FD.oproj_grid(hkv, e) == grid


@pytest.mark.parametrize("window,cap", [(None, None), (11, 20.0)])
def test_plain_oproj_at_g48_matches_jax(window, cap):
    """The plain row 3 at granite-34b's grouping (Hkv 1, G 48; D 16 to
    stay small), ragged lengths, against JAX's
    ``paged_attention_oproj_ref`` within 1e-5 abs + 1e-5 rel (fp32 sums
    over 768 rows in another order)."""
    rng = np.random.default_rng(48)
    b, hkv, g, d, e, page, nb = 3, 1, 48, 16, 96, 8, 4
    lengths = np.array([1, 17, 32], np.int32)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((b * nb + 1, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((b * nb + 1, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb).reshape(b, nb)).astype(np.int32)
    wo = (rng.standard_normal((hkv, g * d, e))
          / (g * d) ** 0.5).astype(np.float32)
    arrs = (q, kp, vp, bt, lengths, wo)
    kw = dict(window=window, logit_cap=cap)
    got = FD.paged_attention_oproj_ref(*map(torch.from_numpy, arrs), **kw)
    want = np.asarray(j_oproj_ref(*map(jnp.asarray, arrs), **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dims", [(8, 128, 6144, 48), (8, 256, 4096, 16),
                                  (1, 128, 6144, 48), (20, 256, 4096, 16),
                                  (512, 128, 6144, 48),
                                  (4064, 256, 4096, 16)])
def test_fp32_qkv_tile_at_wide_groups(dims):
    """``best_schedule("qkv_fused", ..., "float32")`` returns a tile at G
    16 and 48 (it raised: no bn of 64 fits the joint tile), bn a divisor
    of Nkv in multiples of 4 below 64, the joint (bm, (G+2) bn) tile
    within the tile core's accumulators and the two-block budget; bf16
    keeps its instances' tiles."""
    m, nkv, k, g = dims
    bm, bk, bn = best_schedule("qkv_fused", dims, "float32").tiles
    assert bn < H100_SXM.nk_mult and bn % 4 == 0 and nkv % bn == 0
    assert QF.joint_cols(bn, g) <= 4 * MB.THREADS
    assert QF.accumulators_per_thread(bm, bn, g, 4) <= H100_SXM.acc_per_thread
    assert QF.smem_bytes_required(bm, bk, bn, g, 4) <= default_smem_budget()
    assert best_schedule("qkv_fused", dims, "bfloat16").tiles[2] >= 32
