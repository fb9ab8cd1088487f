"""Kernel rows 1-5 at every head dim the reference registers, and row 3
at more kv heads, on the CPU.

* The guards: a head dim that is a multiple of 16 from 16 to 256 is
  taken (16, 80, 96 and 256 beside 64 and 128), 24 and 272 are refused;
  each runs the compiled width ``instance_head_dim`` picks, and shared
  memory and registers are priced at that width.
* The tiles: ``flash_tiles`` and the decode pages fit every pass at every
  head dim (the dk/dv pass sweeps twice at 256), and the tensor-core
  tiles' swizzle spreads 8 rows over 8 bank groups at every width.
* The plain versions at head dims 16, 80, 96 and 256 against JAX's
  Pallas kernels in interpret mode: paged decode and chunked prefill,
  the attention forward and its backward, the oproj-fused decode; the
  oproj-fused decode's plain version at Hkv 16 and 32 (seamless-m4t-
  medium's and phi-3-vision's kv heads) too, and the cluster a head's
  E slices form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jbwd
from repro_torch.core.hopper_adapter import (H100_SXM, default_smem_budget,
                                             flash_decode_tile_candidates,
                                             flash_tiles)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FB
from repro_torch.kernels import flash_decode as FD

TOL = dict(atol=1e-5, rtol=1e-5)
HEAD_DIMS = (16, 80, 96, 256)


@pytest.mark.parametrize("d,width", [(16, 32), (32, 32), (48, 64),
                                     (64, 64), (80, 128), (96, 128),
                                     (128, 128), (144, 256), (256, 256)])
def test_guards_take_multiples_of_16_up_to_256(d, width):
    assert FA.check_head_dim(d) == d
    assert FA.instance_head_dim(d) == width


@pytest.mark.parametrize("d", [24, 272, 8, 100])
def test_guards_refuse_other_head_dims(d):
    with pytest.raises(ValueError, match="multiples of 16"):
        FA.check_head_dim(d)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_footprints_are_priced_at_the_instance_width(d):
    """A head dim shares its instance's shared-memory footprint: the
    staged rows are the instance's width, the columns past d zero."""
    w = FA.instance_head_dim(d)
    assert FD.smem_bytes_required(32, 4, d) == FD.smem_bytes_required(32, 4,
                                                                      w)
    for fn in (FA.fwd_smem_bytes, FB.dq_smem_bytes, FB.dkv_smem_bytes):
        for esz in (2, 4):
            assert fn(32, 32, d, esz) == fn(32, 32, w, esz)
    # oproj's attention rows are kept at the true head dim, 16 row slots
    # (8 up to 8 batch rows), one head chunk's heads (at D 256 in 16 slots
    # not one warp's 4 heads fit the two-block budget beside the ring:
    # chunks of 2); the wo ring overlays the tiles
    tiles = max(FD.smem_bytes_required(32, 4, w), 4 * 16384)
    chunk = 2 if d == 256 else 4
    assert FD.oproj_head_chunk(4, d) == chunk
    assert FD.oproj_smem_bytes_required(32, 4, d) == \
        tiles + (17 * d + 2) * chunk * 4
    assert FD.oproj_smem_bytes_required(32, 4, d, batch=8) == \
        tiles + (9 * 4 * d + 8) * 4


@pytest.mark.parametrize("d", HEAD_DIMS + (64, 128))
@pytest.mark.parametrize("seq", [16, 100, 512])
def test_flash_tiles_fit_every_pass(d, seq):
    """bf16: both tiles on the warp grid, every pass's shared memory in
    the two-block budget and its fp32 sums within 160 a thread (at D =
    256 the forward reads q from shared memory, the dk/dv pass sweeps
    dv then dk); fp32: the opt-in shared memory of one block."""
    budget = default_smem_budget()
    bq, bkv = flash_tiles(seq, seq, d, 2)
    assert {bq, bkv} <= set(FA.MMA_TILES)
    for fn in (FA.fwd_smem_bytes, FB.dq_smem_bytes, FB.dkv_smem_bytes):
        assert fn(bq, bkv, d, 2) <= budget
    for fn in (FA.fwd_accumulators, FB.dq_accumulators,
               FB.dkv_accumulators):
        assert fn(bq, bkv, d) <= H100_SXM.attn_acc_per_thread
    wide = FA.instance_head_dim(d) == 256
    assert FB.dkv_sweeps(d) == (2 if wide else 1)
    assert FA.fwd_q_in_registers(d) == (not wide)
    assert FB.dkv_sub_rows(bq, d) == min(bq, 16 if wide else 32)
    bq, bkv = flash_tiles(seq, seq, d, 4)
    for fn in (FA.fwd_smem_bytes, FB.dq_smem_bytes, FB.dkv_smem_bytes):
        assert fn(bq, bkv, d, 4) <= H100_SXM.smem_optin_bytes


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("esz,kv", [(2, None), (4, None), (2, 1)])
def test_decode_pages_fit_every_head_dim(d, esz, kv):
    """The page candidates fit the two-block budget at the instance's
    width, dropping below one key per lane only where they must (D = 256
    in fp32: 16 keys)."""
    budget = default_smem_budget()
    pages = flash_decode_tile_candidates(4, 512, d, esz, kv_bytes=kv)
    assert pages
    for (page,) in pages:
        assert 512 % page == 0
        assert FD.smem_bytes_required(page, 4, d, esz, kv) <= budget
    if (d, esz, kv) == (256, 4, None):
        assert pages == ((16,),)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_attention_swizzle_spreads_rows_over_bank_groups(d):
    """The tensor-core attention tiles (``attn_mma::swz``): each row's
    chunks are a permutation, and the 8 rows an ldmatrix sub-matrix reads
    at one chunk (rows 8i .. 8i + 7) fall in 8 bank groups; at D = 32 a
    row is four chunks and the swizzle follows the 128-byte line."""
    cpr = d // 8
    for r in range(64):
        assert sorted(FA.chunk_at(d, r, c) - r * cpr for c in range(cpr)) \
            == list(range(cpr))
    for r0 in range(0, 64, 8):
        for c in range(cpr):
            assert len({FA.chunk_at(d, r0 + r, c) % 8 for r in range(8)}) \
                == 8


# ------------------------------ plain versions vs JAX -----------------------


def paged_case(d, q_span, hkv=2, g=2, page=8, nb=6, seed=0):
    rng = np.random.default_rng(seed + d)
    lengths = np.array([1, 9, 30], np.int32)
    b = len(lengths)
    n_pages = b * nb + 1
    q = rng.standard_normal((b, hkv, q_span * g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    for i, n in enumerate(lengths):
        bt[i, -(-(n + q_span - 1) // page):] = 0
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("q_span,window", [(1, None), (3, 5)])
def test_plain_paged_attention_matches_jax(d, q_span, window):
    arrs = paged_case(d, q_span)
    kw = dict(window=window, logit_cap=None, q_span=q_span)
    port = FD.flash_decode(*map(torch.from_numpy, arrs), **kw).numpy()
    kernel = np.asarray(jfd.flash_decode(*map(jnp.asarray, arrs),
                                         interpret=True, **kw))
    np.testing.assert_allclose(port, kernel, **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 6),
                                           (False, None)])
def test_plain_flash_attention_and_backward_match_jax(d, causal, window):
    """Forward, lse and (dq, dk, dv) of one head at head dim d."""
    rng = np.random.default_rng(d)
    sq = skv = 24
    q, k, v, g = (rng.standard_normal((n, d)).astype(np.float32)
                  for n in (sq, skv, skv, sq))
    kw = dict(causal=causal, window=window, logit_cap=None)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, block_q=8, block_kv=8,
                                interpret=True, return_lse=True, **kw)
    want = jbwd(jq, jk, jv, o, lse, jg, block_q=8, block_kv=8,
                interpret=True, **kw)
    head = lambda a: torch.from_numpy(np.array(a))[None, :, None]  # noqa
    tq, tk, tv, tg = map(head, (q, k, v, g))
    np.testing.assert_allclose(
        FA.flash_attention(tq, tk, tv, **kw)[0, :, 0].numpy(),
        np.asarray(o), **TOL)
    t_lse = FA.flash_attention_lse_ref(tq, tk, **kw)
    np.testing.assert_allclose(t_lse[0, 0].numpy(), np.asarray(lse)[:, 0],
                               **TOL)
    got = FB.flash_attention_bwd(tq, tk, tv, head(o), t_lse, tg, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[0, :, 0].numpy(), np.asarray(b),
                                   atol=1e-4, rtol=1e-4)


def oproj_case(hkv, g, d, e, seed=6, page=8, nb=4):
    rng = np.random.default_rng(seed + hkv + d)
    lengths = np.array([1, 13, 32], np.int32)
    b = len(lengths)
    n_pages = b * nb + 1
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb).reshape(b, nb)).astype(np.int32)
    wo = (rng.standard_normal((hkv, g * d, e))
          * (hkv * g * d) ** -0.5).astype(np.float32)
    return q, kp, vp, bt, lengths, wo


@pytest.mark.parametrize("hkv,g,d,e", [(2, 2, 16, 40), (2, 2, 80, 40),
                                       (2, 1, 96, 32), (1, 2, 256, 24),
                                       (16, 1, 16, 32), (32, 1, 16, 48)])
def test_plain_oproj_matches_jax(hkv, g, d, e):
    """The oproj-fused decode's plain version at off-instance head dims
    and at Hkv 16 and 32 against JAX's kernel in interpret mode, fp32."""
    arrs = oproj_case(hkv, g, d, e)
    port = FD.flash_decode_oproj(*map(torch.from_numpy, arrs),
                                 window=9).numpy()
    kernel = np.asarray(jfd.flash_decode_oproj(*map(jnp.asarray, arrs),
                                               window=9, interpret=True))
    np.testing.assert_allclose(port, kernel, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,c", [(1, 1), (4, 4), (7, 7), (8, 8), (12, 12),
                                 (16, 16), (17, 1), (32, 16), (40, 10)])
def test_oproj_cluster_is_the_largest_divisor_up_to_16(n, c):
    """A head's cluster: c blocks, the largest divisor of its slice
    count n that is at most H100's non-portable 16, so a head's slices
    are whole clusters; at Hkv 16 and 32 (E 1024 and 3072) the grid's
    clusters are 8 and 12 blocks."""
    assert FD.MAX_CLUSTER == 16
    assert FD.oproj_cluster(n) == c
    assert n % c == 0
    assert FD.oproj_grid(16, 1024)[2] == 8
    assert FD.oproj_grid(32, 3072)[2] == 12
