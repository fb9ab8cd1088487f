"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where only PyTorch and the CUDA toolkit are
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA device.  Gradients (the training
path's kernels) sum up to Sq * G terms in another order than their plain
versions: fp32 within 1e-4 of the largest |value| (at least 1e-4) and
1e-3 rel, bf16 within 1e-2 of the largest |value| and 1e-2 rel.
Tolerances of the forward kernels: fp32 differs from
the plain version only in summation order (1e-5 abs / 1e-4 rel); bf16
rounds the fp32 result to bf16 once, so the two may differ by one bf16
ulp of an O(1) value (2e-2 abs / 1e-2 rel); the attention kernels' bf16
instances also round P (and in the backward dS) to bf16 before their
products, a relative 2^-9 per term that averages out in the sums
(tests/test_torch_attn_tiles.py holds that rounding to these gates).  GEMM operands are scaled by
K ** -0.5 so every output is O(1); an fp32 GEMM sums K terms in another
order than the plain version, so its abs tolerance is 2e-6 * sqrt(K) (a
random walk of fp32 roundings, with margin).  The conv forward (row 12)
is held as a GEMM of C * Fh * Fw terms, weights scaled by that count **
-0.5; the wgrad (row 13) as a gradient (fp32 sums from the same inputs
in either dtype).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.conv2d_blocked import (conv2d_block,
                                                conv2d_blocked_ref)
from repro_torch.kernels.conv2d_bwd import (conv2d_wgrad_block,
                                            conv2d_wgrad_block_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd,
                                                     flash_attention_bwd_ref)
from repro_torch.core.hopper_adapter import default_smem_budget
from repro_torch.kernels.flash_decode import (MAX_CLUSTER, decode_smem_bytes,
                                              flash_decode,
                                              flash_decode_fp8,
                                              flash_decode_oproj,
                                              largest_page,
                                              paged_attention_fp8_ref,
                                              paged_attention_oproj_ref,
                                              paged_attention_ref)
from repro_torch.kernels.matmul_blocked import matmul_blocked, matmul_ref
from repro_torch.kernels.matmul_bwd import (matmul_dgrad_a,
                                            matmul_dgrad_a_ref,
                                            matmul_dgrad_b,
                                            matmul_dgrad_b_ref, mma_layout)
from repro_torch.kernels.matmul_fused import matmul_fused, matmul_fused_ref
from repro_torch.kernels.matmul_q import matmul_w8, matmul_w8_ref
from repro_torch.kernels.qkv_fused import qkv_fused, qkv_fused_ref
from repro_torch.quant import quantize

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def paged_case(dev, dtype, q_span, lengths, *, hkv=8, g=4, d=128, page=64,
               n_blocks=8, seed=0):
    """Ragged requests over a shuffled page pool; block-table entries
    past each request's cache (its span included) point at scratch page
    0, which holds garbage that must stay masked."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = b * n_blocks + 1
    q = rng.standard_normal((b, hkv, q_span * g, d))
    kp = rng.standard_normal((n_pages, page, hkv, d))
    vp = rng.standard_normal((n_pages, page, hkv, d))
    bt = (1 + rng.permutation(b * n_blocks)).reshape(b, n_blocks)
    for i, n in enumerate(lengths):
        used = -(-(n + q_span - 1) // page)
        bt[i, used:] = 0
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return (t(q), t(kp), t(vp),
            torch.tensor(bt, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def split_counts(q, k_pages, n_blocks):
    """Every split count a bf16 launch at these shapes may take: 1 to the
    most (``n_blocks``, and the cluster limit: 16 where two blocks share
    an SM, else 8); the fp32 instance takes none (its one block a row
    block)."""
    if q.dtype != torch.bfloat16:
        return []
    page, d = k_pages.shape[1], q.shape[3]
    two = decode_smem_bytes(page, d, k_pages.element_size()) \
        <= default_smem_budget()
    return list(range(1, min(n_blocks, MAX_CLUSTER if two else 8) + 1))


def hold_splits(fn, args, ref, dtype, **kw):
    """``fn`` at every split count of :func:`split_counts` (the wrapper's
    ``decode_grid`` patched to give it) against ``ref``, each launch
    recorded as the tensor-core instance, repeats bit-equal."""
    from repro_torch.kernels import flash_decode as FD
    q, k_pages, bt = args[0], args[1], args[-2]
    for s in split_counts(q, k_pages, bt.shape[1]):
        with mock.patch.object(FD, "decode_grid", lambda *a: (s, s, 0)):
            out = fn(*args, **kw)
            assert fn.instance == ("mma", s)
            assert torch.equal(out, fn(*args, **kw)), s
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_span,lengths", [
    (1, [1, 17, 64, 130, 300, 512]),        # decode; 1 sits in page 0
    (64, [1, 17, 64, 130, 300, 470]),       # chunked prefill; 470+63 > 512
])
@pytest.mark.parametrize("window,cap", [(None, None), (37, 30.0)])
def test_flash_decode_matches_plain(dev, dtype, q_span, lengths, window,
                                    cap):
    """The model's split count, then every count from 1 to the most
    (bf16): repeats bit-equal, each against the plain version."""
    args = paged_case(dev, dtype, q_span, lengths)
    before = flash_decode.launches
    out = flash_decode(*args, window=window, logit_cap=cap, q_span=q_span)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    ref = paged_attention_ref(*args, window=window, logit_cap=cap,
                              q_span=q_span)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    hold_splits(flash_decode, args, ref, dtype, window=window,
                logit_cap=cap, q_span=q_span)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_decode_long_rows_reload_the_page_table(dev, dtype, window):
    """Rows of 300 pages (page 16, 4,800 keys): a run longer than the
    128 page indices a block holds reloads them between ring steps, and
    with a window the run starts past them; decode and a 4-position
    span, every split count (bf16), repeats bit-equal."""
    for q_span in (1, 4):
        args = paged_case(dev, dtype, q_span, [4797, 2000, 9], hkv=2, g=4,
                          page=16, n_blocks=300, seed=q_span)
        kw = dict(window=window, q_span=q_span)
        out = flash_decode(*args, **kw)
        assert torch.equal(out, flash_decode(*args, **kw))
        ref = paged_attention_ref(*args, **kw)
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
        hold_splits(flash_decode, args, ref, dtype, **kw)


# b, sq, skv, hq, hkv, d, causal, window, cap: the first six the serving
# joins' shapes (GQA 32/8, D = 128), then the tensor-core instance's edges
FA_CASES = [
    (2, 8, 8, 32, 8, 128, True, None, None),
    (2, 64, 64, 32, 8, 128, True, None, None),
    (2, 512, 512, 32, 8, 128, True, None, None),
    (2, 24, 100, 32, 8, 128, True, None, None),
    (2, 64, 64, 32, 8, 128, True, 16, None),
    (2, 40, 40, 32, 8, 128, True, None, 30.0),
    (1, 63, 65, 32, 8, 128, True, None, None),    # 16k - 1, 16k + 1
    (2, 129, 127, 32, 8, 128, False, None, None),  # Sq > Skv
    (2, 33, 97, 32, 8, 128, True, None, None),    # Sq < Skv, ragged
    (2, 128, 128, 32, 8, 128, True, 40, None),    # window across tiles
    (2, 96, 96, 32, 8, 128, True, 70, 30.0),      # window and cap
    (2, 128, 128, 8, 2, 64, True, None, None),    # head_dim 64
    (2, 100, 100, 8, 8, 128, True, None, None),   # G = 1
    (1, 80, 80, 64, 8, 128, True, None, None),    # G = 8
    (2, 96, 96, 32, 8, 128, False, None, None),   # non-causal
    (1, 64, 64, 32, 8, 128, True, None, None),    # the join: B 1, S 64
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,cap", FA_CASES)
def test_flash_attention_matches_plain(dev, dtype, b, sq, skv, hq, hkv, d,
                                       causal, window, cap):
    rng = np.random.default_rng(1)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype,  # noqa
                                device=dev)
    q, k, v = t(b, sq, hq, d), t(b, skv, hkv, d), t(b, skv, hkv, d)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, "mma"),
                                        (torch.float32, "cuda_core")])
def test_flash_attention_instance_by_dtype(dev, dtype, kind):
    """bf16 runs the tensor-core instances, forward and backward, at the
    tiles of flash_tiles; fp32 the CUDA-core ones."""
    from repro_torch.core.hopper_adapter import flash_tiles
    from repro_torch.kernels.flash_attention import _forward
    q, k, v, g = attn_case(dev, dtype, 2, 128, 128, 32, 8, 128)
    tiles = flash_tiles(128, 128, 128, dtype.itemsize)
    o, lse = _forward(q, k, v, True, None, None, with_lse=True)
    assert flash_attention.instance == (kind, *tiles)
    flash_attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    assert flash_attention_bwd.instance == (kind, *tiles)


def test_flash_attention_refuses_tiles_and_head_dims_it_has_not(
        dev, monkeypatch):
    """A tile pair off the bf16 instance's warp grid (as a changed
    flash_tiles could return) raises before any launch, forward and
    backward; so does a head_dim the kernels do not take."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    q, k, v, g = attn_case(dev, torch.bfloat16, 1, 64, 64, 8, 2, 128)
    o, lse = FA._forward(q, k, v, True, None, None, with_lse=True)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    for tiles in ((48, 64), (64, 128), (8, 16)):
        monkeypatch.setattr(FA, "flash_tiles", lambda *a: tiles)
        monkeypatch.setattr(FB, "flash_tiles", lambda *a: tiles)
        with pytest.raises(ValueError, match="tensor-core instance"):
            FA._forward(q, k, v, True, None, None, with_lse=True)
        with pytest.raises(ValueError, match="tensor-core instance"):
            flash_attention_bwd(q, k, v, o, lse, g)
    monkeypatch.undo()
    q24, k24, v24, _ = attn_case(dev, torch.bfloat16, 1, 64, 64, 8, 2, 24)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q24, k24, v24)
    assert (flash_attention.launches,
            flash_attention_bwd.launches) == before


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 24, device=dev)        # head_dim 24
    kp = torch.zeros(3, 8, 8, 24, device=dev)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    ln = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_decode(q, kp, kp, bt, ln)
    with pytest.raises(TypeError):
        flash_decode(q.half(), kp.half(), kp.half(), bt, ln)
    qa = torch.zeros(1, 8, 4, 128, device=dev)
    with pytest.raises(ValueError):                 # not contiguous
        flash_attention(qa.transpose(1, 2), qa.transpose(1, 2),
                        qa.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 48, 128])
@pytest.mark.parametrize("q_span", [1, 64])
def test_flash_decode_page_is_the_tile(dev, dtype, page, q_span):
    """The kernels stage whole pages: any page launches, including one
    that is no multiple of 32 keys and one past 48 KB of tiles, up to
    the largest that fits the card (fp32: 111 keys, so 128 -> 111), at
    every split count (bf16)."""
    page = min(page, largest_page(128, dtype.itemsize, torch.cuda
                                  .get_device_properties(dev)
                                  .shared_memory_per_block_optin))
    args = paged_case(dev, dtype, q_span, [1, 17, 64, 130, 300, 470],
                      page=page, n_blocks=-(-512 // page), seed=page)
    before = flash_decode.launches
    out = flash_decode(*args, q_span=q_span)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    ref = paged_attention_ref(*args, q_span=q_span)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    hold_splits(flash_decode, args, ref, dtype, q_span=q_span)


def gemm_case(dev, dtype, m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=dtype, device=dev)
    b = torch.tensor(rng.standard_normal((k, n)) * k ** -0.5, dtype=dtype,
                     device=dev)
    return a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,tiles", [
    (8, 4096, 4096, (8, 256, 64)),       # decode, the model's tile
    (512, 1024, 512, (128, 64, 128)),    # prefill, the model's tile
    (37, 1000, 300, (16, 64, 64)),       # ragged M, K (K % 8: bf16 scalar)
    (50, 100, 70, (32, 128, 64)),        # ragged in all three
    (3, 5, 7, (3, 64, 64)),              # smaller than one tile
])
def test_matmul_blocked_matches_plain(dev, dtype, m, n, k, tiles):
    from repro_torch.kernels import matmul_fused as MF
    a, b = gemm_case(dev, dtype, m, n, k, seed=m + n + k)
    before = matmul_blocked.launches
    bm, bk, bn = tiles
    out = matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert matmul_blocked.launches == before + 1    # ragged tiles launch
    assert out.dtype == dtype and out.shape == (m, n)
    # bf16 on the tensor cores ("mma_t" up to 16 rows), fp32 on the tile
    # core; repeats bit-equal
    assert matmul_blocked.instance[0] == MF.instance_kind(dtype, m)
    assert torch.equal(out, matmul_blocked(a, b, bm=bm, bk=bk, bn=bn))
    tol = dict(TOL[dtype])
    if dtype == torch.float32:
        tol["atol"] = max(tol["atol"], 2e-6 * k ** 0.5)
    torch.testing.assert_close(out.float(), matmul_ref(a, b).float(), **tol)


def test_matmul_blocked_refuses_what_it_cannot_hold(dev):
    """bf16 tiles are held to the tensor-core instance (its shared
    memory, its warp grid, at decode its bn), fp32 ones to the tile
    core's accumulators; nothing launches."""
    a, b = gemm_case(dev, torch.bfloat16, 64, 4096, 4096)
    before = matmul_blocked.launches
    with pytest.raises(ValueError, match="shared memory"):
        matmul_blocked(a, b, bm=128, bk=4096, bn=128)
    with pytest.raises(ValueError, match="warp grid"):
        matmul_blocked(a, b, bm=256, bk=64, bn=256)
    with pytest.raises(ValueError, match="transposed"):
        matmul_blocked(a[:8].contiguous(), b, bm=8, bk=64, bn=256)
    with pytest.raises(ValueError, match="accumulators"):
        matmul_blocked(a.float(), b.float(), bm=256, bk=64, bn=256)
    with pytest.raises(NotImplementedError, match="forward only"):
        matmul_blocked(a.requires_grad_(), b, bm=16, bk=64, bn=64)
    assert matmul_blocked.launches == before
    qa = torch.zeros(1, 8, 4, 128, device=dev, dtype=torch.bfloat16)
    kp = torch.zeros(2, 512, 8, 128, device=dev, dtype=torch.bfloat16)
    bt = torch.ones(1, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        flash_decode(qa, kp, kp, bt, torch.ones(1, dtype=torch.int32,
                                                device=dev))


def gemm_tol(dtype, k):
    tol = dict(TOL[dtype])
    if dtype == torch.float32:
        tol["atol"] = max(tol["atol"], 2e-6 * k ** 0.5)
    return tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", [
    dict(), dict(act="gelu", bias=True), dict(act="silu", mul=True),
    dict(residual=True), dict(act="relu", scale=True, bias=True, mul=True,
                              residual=True)])
@pytest.mark.parametrize("m,n,k,tiles", [
    (8, 4096, 4096, (8, 256, 64)),       # decode
    (64, 1024, 512, (64, 64, 128)),      # join bucket
    (37, 1000, 300, (16, 64, 64)),       # ragged (scalar staging in bf16)
])
def test_matmul_fused_matches_plain(dev, dtype, epi, m, n, k, tiles):
    """Every epilogue operand alone and together, against the plain
    version (which applies them in fp32 in the JAX oracle's order)."""
    rng = np.random.default_rng(m + n)
    a, w = gemm_case(dev, dtype, m, n, k, seed=m + k)
    f32 = lambda *s: torch.tensor(rng.standard_normal(s),  # noqa: E731
                                  dtype=torch.float32, device=dev)
    kw = dict(act=epi.get("act", "none"),
              scale=f32(n) if epi.get("scale") else None,
              bias=f32(n) if epi.get("bias") else None,
              mul=f32(m, n).to(dtype) if epi.get("mul") else None,
              residual=f32(m, n).to(dtype) if epi.get("residual") else None)
    before = matmul_fused.launches
    bm, bk, bn = tiles
    out = matmul_fused(a, w, **kw, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert matmul_fused.launches == before + 1
    ref = matmul_fused_ref(a, w, **kw)
    torch.testing.assert_close(out.float(), ref.float(),
                               **gemm_tol(dtype, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,nkv,k,g,tiles,bf16_tiles", [
    (8, 1024, 4096, 4, (8, 32, 128), None),   # granite decode, widest bn
    (8, 1024, 4096, 4, (8, 32, 64), (8, 256, 32)),  # the model's tiles
    (1, 1024, 4096, 4, (8, 32, 64), (1, 256, 32)),  # one token
    (16, 1024, 4096, 4, (16, 32, 64), (16, 128, 64)),  # two token tiles
    (64, 1024, 4096, 4, (16, 64, 64), None),
    (512, 1024, 4096, 4, (16, 64, 64), (128, 64, 128)),  # a join: mma
    (24, 96, 136, 1, (16, 64, 64), None),     # ragged Nkv and K, G = 1
    (13, 96, 136, 1, (13, 64, 64), (13, 144, 64)),  # ragged k, v blocks
    (8, 32, 64, 2, (8, 64, 16), None),        # the reduced granite: decode
    (24, 32, 64, 2, (16, 64, 32), None),      # and a join
    (5, 40, 70, 3, (8, 64, 32), None),        # scalar staging
    # the wide query groups at the model's tiles: glm4-9b (G 16) and
    # granite-34b (G 48, MQA), fp32 bn under 64
    (8, 256, 4096, 16, (8, 16, 32), (8, 256, 32)),
    (8, 128, 6144, 48, (8, 16, 16), (8, 256, 32)),
    (512, 128, 6144, 48, (16, 16, 16), (64, 192, 64)),
])
def test_qkv_fused_matches_plain(dev, dtype, m, nkv, k, g, tiles,
                                 bf16_tiles):
    """fp32 on the tile core over the joint tile; bf16 on row 9's
    tensor-core instances over the segment-major grid (``"mma_t"`` at M
    <= 16, ``"mma"`` above), at each instance's own tiles where the two
    differ; repeats bit-equal."""
    from repro_torch.kernels import matmul_fused as MF
    rng = np.random.default_rng(m + nkv)
    t = lambda *s: torch.tensor(rng.standard_normal(s),  # noqa: E731
                                dtype=dtype, device=dev)
    x, wq = t(m, k), t(k, g * nkv) * k ** -0.5
    wk, wv = t(k, nkv) * k ** -0.5, t(k, nkv) * k ** -0.5
    before = qkv_fused.launches
    bm, bk, bn = bf16_tiles if dtype == torch.bfloat16 and bf16_tiles \
        else tiles
    got = qkv_fused(x, wq, wk, wv, bm=bm, bk=bk, bn=bn)
    again = qkv_fused(x, wq, wk, wv, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert qkv_fused.launches == before + 2
    assert qkv_fused.instance[0] == MF.instance_kind(dtype, m)
    for o, a, r in zip(got, again, qkv_fused_ref(x, wq, wk, wv)):
        assert torch.equal(o, a)
        torch.testing.assert_close(o.float(), r.float(), **gemm_tol(dtype, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 32, 64])
@pytest.mark.parametrize("window,cap", [(None, None), (37, 30.0)])
def test_flash_decode_oproj_matches_plain(dev, dtype, page, window, cap):
    """B = 8, Hkv = 8, G = 4, D = 128, E = 4096 (granite's decode), ragged
    lengths; the cluster's head reduction is in a fixed order, so two
    launches agree bit for bit."""
    lengths = [1, 17, 64, 130, 300, 512, 33, 250]
    q, kp, vp, bt, ln = paged_case(dev, dtype, 1, lengths, page=page,
                                   n_blocks=512 // page, seed=page)
    rng = np.random.default_rng(page)
    wo = torch.tensor(rng.standard_normal((8, 4 * 128, 4096)) / 64,
                      dtype=dtype, device=dev)
    before = flash_decode_oproj.launches
    out = flash_decode_oproj(q, kp, vp, bt, ln, wo, window=window,
                             logit_cap=cap)
    again = flash_decode_oproj(q, kp, vp, bt, ln, wo, window=window,
                               logit_cap=cap)
    torch.cuda.synchronize()
    assert flash_decode_oproj.launches == before + 2
    assert out.shape == (8, 4096) and torch.equal(out, again)
    ref = paged_attention_oproj_ref(q, kp, vp, bt, ln, wo, window=window,
                                    logit_cap=cap)
    torch.testing.assert_close(out.float(), ref.float(),
                               **gemm_tol(dtype, 512))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g,e", [(2, 16, 4096), (1, 48, 6144)])
@pytest.mark.parametrize("b", [1, 8, 20])
def test_flash_decode_oproj_wide_groups(dev, dtype, hkv, g, e, b):
    """glm4-9b's (Hkv 2, G 16) and granite-34b's (Hkv 1, G 48) decode at
    D 128 and the fused page (32), B 1, 8 and 20 (two groups): the query
    heads in chunks of ``oproj_head_chunk`` within the two-block budget,
    each chunk a partial of its own on the grid, repeats bit-equal,
    against the plain version."""
    from repro_torch.kernels import flash_decode as FD
    lengths = [(97 * i + 13) % 512 + 1 for i in range(b)]
    q, kp, vp, bt, ln = paged_case(dev, dtype, 1, lengths, hkv=hkv, g=g,
                                   page=32, n_blocks=16, seed=g + b)
    rng = np.random.default_rng(g + b)
    wo = torch.tensor(rng.standard_normal((hkv, g * 128, e))
                      / (hkv * g * 128) ** 0.5, dtype=dtype, device=dev)
    assert FD.oproj_smem_bytes_required(32, g, 128, dtype.itemsize,
                                        batch=b) <= default_smem_budget()
    out = flash_decode_oproj(q, kp, vp, bt, ln, wo)
    again = flash_decode_oproj(q, kp, vp, bt, ln, wo)
    torch.cuda.synchronize()
    assert out.shape == (b, e) and torch.equal(out, again)
    assert not FD._COUNTERS[q.device].any()
    ref = paged_attention_oproj_ref(q, kp, vp, bt, ln, wo)
    torch.testing.assert_close(out.float(), ref.float(),
                               **gemm_tol(dtype, hkv * g * 128))


def test_fused_kernels_refuse_what_they_cannot_hold(dev):
    """A tile the kernel does not hold raises before any launch: in fp32
    at G = 4 a qkv bn of 256 makes a 1536-column joint tile; rows 9 and
    11's transposed instance (M <= 16) takes bn of 16, 32, 64 or 128 and
    their mma instance a tile on its warp grid; the oproj-fused decode
    takes 16-byte wo rows."""
    x = torch.zeros(8, 4096, dtype=torch.bfloat16, device=dev)
    wq = torch.zeros(4096, 4096, dtype=torch.bfloat16, device=dev)
    wk = torch.zeros(4096, 1024, dtype=torch.bfloat16, device=dev)
    before = (qkv_fused.launches, matmul_fused.launches,
              flash_decode_oproj.launches)
    with pytest.raises(ValueError, match="accumulators"):
        qkv_fused(x.float(), wq.float(), wk.float(), wk.float(), bm=8,
                  bk=64, bn=256)
    with pytest.raises(ValueError, match="transposed"):
        qkv_fused(x, wq, wk, wk, bm=8, bk=64, bn=256)
    with pytest.raises(ValueError, match="transposed"):
        matmul_fused(x, wq, act="silu", bm=256, bk=64, bn=256)
    x512 = torch.zeros(512, 4096, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="warp grid"):
        matmul_fused(x512, wq, act="silu", bm=512, bk=64, bn=256)
    with pytest.raises(ValueError, match="warp grid"):
        qkv_fused(x512, wq, wk, wk, bm=512, bk=64, bn=256)
    with pytest.raises(ValueError, match="shared memory"):
        qkv_fused(x, wq, wk, wk, bm=8, bk=4096, bn=128)
    q, kp, vp, bt, ln = paged_case(dev, torch.bfloat16, 1, [5, 9], hkv=16,
                                   g=2, page=16, n_blocks=2)
    wo = torch.zeros(16, 2 * 128, 60, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_decode_oproj(q, kp, vp, bt, ln, wo)
    assert (qkv_fused.launches, matmul_fused.launches,
            flash_decode_oproj.launches) == before


# ------------------------------ quantized path -------------------------------


def w8_case(dev, dtype, m, n, k, seed=0):
    """A and the int8 quantization of a K ** -0.5-scaled weight (per
    output channel), so every output is O(1)."""
    a, w = gemm_case(dev, torch.float32, m, n, k, seed=seed)
    return a.to(dtype), quantize(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
@pytest.mark.parametrize("m,n,k,tiles,bf16_tiles", [
    (8, 4096, 4096, (8, 512, 64), None),  # decode
    (8, 4096, 12800, (8, 64, 512), (8, 512, 32)),  # the down projection's
    (1, 4096, 4096, (8, 64, 128), (1, 512, 32)),   # one token
    (16, 1008, 300, (16, 64, 64), (16, 128, 16)),  # two token tiles, ragged
    (512, 1024, 4096, (128, 64, 128), None),   # a join span: mma
    (37, 1008, 300, (16, 64, 64), None),       # ragged M and K (K % 8)
    (24, 4096, 4096, (16, 128, 64), None),     # the smallest mma M
    (5, 48, 70, (8, 64, 16), None),            # smaller than one tile
])
def test_matmul_w8_matches_plain(dev, dtype, per_channel, m, n, k, tiles,
                                 bf16_tiles):
    """fp32 on the tile core; bf16 on row 9's tensor-core instances with
    the scale-only store (``"mma_t"`` at M <= 16, ``"mma"`` above), at
    each instance's own tiles where the two differ; repeats bit-equal."""
    from repro_torch.kernels import matmul_fused as MF
    a, qw = w8_case(dev, dtype, m, n, k, seed=m + n)
    scale = qw.scale if per_channel else qw.scale.max()
    before = matmul_w8.launches
    bm, bk, bn = bf16_tiles if dtype == torch.bfloat16 and bf16_tiles \
        else tiles
    out = matmul_w8(a, qw.q, scale, bm=bm, bk=bk, bn=bn)
    again = matmul_w8(a, qw.q, scale, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert matmul_w8.launches == before + 2
    assert matmul_w8.instance[0] == MF.instance_kind(dtype, m)
    assert out.dtype == dtype and out.shape == (m, n)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(),
                               matmul_w8_ref(a, qw.q, scale).float(),
                               **gemm_tol(dtype, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", [
    dict(act="silu"), dict(mul=True), dict(residual=True),
    dict(act="gelu", bias=True, mul=True, residual=True)])
@pytest.mark.parametrize("m,n,k,tiles", [
    (8, 12800, 4096, (8, 512, 64)),      # gate / up at decode
    (64, 1024, 512, (64, 64, 128)),
    (37, 1008, 300, (16, 64, 64)),       # ragged M and K
])
def test_int8_matmul_fused_matches_plain(dev, dtype, epi, m, n, k, tiles):
    """The int8 variant: the weight tile staged at one byte, its scale
    first in the epilogue."""
    rng = np.random.default_rng(m + k)
    a, qw = w8_case(dev, dtype, m, n, k, seed=m + n)
    f32 = lambda *s: torch.tensor(rng.standard_normal(s),  # noqa: E731
                                  dtype=torch.float32, device=dev)
    kw = dict(act=epi.get("act", "none"),
              bias=f32(n) if epi.get("bias") else None,
              mul=f32(m, n).to(dtype) if epi.get("mul") else None,
              residual=f32(m, n).to(dtype) if epi.get("residual") else None)
    scale = qw.scale.reshape(-1)
    before = matmul_fused.launches
    bm, bk, bn = tiles
    out = matmul_fused(a, qw.q, scale, **kw, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert matmul_fused.launches == before + 1
    ref = matmul_fused_ref(a, qw.q, scale, **kw)
    torch.testing.assert_close(out.float(), ref.float(),
                               **gemm_tol(dtype, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_span,lengths", [
    (1, [1, 17, 64, 130, 300, 512]),
    (64, [1, 17, 64, 130, 300, 470]),
])
@pytest.mark.parametrize("page", [16, 64, 200])
@pytest.mark.parametrize("window,cap,unit", [(None, None, True),
                                             (37, 30.0, False)])
def test_flash_decode_fp8_matches_plain(dev, dtype, q_span, lengths, page,
                                        window, cap, unit):
    """fp8 pages (a page of 200 keys fits only at one byte), unit and
    non-unit per-head scales; two launches agree bit for bit, and in
    bf16 at every split count."""
    q, kp, vp, bt, ln = paged_case(dev, torch.float32, q_span, lengths,
                                   page=page, n_blocks=-(-512 // page),
                                   seed=page + q_span)
    q = q.to(dtype)
    kp8, vp8 = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
    rng = np.random.default_rng(page)
    ks, vs = (torch.ones(8, device=dev) if unit else
              torch.tensor(rng.uniform(0.5, 2.0, 8), dtype=torch.float32,
                           device=dev) for _ in range(2))
    kw = dict(window=window, logit_cap=cap, q_span=q_span)
    before = flash_decode_fp8.launches
    out = flash_decode_fp8(q, kp8, vp8, ks, vs, bt, ln, **kw)
    again = flash_decode_fp8(q, kp8, vp8, ks, vs, bt, ln, **kw)
    torch.cuda.synchronize()
    assert flash_decode_fp8.launches == before + 2
    assert out.dtype == dtype and torch.equal(out, again)
    ref = paged_attention_fp8_ref(q, kp8, vp8, ks, vs, bt, ln, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    hold_splits(flash_decode_fp8, (q, kp8, vp8, ks, vs, bt, ln), ref, dtype,
                **kw)


def test_quantized_kernels_refuse_what_they_cannot_take(dev):
    """An int8 weight whose N or bn is no whole number of 16-byte copies,
    a wide weight passed to the int8 GEMM, a bf16 tile off the
    tensor-core instances (a transposed-instance bn outside 16, 32, 64,
    128; an mma tile off its warp grid) and fp8 scales of the wrong shape
    raise before any launch."""
    a, qw = w8_case(dev, torch.bfloat16, 8, 40, 64)
    a2, qw2 = w8_case(dev, torch.bfloat16, 8, 64, 64)
    before = (matmul_w8.launches, matmul_fused.launches,
              flash_decode_fp8.launches)
    with pytest.raises(ValueError, match="16"):
        matmul_w8(a, qw.q, qw.scale, bm=8, bk=64, bn=16)
    with pytest.raises(ValueError, match="16"):
        matmul_w8(a2, qw2.q, qw2.scale, bm=8, bk=64, bn=24)
    with pytest.raises(ValueError, match="16"):
        matmul_fused(a, qw.q, qw.scale, bm=8, bk=64, bn=16)
    with pytest.raises(TypeError, match="int8"):
        matmul_w8(a2, qw2.q.to(torch.bfloat16), qw2.scale, bm=8, bk=64,
                  bn=64)
    a3, qw3 = w8_case(dev, torch.bfloat16, 512, 4096, 64)
    with pytest.raises(ValueError, match="transposed"):
        matmul_w8(a3[:8], qw3.q, qw3.scale, bm=8, bk=64, bn=48)
    with pytest.raises(ValueError, match="warp grid"):
        matmul_w8(a3, qw3.q, qw3.scale, bm=512, bk=64, bn=256)
    q, kp, vp, bt, ln = paged_case(dev, torch.bfloat16, 1, [5, 9], page=16,
                                   n_blocks=2)
    kp8, vp8 = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
    ones = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode_fp8(q, kp8, vp8, ones[:4], ones, bt, ln)
    with pytest.raises(TypeError):
        flash_decode_fp8(q, kp, vp, ones, ones, bt, ln)
    assert (matmul_w8.launches, matmul_fused.launches,
            flash_decode_fp8.launches) == before


# -- the training path: dgrad GEMMs, lse, attention backward ---------------


def grad_close(out, ref, dtype):
    """The gradient tolerance of the module docstring."""
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        tol = dict(atol=1e-4 * max(1.0, scale), rtol=1e-3)
    else:
        tol = dict(atol=1e-2 * scale, rtol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,tiles", [
    (2048, 4096, 4096, (128, 64, 128)),   # a training projection
    (2048, 12800, 4096, (128, 64, 128)),  # the up projection, model's tile
    (2048, 4096, 12800, (128, 64, 128)),  # the down projection
    (2048, 4096, 1024, (80, 64, 128)),    # a tile off the default grid
    (256, 1024, 512, (64, 64, 128)),
    (37, 1000, 300, (16, 64, 64)),        # ragged (scalar staging)
    (50, 100, 70, (32, 48, 64)),          # ragged, reduction step 48
    (3, 5, 7, (3, 64, 64)),               # smaller than one tile
])
def test_matmul_dgrad_matches_plain(dev, dtype, m, n, k, tiles):
    """dA = g @ b^T and dB = a^T @ g for C[m, n] = a[m, k] @ b[k, n],
    operands scaled so both are O(1); repeated launches agree bit for
    bit; bf16 runs the tensor-core ("mma") instance on its warp grid,
    fp32 the CUDA-core ("fma") one."""
    rng = np.random.default_rng(m + n)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype,  # noqa
                                device=dev)
    a, b, g = t(m, k), t(k, n) * n ** -0.5, t(m, n)
    gb = g * m ** -0.5
    before = (matmul_dgrad_a.launches, matmul_dgrad_b.launches)
    t0, t1, t2 = tiles
    da = matmul_dgrad_a(g, b, bm=t0, br=t1, bo=t2)
    db = matmul_dgrad_b(a, gb, bk=t0, br=t1, bn=t2)
    torch.cuda.synchronize()
    assert (matmul_dgrad_a.launches, matmul_dgrad_b.launches) == \
        (before[0] + 1, before[1] + 1)
    assert da.shape == (m, k) and db.shape == (k, n) and da.dtype == dtype
    torch.testing.assert_close(da.float(),
                               matmul_dgrad_a_ref(g, b).float(),
                               **gemm_tol(dtype, n))
    torch.testing.assert_close(db.float(),
                               matmul_dgrad_b_ref(a, gb).float(),
                               **gemm_tol(dtype, m))
    assert torch.equal(da, matmul_dgrad_a(g, b, bm=t0, br=t1, bo=t2))
    assert torch.equal(db, matmul_dgrad_b(a, gb, bk=t0, br=t1, bn=t2))
    kind = "mma" if dtype == torch.bfloat16 else "fma"
    for fn in (matmul_dgrad_a, matmul_dgrad_b):
        assert fn.instance[0] == kind
        if kind == "mma":
            assert fn.instance[1] == mma_layout(t0, t2)


def test_ops_matmul_backward_equals_the_plain_gemms(dev):
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.standard_normal((96, 320)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    b = torch.tensor(rng.standard_normal((320, 192)) * 320 ** -0.5,
                     dtype=torch.float32, device=dev, requires_grad=True)
    g = torch.tensor(rng.standard_normal((96, 192)), dtype=torch.float32,
                     device=dev)
    before = (matmul_blocked.launches, matmul_dgrad_a.launches,
              matmul_dgrad_b.launches)
    ops.matmul(a, b).backward(g)
    torch.cuda.synchronize()
    assert (matmul_blocked.launches, matmul_dgrad_a.launches,
            matmul_dgrad_b.launches) == tuple(n + 1 for n in before)
    grad_close(a.grad, matmul_dgrad_a_ref(g, b.detach()), torch.float32)
    grad_close(b.grad, matmul_dgrad_b_ref(a.detach(), g), torch.float32)


ATTN_BWD_CASES = [  # b, sq, skv, hq, hkv, d, window, cap, causal
    (1, 64, 64, 32, 8, 128, None, None, True),
    (4, 512, 512, 32, 8, 128, None, None, True),
    (2, 100, 100, 32, 8, 128, None, None, True),    # ragged S
    (2, 40, 104, 32, 8, 128, None, None, True),     # Sq < Skv
    (2, 128, 128, 32, 8, 128, 48, None, True),      # window
    (2, 96, 96, 32, 8, 128, None, 30.0, True),      # cap
    (2, 128, 128, 8, 2, 64, None, None, True),      # head_dim 64
    (1, 63, 65, 32, 8, 128, None, None, True),      # 16k - 1, 16k + 1
    (2, 128, 128, 32, 8, 128, 40, None, True),      # window across tiles
    (2, 100, 100, 8, 8, 128, None, None, True),     # G = 1
    (1, 80, 80, 64, 8, 128, None, None, True),      # G = 8
    (2, 96, 96, 32, 8, 128, None, None, False),     # non-causal
]


def attn_case(dev, dtype, b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype,  # noqa
                                device=dev)
    return t(b, sq, hq, d), t(b, skv, hkv, d), t(b, skv, hkv, d), \
        t(b, sq, hq, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window,cap,causal",
                         ATTN_BWD_CASES)
def test_flash_attention_lse_and_bwd_match_plain(dev, dtype, b, sq, skv, hq,
                                                 hkv, d, window, cap,
                                                 causal):
    """The forward's lse residual, and the backward kernel against its
    plain version on the same (o, lse); repeated launches agree bit for
    bit."""
    from repro_torch.kernels.flash_attention import _forward
    q, k, v, g = attn_case(dev, dtype, b, sq, skv, hq, hkv, d, seed=sq)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    o, lse = _forward(q, k, v, causal, window, cap, with_lse=True)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                               atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(o.float(), flash_attention_ref(
        q, k, v, **kw).float(), **TOL[dtype])
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, g, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, lse, g, **kw)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        grad_close(x, y, dtype)
    again = flash_attention_bwd(q, k, v, o, lse, g, **kw)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def test_grads_reach_wq_wk_wv_through_ops_attention(dev):
    """The repaired fault: on the card, a loss through ops.attention gives
    wq, wk and wv their gradients, equal to the plain path's."""
    rng = np.random.default_rng(4)
    bsz, s, dm, hq, hkv, d = 2, 48, 256, 4, 2, 64
    x = torch.tensor(rng.standard_normal((bsz, s, dm)), dtype=torch.float32,
                     device=dev)
    w_out = torch.tensor(rng.standard_normal((bsz, s, hq, d)),
                         dtype=torch.float32, device=dev)
    grads = {}
    for use_kernel in (True, False):
        ws = [torch.tensor(rng.standard_normal((dm, n)) * dm ** -0.5,
                           dtype=torch.float32, device=dev,
                           requires_grad=True)
              for n in (hq * d, hkv * d, hkv * d)] if use_kernel else \
            [w.detach().clone().requires_grad_() for w in grads[True][1]]
        q = (x @ ws[0]).reshape(bsz, s, hq, d)
        k = (x @ ws[1]).reshape(bsz, s, hkv, d)
        v = (x @ ws[2]).reshape(bsz, s, hkv, d)
        before = flash_attention_bwd.launches
        out = ops.attention(q, k, v, use_kernel=use_kernel)
        (out * w_out).sum().backward()
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + int(use_kernel)
        grads[use_kernel] = ([w.grad for w in ws], ws)
    for got, want in zip(grads[True][0], grads[False][0]):
        assert got is not None and float(got.abs().max()) > 0
        grad_close(got, want, torch.float32)


def test_flash_decode_wrappers_raise_under_grad(dev):
    args = paged_case(dev, torch.float32, 1, [17, 64])
    q = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_decode(q, *args[1:])
    ones = torch.ones(8, dtype=torch.float32, device=dev)
    fp8 = torch.float8_e4m3fn
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_decode_fp8(q, args[1].to(fp8), args[2].to(fp8), ones, ones,
                         *args[3:])
    q1 = q.detach()[:, :, :4].contiguous().requires_grad_()
    wo = torch.zeros(8, 4 * 128, 256, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_decode_oproj(q1, *args[1:], wo)
    with torch.no_grad():               # the serving engine's case
        flash_decode(q, *args[1:])


# -- the conv path: rows 12 and 13 -----------------------------------------


CONV_CASES = [  # n, h, w, c, k, fh, fw, stride, (bx, by, bc, bk)
    (2, 10, 10, 4, 8, 3, 3, 1, (4, 4, 4, 8)),
    (2, 13, 11, 3, 5, 2, 2, 1, (5, 3, 3, 4)),        # ragged everything
    (1, 14, 14, 4, 8, 3, 3, 2, (3, 3, 2, 4)),        # stride 2
    (1, 11, 11, 4, 8, 3, 3, 2, (2, 2, 4, 8)),        # remainder rows
    (2, 8, 8, 16, 24, 1, 1, 1, (8, 8, 8, 16)),       # 1 x 1
    (2, 40, 40, 3, 96, 11, 11, 4, (4, 4, 3, 16)),    # AlexNet conv1's C, s
    (2, 30, 30, 37, 70, 11, 11, 1, (8, 8, 8, 16)),   # 11 x 11, ragged C/K
    (2, 20, 20, 108, 200, 4, 4, 1, (8, 8, 16, 64)),  # Conv3's channels
]


def conv_case(dev, dtype, n, h, w, c, k, fh, fw, stride, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    oh, ow = (h - fh) // stride + 1, (w - fw) // stride + 1
    return (t(rng.standard_normal((n, h, w, c))),
            t(rng.standard_normal((fh, fw, c, k)) * (c * fh * fw) ** -0.5),
            t(rng.standard_normal((n, oh, ow, k))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k,fh,fw,stride,tiles", CONV_CASES)
def test_conv_kernels_match_plain(dev, dtype, n, h, w, c, k, fh, fw, stride,
                                  tiles):
    """Row 12 and row 13 (both passes) against their plain versions;
    repeated launches agree bit for bit."""
    x, wt, g = conv_case(dev, dtype, n, h, w, c, k, fh, fw, stride, seed=h)
    bx, by, bc, bk = tiles
    before = (conv2d_block.launches, conv2d_wgrad_block.launches)
    y = conv2d_block(x, wt, bc=bc, bk=bk, stride=stride, bx=bx, by=by)
    dw = conv2d_wgrad_block(x, g, fh, fw, bx=bx, by=by, bc=min(bc, 8),
                            bk=min(bk, 16), stride=stride)
    torch.cuda.synchronize()
    assert (conv2d_block.launches, conv2d_wgrad_block.launches) == \
        (before[0] + 1, before[1] + 2)
    assert y.dtype == dtype and dw.dtype == torch.float32
    torch.testing.assert_close(y.float(),
                               conv2d_blocked_ref(x, wt, stride).float(),
                               **gemm_tol(dtype, c * fh * fw))
    grad_close(dw, conv2d_wgrad_block_ref(x, g, fh, fw, stride),
               torch.float32)
    assert torch.equal(y, conv2d_block(x, wt, bc=bc, bk=bk, stride=stride,
                                       bx=bx, by=by))
    assert torch.equal(dw, conv2d_wgrad_block(
        x, g, fh, fw, bx=bx, by=by, bc=min(bc, 8), bk=min(bk, 16),
        stride=stride))


MMA_CASES = [  # bf16: branches of row 12's tensor-core instance
    (1, 26, 26, 64, 32, 11, 11, 1, (16, 16, 8, 16)),  # k-steps straddle taps
    (2, 51, 51, 3, 96, 11, 11, 4, (11, 11, 3, 8)),    # C = 3 at stride 4
    (1, 21, 16, 16, 16, 3, 3, 1, (7, 19, 16, 16)),    # 133 pixels
    (2, 14, 14, 16, 48, 3, 3, 1, (12, 12, 16, 24)),   # a clamped n8 tile
    (1, 11, 11, 16, 72, 3, 3, 1, (9, 9, 16, 72)),     # two warps across N
    (1, 22, 22, 40, 3, 3, 3, 1, (16, 8, 8, 3)),       # K = 3
    (1, 10, 10, 16, 256, 3, 3, 1, (8, 8, 16, 256)),   # four warps across N
]


@pytest.mark.parametrize("n,h,w,c,k,fh,fw,stride,tiles", MMA_CASES)
def test_conv_tensor_core_instance_matches_plain(dev, n, h, w, c, k, fh, fw,
                                                 stride, tiles):
    """Row 12 in bf16 (the implicit GEMM on the tensor cores) against its
    plain version; repeated launches agree bit for bit."""
    x, wt, _ = conv_case(dev, torch.bfloat16, n, h, w, c, k, fh, fw, stride,
                         seed=h + k)
    bx, by, bc, bk = tiles
    y = conv2d_block(x, wt, bc=bc, bk=bk, stride=stride, bx=bx, by=by)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(),
                               conv2d_blocked_ref(x, wt, stride).float(),
                               **gemm_tol(torch.bfloat16, c * fh * fw))
    assert torch.equal(y, conv2d_block(x, wt, bc=bc, bk=bk, stride=stride,
                                       bx=bx, by=by))


WGRAD_MMA_CASES = [  # bf16: branches of row 13's tensor-core instance
    (2, 26, 26, 64, 32, 11, 11, 1, (16, 16, 8, 16)),  # a fragment, 2 taps
    (2, 51, 51, 3, 96, 11, 11, 4, (11, 11, 3, 16)),   # C = 3 at stride 4
    (1, 21, 16, 16, 16, 3, 3, 1, (7, 19, 16, 16)),    # 133 pixels a pair
    (2, 14, 14, 16, 48, 3, 3, 1, (5, 5, 16, 24)),     # ragged image edges
    (1, 22, 22, 40, 3, 3, 3, 1, (16, 8, 8, 3)),       # K = 3
    (2, 19, 15, 20, 40, 3, 3, 2, (4, 3, 16, 40)),     # ragged C, stride 2
    (1, 11, 11, 8, 128, 3, 3, 1, (9, 9, 8, 128)),     # 8 warps across N
]


@pytest.mark.parametrize("n,h,w,c,k,fh,fw,stride,tiles", WGRAD_MMA_CASES)
def test_wgrad_tensor_core_instance_matches_plain(dev, n, h, w, c, k, fh, fw,
                                                  stride, tiles):
    """Row 13 in bf16 (the implicit GEMM on the tensor cores, both passes)
    against its plain version; the wrapper records the ``mma`` instance
    at ``mma_layout``'s grid; repeated launches agree bit for bit."""
    from repro_torch.kernels.conv2d_bwd import mma_layout
    x, _, g = conv_case(dev, torch.bfloat16, n, h, w, c, k, fh, fw, stride,
                        seed=h + k)
    bx, by, bc, bk = tiles
    dw = conv2d_wgrad_block(x, g, fh, fw, bx=bx, by=by, bc=bc, bk=bk,
                            stride=stride)
    torch.cuda.synchronize()
    assert conv2d_wgrad_block.instance == ("mma",
                                           mma_layout(bc, bk, fh, fw))
    grad_close(dw, conv2d_wgrad_block_ref(x, g, fh, fw, stride),
               torch.float32)
    assert torch.equal(dw, conv2d_wgrad_block(x, g, fh, fw, bx=bx, by=by,
                                              bc=bc, bk=bk, stride=stride))


@pytest.mark.parametrize("stride", [1, 2])
def test_ops_conv2d_backward_runs_the_kernels(dev, stride):
    """One row-12 launch forward; one row-12 (dgrad) and two row-13
    (wgrad) launches backward; ``use_kernel=False`` launches nothing and
    gives the same gradients."""
    x0, w0, _ = conv_case(dev, torch.float32, 2, 15, 13, 6, 10, 3, 3,
                          stride, seed=stride)
    grads = {}
    for use_kernel in (True, False):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        before = (conv2d_block.launches, conv2d_wgrad_block.launches)
        y = ops.conv2d(x, w, stride=stride, use_kernel=use_kernel)
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
        k = int(use_kernel)
        assert (conv2d_block.launches, conv2d_wgrad_block.launches) == \
            (before[0] + 2 * k, before[1] + 2 * k)
        grads[use_kernel] = (y.detach(), x.grad, w.grad)
    for got, want in zip(grads[True], grads[False]):
        grad_close(got, want, torch.float32)


def test_conv_kernels_refuse_what_they_cannot_hold(dev):
    x, wt, g = conv_case(dev, torch.float32, 1, 20, 20, 8, 64, 3, 3, 1)
    with pytest.raises(ValueError, match="accumulators"):
        conv2d_block(x, wt, bc=8, bk=64, bx=18, by=18)
    with pytest.raises(ValueError, match="accumulators"):   # 96 sums
        conv2d_block(x.bfloat16(), wt.bfloat16(), bc=8, bk=64, bx=18, by=18)
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_block(x, wt, bc=512, bk=64, bx=4, by=4)
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_block(x.transpose(1, 2), wt, bc=8, bk=8)
    with pytest.raises(ValueError, match="accumulators"):
        conv2d_wgrad_block(x, g, 3, 3, bx=4, by=4, bc=32, bk=64)
    with pytest.raises(NotImplementedError, match="ops.conv2d"):
        conv2d_block(x.clone().requires_grad_(), wt, bc=8, bk=8)
    with pytest.raises(TypeError):
        conv2d_block(x.half(), wt.half(), bc=8, bk=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv2d_block(x, wt.cpu(), bc=8, bk=8)


# ------------------------------ head dims, wide Hkv, row 9 ------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 80, 96, 256])
def test_attention_kernels_take_every_head_dim(dev, dtype, d):
    """Rows 1-5 at head dims off the 64 and 128 instances (16 at the
    32-wide one, 80 and 96 at 128, 256 at 256): paged decode and chunked
    prefill, the fp8 decode, the oproj-fused decode, the forward with
    its lse and the backward against their plain versions; repeats of
    the backward and of the oproj decode agree bit for bit."""
    for q_span, lengths in ((1, [1, 17, 64, 130]), (16, [1, 17, 64, 100])):
        args = paged_case(dev, dtype, q_span, lengths, hkv=2, g=4, d=d,
                          page=32, n_blocks=5, seed=d)
        kw = dict(window=37, logit_cap=30.0, q_span=q_span)
        torch.testing.assert_close(
            flash_decode(*args, **kw).float(),
            paged_attention_ref(*args, **kw).float(), **TOL[dtype])
        if dtype == torch.bfloat16:
            q, kp, vp, bt, ln = paged_case(dev, torch.float32, q_span,
                                           lengths, hkv=2, g=4, d=d,
                                           page=32, n_blocks=5, seed=d)
            f8 = (q.to(dtype), kp.to(torch.float8_e4m3fn),
                  vp.to(torch.float8_e4m3fn),
                  torch.ones(2, device=dev), torch.ones(2, device=dev),
                  bt, ln)
            torch.testing.assert_close(
                flash_decode_fp8(*f8, q_span=q_span).float(),
                paged_attention_fp8_ref(*f8, q_span=q_span).float(),
                **TOL[dtype])
    q, kp, vp, bt, ln = paged_case(dev, dtype, 1, [1, 17, 64, 130], hkv=2,
                                   g=4, d=d, page=32, n_blocks=5, seed=d)
    rng = np.random.default_rng(d)
    wo = torch.tensor(rng.standard_normal((2, 4 * d, 256)) * (8 * d) ** -0.5,
                      dtype=dtype, device=dev)
    out = flash_decode_oproj(q, kp, vp, bt, ln, wo, window=37)
    assert torch.equal(out, flash_decode_oproj(q, kp, vp, bt, ln, wo,
                                               window=37))
    torch.testing.assert_close(
        out.float(),
        paged_attention_oproj_ref(q, kp, vp, bt, ln, wo, window=37).float(),
        **gemm_tol(dtype, 8 * d))
    for causal, window in ((True, None), (True, 40), (False, None)):
        q, k, v, g = attn_case(dev, dtype, 2, 100, 100, 8, 2, d)
        kw = dict(causal=causal, window=window, logit_cap=None)
        from repro_torch.kernels.flash_attention import _forward
        o, lse = _forward(q, k, v, causal, window, None, with_lse=True)
        torch.testing.assert_close(o.float(),
                                   flash_attention_ref(q, k, v, **kw).float(),
                                   **TOL[dtype])
        torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                                   atol=1e-4, rtol=1e-4)
        got = flash_attention_bwd(q, k, v, o, lse, g, **kw)
        want = flash_attention_bwd_ref(q, k, v, o, lse, g, **kw)
        for x, y in zip(got, want):
            grad_close(x, y, dtype)
        assert all(torch.equal(x, y) for x, y in
                   zip(got, flash_attention_bwd(q, k, v, o, lse, g, **kw)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,d,e", [(16, 64, 1024), (32, 96, 3072)])
def test_oproj_takes_more_kv_heads_than_a_cluster(dev, dtype, hkv, d, e):
    """Row 3 at Hkv 16 and 32 (G 1): clusters of 8 and 12 of a head's
    E slices, the last block of each slice summing the 16 or 32 heads in
    order; against the plain version, repeats bit-equal."""
    q, kp, vp, bt, ln = paged_case(dev, dtype, 1, [45, 300], hkv=hkv, g=1,
                                   d=d, page=32, n_blocks=16, seed=hkv)
    rng = np.random.default_rng(hkv)
    wo = torch.tensor(rng.standard_normal((hkv, d, e)) * (hkv * d) ** -0.5,
                      dtype=dtype, device=dev)
    before = flash_decode_oproj.launches
    out = flash_decode_oproj(q, kp, vp, bt, ln, wo)
    torch.cuda.synchronize()
    assert flash_decode_oproj.launches == before + 1
    assert torch.equal(out, flash_decode_oproj(q, kp, vp, bt, ln, wo))
    torch.testing.assert_close(
        out.float(),
        paged_attention_oproj_ref(q, kp, vp, bt, ln, wo).float(),
        **gemm_tol(dtype, hkv * d))


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("m", [1, 8, 13, 16, 24, 512])
@pytest.mark.parametrize("n,k", [(4096, 12800), (12800, 4096)])
def test_row9_tensor_core_instances_match_plain(dev, w8, m, n, k):
    """Row 9 in bf16 at the fused keys' own tiles: the transposed
    instance at M <= 16, the mma instance above, wide and int8, with the
    down projection's residual and the gate's silu; repeats bit-equal."""
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.tune import best_schedule
    if w8:
        a, qw = w8_case(dev, torch.bfloat16, m, n, k, seed=m)
        w, scale = qw.q, qw.scale.reshape(-1)
    else:
        a, w = gemm_case(dev, torch.bfloat16, m, n, k, seed=m)
        scale = None
    res = torch.randn(m, n, device=dev).to(torch.bfloat16)
    key = "matmul_fused_w8" if w8 else "matmul_fused"
    bm, bk, bn = best_schedule(key, (m, n, k), "bfloat16").tiles
    kw = dict(act="silu", residual=res)
    out = matmul_fused(a, w, scale, **kw, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert MF.matmul_fused.instance[0] == ("mma_t" if m <= 16 else "mma")
    torch.testing.assert_close(out.float(),
                               matmul_fused_ref(a, w, scale, **kw).float(),
                               **gemm_tol(torch.bfloat16, k))
    assert torch.equal(out, matmul_fused(a, w, scale, **kw, bm=bm, bk=bk,
                                         bn=bn))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k,tiles,pixel", [
    (1, 21, 16, 16, 16, (7, 19, 16, 16), (0, 20, 8, 0)),
    (2, 14, 14, 16, 48, (5, 5, 16, 24), (1, 13, 7, 3)),
])
def test_wgrad_keeps_an_inf_where_the_oracle_does(dev, dtype, n, h, w, c, k,
                                                  tiles, pixel):
    """Row 13 with +Inf in the last real pixel of a tile whose pixel
    slots pad to whole k-steps, and in the input row past the last window
    of a ragged image edge: dW is +-Inf exactly where the fp32 oracle is
    (the slots without an output pixel read a zero chunk, not the Inf:
    0 x Inf would be NaN), and agrees elsewhere."""
    x, _, g = conv_case(dev, dtype, n, h, w, c, k, 3, 3, 1, seed=h)
    x[pixel] = float("inf")
    bx, by, bc, bk = tiles
    dw = conv2d_wgrad_block(x, g, 3, 3, bx=bx, by=by, bc=bc, bk=bk)
    want = conv2d_wgrad_block_ref(x, g, 3, 3, 1)
    bad = ~torch.isfinite(want)
    assert bad.any() and not want.isnan().any()
    assert torch.equal(~torch.isfinite(dw), bad)
    assert torch.equal(dw[bad], want[bad])
    grad_close(dw[~bad], want[~bad], torch.float32)
