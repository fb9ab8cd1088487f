"""Kernel rows 1 and 2 (``flash_decode``, ``flash_decode_fp8``) as
redesigned for the H100, on the CPU.

* The design: a numpy emulation of one launch of ``csrc/decode_mma.cuh``
  -- the (splits, Hkv, B x row tiles) grid of ``decode_grid``, each
  block's page-aligned run of its m16 row tile's visible pages
  (``page_run``), the ring's steps of whole pages, the step's 16-key
  chunks taken by the four warps in turn, each warp's online softmax in
  log2 units with the TPU kernel's NaN guards, P . V with P split into a
  bf16 high part and its bf16 residual, the warps' merge in warp order
  and the cluster's merge in run order -- against JAX's ``flash_decode``
  and ``flash_decode_fp8`` in interpret mode and the plain versions:
  q_span 1 and > 1 (more than one row tile), window and logit cap, head
  dims 16, 96, 128 and 256, lengths 1 and exact page multiples, rows
  whose later splits see nothing, drawn fp8 scales, every split count.
* The fill rule at granite's 8 slots, at 1 and at many rows; the grid.
* The footprint mirrors the ``.cu``'s constants (read from the source);
  the model's pages at granite stay 32 (bf16) and 64 (fp8 pool).
* The wrappers launch with the grid's split count (the loader
  monkeypatched, meta tensors: no card) and refuse what the kernel does
  not take.

Tolerances: the emulation and JAX's kernel compute the same fp32
function from the same bf16 (or e4m3) values; they differ in summation
order, in exp2 against exp, and in P's residual rounding (2^-17 of each
p), all under 1e-5 of the O(1) outputs: atol = rtol = 2e-5.  One bf16
rounding of P (2^-9) would not hold that (shown below).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro_torch.core.hopper_adapter import (default_smem_budget,
                                             flash_decode_tile_candidates)
from repro_torch.kernels import flash_decode as FD
from test_torch_oproj import _Props, _Stream, merge, split_rows

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "decode_mma.cuh").read_text()
TOL = dict(atol=2e-5, rtol=2e-5)
NEG = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)


def bf16(x):
    """Round fp32 to bf16 (nearest even) and back, as the card does."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def e4m3(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .to(torch.float8_e4m3fn).float().numpy()


def page_run(k_lo, k_hi, page, n, sp):
    """``attn::page_run``: pages [first, end) of split sp of n."""
    p0, p1 = k_lo // page, -(-k_hi // page)
    per = -(-(p1 - p0) // n) if p1 > p0 else 0
    first = min(p1, p0 + sp * per)
    return first, min(p1, first + per)


def emulate(q, kp, vp, bt, lengths, *, window=None, cap=None, q_span=1,
            k_scale=None, v_scale=None, splits=None, split_p=True):
    """One launch of the bf16 decode core on bf16-valued q and bf16- or
    e4m3-valued pages (fp32 arrays).  Returns the fp32 output (before its
    bf16 cast) and, per (b, h, tile, split), the block's run and the keys
    each warp scored."""
    b, hkv, gtot, d = q.shape
    page, nb = kp.shape[1], bt.shape[1]
    groups = gtot // q_span
    rows_t, chunk = FD.DECODE_ROWS, FD.DECODE_CHUNK
    tiles = -(-gtot // rows_t)
    kvb = 1 if k_scale is not None else 2
    if splits is None:
        splits = FD.decode_grid(b, hkv, gtot, page, nb, d, kvb)[0]
    spages = FD.decode_step_pages(page, d)
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    out = np.full(q.shape, np.nan, np.float32)
    record = {}
    for bi in range(b):
        n = int(lengths[bi])
        for h in range(hkv):
            s_scale = np.float32(scale * np.float32(
                1.0 if k_scale is None else k_scale[h]))
            for tile in range(tiles):
                t0 = tile * rows_t
                nr = min(rows_t, gtot - t0)
                qt = np.zeros((rows_t, d), np.float32)
                qt[:nr] = q[bi, h, t0:t0 + nr]
                t_last = t0 + nr - 1
                k_hi = min(n + t_last // groups, nb * page)
                k_lo = max(0, n - 1 + t0 // groups - window + 1) \
                    if window else 0
                qpos = np.array([n - 1 + (t0 + r) // groups if r < nr
                                 else -1 for r in range(rows_t)])
                parts = []
                for sp in range(splits):
                    first, end = page_run(k_lo, k_hi, page, splits, sp)
                    m = np.full((4, rows_t), NEG, np.float32)
                    lsum = np.zeros((4, rows_t), np.float32)
                    acc = np.zeros((4, rows_t, d), np.float32)
                    seen = [[] for _ in range(4)]
                    for st in range(-(-(end - first) // spages)):
                        key0 = (first + st * spages) * page
                        n_keys = min(k_hi, min(end, first + (st + 1)
                                               * spages) * page) - key0
                        for ch in range(-(-n_keys // chunk)):
                            w = ch % FD.DECODE_WARPS
                            kpos = key0 + ch * chunk + np.arange(chunk)
                            real = kpos < key0 + n_keys
                            seen[w] += kpos[real].tolist()
                            k = np.zeros((chunk, d), np.float32)
                            v = np.zeros((chunk, d), np.float32)
                            kr = kpos[real]
                            k[real] = kp[bt[bi, kr // page], kr % page, h]
                            v[real] = vp[bt[bi, kr // page], kr % page, h]
                            x = (qt @ k.T).astype(np.float32) * s_scale
                            if cap is not None:
                                x = (np.float32(cap) * np.tanh(
                                    x / np.float32(cap))).astype(np.float32)
                            ok = real[None, :] & \
                                (kpos[None, :] <= qpos[:, None])
                            if window:
                                ok &= kpos[None, :] > qpos[:, None] - window
                            x = np.where(ok, x * LOG2E, NEG)
                            m_new = np.maximum(m[w], x.max(axis=1))
                            m_sub = np.where(m_new <= NEG / 2, 0, m_new)
                            alpha = np.where(
                                m[w] <= NEG / 2, 0,
                                np.exp2(np.minimum(m[w] - m_new, 0)))
                            p = np.where(x <= NEG / 2, 0, np.exp2(
                                x - m_sub[:, None])).astype(np.float32)
                            lsum[w] = lsum[w] * alpha + p.sum(axis=1)
                            acc[w] *= alpha[:, None]
                            hi = bf16(p)
                            acc[w] += hi @ v
                            if split_p:
                                acc[w] += bf16(p - hi) @ v
                            m[w] = m_new
                    # the warps in warp order, then the block's partial
                    ok = lsum > 0
                    mx = np.where(ok, m, NEG).max(axis=0)
                    o = np.zeros((rows_t, d), np.float32)
                    den = np.zeros(rows_t, np.float32)
                    for w in range(4):
                        wt = np.where(ok[w], np.exp2(m[w] - mx), 0) \
                            .astype(np.float32)
                        o = (o + wt[:, None] * acc[w]).astype(np.float32)
                        den = (den + wt * lsum[w]).astype(np.float32)
                    parts.append((o, mx, den))
                    record[bi, h, tile, sp] = ((first, end), seen)
                # the cluster's runs in run order
                mx = np.max([np.where(dn > 0, mm, NEG)
                             for _, mm, dn in parts], axis=0)
                o = np.zeros((rows_t, d), np.float32)
                den = np.zeros(rows_t, np.float32)
                for oj, mj, dj in parts:
                    wt = np.where(dj > 0, np.exp2(mj - mx), 0) \
                        .astype(np.float32)
                    o = (o + wt[:, None] * oj).astype(np.float32)
                    den = (den + wt * dj).astype(np.float32)
                vs = np.float32(1.0 if v_scale is None else v_scale[h])
                res = np.where(den[:, None] > 0,
                               o * vs / np.where(den > 0, den, 1)[:, None],
                               0)
                out[bi, h, t0:t0 + nr] = res[:nr]
    return out, record


def case(b, hkv, g, d, page, nb, q_span, lengths, seed=0, fp8=False):
    """bf16-valued q and pages (e4m3-valued with ``fp8``) over a
    shuffled pool, scratch page 0 past each request's span."""
    rng = np.random.default_rng(seed + d + page + q_span)
    n_pages = b * nb + 1
    q = bf16(rng.standard_normal((b, hkv, q_span * g, d)))
    cast = e4m3 if fp8 else bf16
    kp = cast(rng.standard_normal((n_pages, page, hkv, d)))
    vp = cast(rng.standard_normal((n_pages, page, hkv, d)))
    bt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    for i, n in enumerate(lengths):
        bt[i, -(-(n + q_span - 1) // page):] = 0
    return q, kp, vp, bt, np.array(lengths, np.int32)


# b, hkv, g, d, page, nb, q_span, lengths, window, cap
CASES = [
    # granite's grouping at decode; lengths 1 and exact page multiples
    (4, 2, 4, 128, 16, 8, 1, [1, 32, 100, 128], None, None),
    (3, 2, 4, 128, 16, 8, 1, [17, 64, 90], 20, 30.0),
    # chunks: 4 positions x G 2 (one tile), 8 x 4 (two tiles), window
    (2, 2, 2, 16, 8, 8, 4, [1, 40], None, None),
    (2, 1, 4, 64, 16, 6, 8, [9, 60], 13, None),
    (2, 2, 4, 96, 16, 6, 1, [33, 80], 25, 15.0),
    (2, 1, 4, 256, 8, 8, 2, [8, 50], None, 20.0),
    # one row, 8 splits: a 5-key row's runs after the first see nothing
    (1, 2, 4, 128, 16, 8, 1, [5], None, None),
    (1, 1, 2, 32, 32, 4, 1, [128], None, None),
]


def jax_out(arrs, fp8=False, scales=None, **kw):
    q, kp, vp, bt, ln = arrs
    if fp8:
        return np.asarray(jfd.flash_decode_fp8(
            jnp.asarray(q), jnp.asarray(kp).astype(jnp.float8_e4m3fn),
            jnp.asarray(vp).astype(jnp.float8_e4m3fn),
            jnp.asarray(scales[0]), jnp.asarray(scales[1]), jnp.asarray(bt),
            jnp.asarray(ln), **kw, interpret=True))
    return np.asarray(jfd.flash_decode(*map(jnp.asarray, arrs), **kw,
                                       interpret=True))


@pytest.mark.parametrize("b,hkv,g,d,page,nb,q_span,lengths,window,cap",
                         CASES)
def test_emulated_launch_matches_jax_and_plain(b, hkv, g, d, page, nb,
                                               q_span, lengths, window, cap):
    """The emulated launch at the grid's split count equals JAX's kernel
    (interpret mode) and the plain version to 2e-5; its runs cut the
    visible pages in order, and every visible key is scored once."""
    arrs = case(b, hkv, g, d, page, nb, q_span, lengths)
    kw = dict(window=window, logit_cap=cap, q_span=q_span)
    got, record = emulate(*arrs, window=window, cap=cap, q_span=q_span)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, jax_out(arrs, **kw), **TOL)
    plain = FD.paged_attention_ref(*map(torch.from_numpy, arrs), **kw)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    # the runs: consecutive, page-aligned, the visible keys once each
    splits = FD.decode_grid(b, hkv, q_span * g, page, nb, d)[0]
    for (bi, h, tile, sp), ((first, end), seen) in record.items():
        if sp + 1 < splits:
            assert record[bi, h, tile, sp + 1][0][0] == end
        keys = sorted(k for w in seen for k in w)
        assert keys == sorted(set(keys))
        assert all(first * page <= k < end * page for k in keys)
    if q_span > 1:
        return
    # at decode: each run as row 3's tests compute one (split_rows: the
    # plain softmax over its keys) merged by their max and sum (merge)
    q, kp, vp, bt, ln = arrs
    for bi in range(b):
        for h in range(hkv):
            parts = []
            for sp in range(splits):
                first, end = record[bi, h, 0, sp][0]
                parts.append(split_rows(
                    q[bi, h], kp, vp, bt[bi], int(ln[bi]), h, first * page,
                    max(first * page, min(int(ln[bi]), end * page)), window,
                    cap))
            np.testing.assert_allclose(got[bi, h], merge(parts), **TOL)


@pytest.mark.parametrize("splits", range(1, 9))
def test_every_split_count_gives_the_same_rows(splits):
    """Split counts 1 to 8 (the ``n_blocks`` cap) at one shape: each
    within 2e-5 of JAX's kernel, and of each other."""
    arrs = case(2, 2, 4, 128, 16, 8, 1, [7, 120])
    got, record = emulate(*arrs, window=50, splits=splits)
    np.testing.assert_allclose(got, jax_out(arrs, window=50), **TOL)
    runs = [record[1, 0, 0, sp][0] for sp in range(splits)]
    assert runs[0][0] == (120 - 50) // 16 and runs[-1][1] == 8
    one, _ = emulate(*arrs, window=50, splits=1)
    np.testing.assert_allclose(got, one, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("q_span,window,cap", [(1, None, None),
                                               (4, 23, 30.0)])
def test_emulated_fp8_launch_matches_jax_and_plain(q_span, window, cap):
    """e4m3 pages widened to bf16 (exact), drawn per-head scales folded
    into the score scale (k) and the finished row (v): the emulation
    against JAX's ``flash_decode_fp8`` (interpret mode) and the plain
    version, 2e-5."""
    arrs = case(3, 2, 4, 128, 32, 4, q_span, [1, 64, 100], fp8=True)
    rng = np.random.default_rng(q_span)
    ks, vs = (rng.uniform(0.5, 2.0, 2).astype(np.float32) for _ in range(2))
    kw = dict(window=window, logit_cap=cap, q_span=q_span)
    got, _ = emulate(*arrs, window=window, cap=cap, q_span=q_span,
                     k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got, jax_out(arrs, True, (ks, vs), **kw),
                               **TOL)
    q, kp, vp, bt, ln = map(torch.from_numpy, arrs)
    plain = FD.paged_attention_fp8_ref(
        q, kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn),
        torch.from_numpy(ks), torch.from_numpy(vs), bt, ln, **kw)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


def test_one_bf16_rounding_of_p_would_not_hold_the_tolerance():
    """P split into bf16 high and residual parts keeps the fp32
    tolerance; P rounded once to bf16 misses it (the difference the
    split avoids)."""
    arrs = case(2, 2, 4, 128, 16, 8, 1, [100, 128])
    want = jax_out(arrs)
    split, _ = emulate(*arrs)
    once, _ = emulate(*arrs, split_p=False)
    np.testing.assert_allclose(split, want, **TOL)
    assert np.abs(once - want).max() > 10 * np.abs(split - want).max()


# ---------------------------------------------------- the fill rule --


@pytest.mark.parametrize("b,hkv,rows,nb,want", [
    (8, 8, 4, 16, 3),       # granite's decode at 8 slots: 192 blocks
    (8, 8, 4, 8, 3),        # the fp8 page (64): 8 pages a row
    (1, 8, 4, 16, 16),      # one row: the cluster limit
    (1, 8, 4, 8, 8),        # one row at page 64: n_blocks
    (1, 8, 256, 16, 2),     # a 64-token chunk: 16 row tiles x 8 heads
    (24, 8, 4, 16, 1),      # 192 tiles fill the card alone
    (64, 8, 4, 16, 1),
    (2, 2, 4, 3, 3),        # capped by the pages a row can hold
])
def test_fill_rule(b, hkv, rows, nb, want):
    """The least split count whose blocks fill the card's 132 SMs,
    capped by ``n_blocks`` and the cluster limit."""
    got = FD.decode_splits(b, hkv, rows, nb)
    assert got == want
    tiles = b * hkv * -(-rows // FD.DECODE_ROWS)
    if want not in (nb, FD.MAX_CLUSTER):
        assert tiles * want >= 132 > tiles * (want - 1)


def test_grid_at_granite_and_past_the_two_block_budget():
    """``decode_grid``: (splits, cluster, blocks); a footprint past the
    two-block budget caps the cluster at the portable 8."""
    assert FD.decode_grid(8, 8, 4, 32, 16, 128) == (3, 3, 192)
    assert FD.decode_grid(8, 8, 4, 64, 8, 128, 1) == (3, 3, 192)
    assert FD.decode_grid(1, 8, 256, 32, 16, 128) == (2, 2, 256)
    assert FD.decode_smem_bytes(128, 128) > default_smem_budget()
    assert FD.decode_grid(1, 8, 4, 128, 32, 128) == (8, 8, 64)


def test_grid_is_cached_by_shape():
    """The wrapper asks ``decode_grid`` once a layer a decode step: the
    second ask at a shape is a cache hit, and gives the same grid."""
    FD.decode_grid.cache_clear()
    first = FD.decode_grid(8, 8, 4, 32, 16, 128)
    assert FD.decode_grid(8, 8, 4, 32, 16, 128) == first
    info = FD.decode_grid.cache_info()
    assert (info.hits, info.misses) == (1, 1)


# ----------------------------------------------------- the footprint --


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def test_footprint_mirrors_the_kernel():
    """The Python constants are the .cu's; the footprint is its
    ``smem_bytes``: max(ring (+ fp8 widening scratch), merge rows) + the
    q tile, the page table and the (max, sum) pairs."""
    assert cu_const("kWarps") == FD.DECODE_WARPS
    assert cu_const("kRows") == FD.DECODE_ROWS
    assert cu_const("kChunk") == FD.DECODE_CHUNK
    assert cu_const("kStages") == FD.DECODE_STAGES
    assert cu_const("kTable") == FD.DECODE_TABLE
    assert cu_const("kPad") == FD.DECODE_PAD
    assert cu_const("kMaxCluster") == FD.MAX_CLUSTER
    assert "return D <= 128 ? 4 * kChunk : 2 * kChunk;" in CU
    assert "size_t(kWarps + 1) * kRows * 2 * sizeof(float)" in CU
    tail = 16 * 128 * 2 + 128 * 4 + 5 * 16 * 2 * 4
    # granite, page 32, bf16: two pages a step, two steps
    assert FD.decode_step_pages(32, 128) == 2
    assert FD.decode_smem_bytes(32, 128) == 2 * 2 * 64 * 128 * 2 + tail \
        == 70_784
    # the fp8 page 64: one page a step, bytes, 16 keys of scratch a warp
    assert FD.decode_smem_bytes(64, 128, 1) == \
        2 * 2 * 64 * 128 + 4 * 16 * 128 * 2 + tail == 54_400
    # a ragged page: 48 keys a step in whole chunks; 200 (fp8): 208 rows
    assert FD.decode_step_rows(48, 128) == 48
    assert FD.decode_step_rows(200, 128) == 208
    assert FD.decode_step_rows(24, 128) == 48
    # head dim 256: 32-key steps; 16 at the 32-wide instance's width
    assert FD.decode_step_pages(16, 256) == 2
    assert FD.decode_smem_bytes(16, 16) == FD.decode_smem_bytes(16, 32)
    # the merge rows overlay the ring where they are larger (D = 32)
    assert FD.decode_smem_bytes(64, 32) == \
        max(2 * 2 * 64 * 32 * 2, 4 * 16 * 40 * 4) + 16 * 32 * 2 + 512 + 640
    # the fp32 instance keeps attn_rows' footprint
    assert FD.page_smem_bytes(32, 128, 4) == \
        FD.smem_bytes_required(32, 4, 128, 4)
    assert FD.page_smem_bytes(32, 128, 2) == FD.decode_smem_bytes(32, 128)


@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("kv", [None, 1])
def test_pages_fit_the_core(d, kv):
    """Every page the bf16 keys offer fits the two-block budget under
    the decode core's footprint and divides max_seq; at granite the
    model's pages stay 32 (bf16) and 64 (fp8 pool)."""
    pages = flash_decode_tile_candidates(4, 512, d, 2, kv_bytes=kv)
    assert pages
    for (page,) in pages:
        assert 512 % page == 0
        assert FD.page_smem_bytes(page, d, 2, kv) <= default_smem_budget()
    if d == 128:
        assert pages[-1] == ((32,) if kv is None else (64,))


# ------------------------------------------------------- the wrapper --


@pytest.fixture
def fake_card(monkeypatch):
    """``_build.load`` returning a C function that records its arguments
    and reports success; meta tensors stand in for CUDA ones (the
    generic checks skipped, the launch checks kept)."""
    from repro_torch.kernels import _build
    calls = []

    def load(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: _Props())
    monkeypatch.setattr(FD, "_check", lambda *a, **k: None)
    return calls


def meta_args(b, hkv, rows, d, dtype=torch.bfloat16, page=32, nb=16,
              kv=None):
    m = dict(device="meta")
    kv = kv or dtype
    return (torch.zeros((b, hkv, rows, d), dtype=dtype, **m),
            torch.zeros((b * nb + 1, page, hkv, d), dtype=kv, **m),
            torch.zeros((b * nb + 1, page, hkv, d), dtype=kv, **m),
            torch.zeros((b, nb), dtype=torch.int32, **m),
            torch.zeros((b,), dtype=torch.int32, **m))


@pytest.mark.parametrize("b,hkv,rows,q_span,page,nb", [
    (8, 8, 4, 1, 32, 16), (1, 8, 256, 64, 32, 16), (64, 8, 4, 1, 32, 16),
    (2, 2, 4, 1, 128, 4)])
def test_wrapper_launches_the_grid(fake_card, monkeypatch, b, hkv, rows,
                                   q_span, page, nb):
    """bf16: one launch at ``decode_grid``'s split count, recorded as
    the tensor-core instance; fp32: one split, ``attn_rows``, whatever
    ``decode_grid`` gives; fp8 under bf16 q rows at the fp8 grid."""
    args = meta_args(b, hkv, rows, 128, page=page, nb=nb)
    with torch.no_grad():
        out = FD.flash_decode(*args, q_span=q_span)
    assert out.shape == args[0].shape and out.dtype == torch.bfloat16
    (symbol, call), = fake_card
    splits = FD.decode_grid(b, hkv, rows, page, nb, 128)[0]
    # batch, hkv, gtot, q_span, page, n_blocks, window, cap, splits
    assert symbol == "flash_decode_fwd"
    assert call[8:17] == (b, hkv, rows, q_span, page, nb, 0, 0.0, splits)
    assert FD.flash_decode.instance == ("mma", splits)
    with torch.no_grad():
        f32 = meta_args(b, hkv, rows, 128, torch.float32,
                        page=min(page, 64), nb=nb)
        FD.flash_decode(*f32, q_span=q_span)
        assert fake_card[-1][1][16] == 1
        assert FD.flash_decode.instance == ("rows", 1)
        with monkeypatch.context() as mp:
            mp.setattr(FD, "decode_grid", lambda *a: (5, 5, 0))
            FD.flash_decode(*args, q_span=q_span)
            assert fake_card[-1][1][16] == 5
            FD.flash_decode(*f32, q_span=q_span)
            assert fake_card[-1][1][16] == 1
        f8 = meta_args(b, hkv, rows, 128, page=page, nb=nb,
                       kv=torch.float8_e4m3fn)
        ones = torch.ones(hkv, device="meta")
        FD.flash_decode_fp8(f8[0], f8[1], f8[2], ones, ones, *f8[3:],
                            q_span=q_span)
    symbol, call = fake_card[-1]
    assert symbol == "flash_decode_fp8_fwd"
    assert call[18] == FD.decode_grid(b, hkv, rows, page, nb, 128, 1)[0]
    assert FD.flash_decode_fp8.instance[0] == "mma"


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_card):
    """A page whose ring overflows the card's shared memory, and more row
    tiles than a grid holds raise before a launch."""
    with torch.no_grad():
        with pytest.raises(ValueError, match="shared memory"):
            FD.flash_decode(*meta_args(2, 2, 4, 128, page=256, nb=2))
        with pytest.raises(ValueError, match="row tiles"):
            FD.flash_decode(*meta_args(70_000, 1, 4, 16, page=16, nb=1))
    assert not fake_card
    # attn_rows (fp32) still takes its larger pages
    with torch.no_grad():
        FD.flash_decode(*meta_args(2, 2, 4, 128, torch.float32, page=96,
                                   nb=4))
    assert len(fake_card) == 1
