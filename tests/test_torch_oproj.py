"""Kernel row 3 (``flash_decode_oproj``) as redesigned for the H100, on
the CPU.

* The design: a numpy emulation of one launch of
  ``csrc/flash_decode_oproj.cu`` -- the (slice, head) grid of
  ``oproj_grid``, each cluster of a head's slices running the head's
  attention once per batch row (block r: rows r, r + c, ... of each group
  of up to 16) into NaN-filled shared memory, the gather of the other
  blocks' rows through distributed shared memory, the wo slice streamed
  in 16 KB steps (zero past the slab and the slice) with fp32 fused
  multiply-adds over the G*D rows in order, the fp32 partials into the
  (Hkv, B, E) workspace, and the last block of a slice to arrive (blocks
  arrive in a random order) summing the heads in head order and
  resetting its counter -- against JAX's ``flash_decode_oproj`` in
  interpret mode and ``paged_attention_oproj_ref``: Hkv 8, 16 and 32, a
  ragged last E slice, ``window`` and ``logit_cap``, head dims 16 and
  96, more than 16 batch rows.
* The grid: the slice by the fill rule, the cluster, the counters.
* The footprint mirrors the ``.cu``'s (its constants read from the
  source), and the page search prices it.
* The wrapper launches the kernel with the grid's slice and cluster, a
  workspace and zeroed counters (the loader monkeypatched, meta tensors:
  no card), and refuses what the kernel does not take.
* ``oproj_hbm_bytes`` counts ``wo`` once a call where JAX's kernel reads
  it once per batch row.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro_torch.core.hopper_adapter import (default_smem_budget,
                                             flash_decode_oproj_tile_candidates)
from repro_torch.kernels import flash_decode as FD

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "flash_decode_oproj.cu").read_text()
THREADS = 128    # attn::kThreads


def _ceil(a, b):
    return -(-a // b)


def fma32(a, b, c):
    """fmaf in numpy: the fp32 product is exact in fp64, one rounding."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def case(b, hkv, g, d, e, seed=3, page=8, nb=5):
    """fp32 inputs (numpy): ragged lengths over a shuffled pool, scratch
    page 0 past each request's pages, wo scaled so outputs are O(1)."""
    rng = np.random.default_rng(seed + b + hkv + d + e)
    lengths = np.array([(13 * i + 5) % (page * nb) + 1 for i in range(b)],
                       np.int32)
    n_pages = b * nb + 1
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb).reshape(b, nb)).astype(np.int32)
    for i, n in enumerate(lengths):
        bt[i, -(-int(n) // page):] = 0
    wo = (rng.standard_normal((hkv, g * d, e))
          * (hkv * g * d) ** -0.5).astype(np.float32)
    return q, kp, vp, bt, lengths, wo


def split_rows(q, kp, vp, bt, length, h, start, end, window, cap):
    """attn_rows over keys [start, end) of one decode row (head h): each
    query row's rows normalised by its own sum, its running max and sum
    (fp32; a split that sees no key gives zeros, max -1e30, sum 0)."""
    g, d = q.shape
    page = kp.shape[1]
    kpos = np.arange(start, end)
    qpos = length - 1
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    kpos = kpos[ok]
    o = np.zeros((g, d), np.float32)
    m = np.full(g, -1e30, np.float32)
    l = np.zeros(g, np.float32)
    if kpos.size:
        k = kp[bt[kpos // page], kpos % page, h]
        v = vp[bt[kpos // page], kpos % page, h]
        sc = (q @ k.T * np.float32(d ** -0.5)).astype(np.float32)
        if cap is not None:
            sc = (cap * np.tanh(sc / cap)).astype(np.float32)
        m = sc.max(axis=1)
        p = np.exp(sc - m[:, None]).astype(np.float32)
        l = p.sum(axis=1)
        o = (p @ v / l[:, None]).astype(np.float32)
    return o, m, l


def merge(parts):
    """Every block's merge of a row's runs: each run weighted by its sum
    at the common max over the weights' sum, added in run order (a zero
    weight adds nothing)."""
    ms = np.stack([m for _, m, _ in parts])
    ls = np.stack([l for _, _, l in parts])
    mx = np.where(ls > 0, ms, -1e30).max(axis=0)
    wts = [np.where(l > 0, l * np.exp(m - mx), 0).astype(np.float32)
           for _, m, l in parts]
    den = np.zeros_like(ls[0])
    for wt in wts:
        den = (den + wt).astype(np.float32)
    out = np.zeros_like(parts[0][0])
    for (o, _, _), wt in zip(parts, wts):
        wn = np.where(den > 0, wt / np.where(den > 0, den, 1), 0)
        wn = wn.astype(np.float32)[:, None]
        out = np.where(wn != 0, fma32(wn, o, out), out)
    return out


def emulate(q, kp, vp, bt, lengths, wo, *, window=None, logit_cap=None,
            itemsize=4, seed=0):
    """One launch of the redesigned kernel; returns (out, workspace,
    counters after the launch)."""
    b, hkv, g, d = q.shape
    e = wo.shape[2]
    n_rows = g * d
    width, n_slices, c = FD.oproj_grid(hkv, e)
    rb = FD.oproj_group_rows(b)
    kr = FD.OPROJ_STEP_BYTES // (width * itemsize)
    # the attention of each (batch row, head): attn_rows, unchanged (its
    # lanes are held against JAX elsewhere); the plain fp32 rows here
    attn = FD.paged_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, bt, lengths)), window=window,
        logit_cap=logit_cap).numpy().reshape(b, hkv, n_rows)
    ws = np.full((hkv, b, e), np.nan, np.float32)
    out = np.full((b, e), np.nan, np.float32)
    n_groups = -(-b // rb)
    counters = np.zeros(n_groups * n_slices, np.int64)
    rng = np.random.default_rng(seed)
    page = kp.shape[1]
    for g0 in range(0, b, rb):
        rows = min(rb, b - g0)
        n_split = FD.oproj_splits(c, rows)
        # split j of row r: pages p0 + j per .. of its visible pages
        splits = {}
        for r in range(rows if n_split > 1 else 0):
            n = int(lengths[g0 + r])
            p0 = (max(0, n - window) if window else 0) // page
            per = _ceil(_ceil(n, page) - p0, n_split)
            for h in range(hkv):
                parts = []
                for j in range(n_split):
                    st = (p0 + j * per) * page
                    parts.append(split_rows(
                        q[g0 + r, h], kp, vp, bt[g0 + r], n, h, st,
                        max(st, min(n, st + per * page)), window,
                        logit_cap))
                splits[r, h] = merge(parts).reshape(n_rows)
        x = {}   # (slice, head) -> the block's [n_rows][rb] rows
        for h in range(hkv):
            for s in range(n_slices):
                rank = s % c
                xs = np.full((n_rows, rb), np.nan, np.float32)
                if n_split == 1:
                    for r in range(rank, rows, c):
                        xs[:, r] = attn[g0 + r, h]
                elif rank < rows * n_split and rank % n_split == 0:
                    xs[:, rank // n_split] = splits[rank // n_split, h]
                x[s, h] = xs
        gathered = {}
        for (s, h), xs in x.items():
            rank, base = s % c, s - s % c
            mine = xs.copy()
            for slot in range(rb):
                owner = slot * n_split if n_split > 1 else slot % c
                if slot >= rows:
                    mine[:, slot] = 0.0
                elif owner != rank:
                    mine[:, slot] = x[base + owner, h][:, slot]
            assert np.all(np.isfinite(mine))
            gathered[s, h] = mine
        # the slab, block by block, and the arrivals in a random order
        for idx in rng.permutation(hkv * n_slices):
            h, s = divmod(int(idx), n_slices)
            e0 = s * width
            e_ok = min(width, e - e0)
            xs = gathered[s, h]
            acc = np.zeros((rb, width), np.float32)
            for r0 in range(0, n_rows, kr):
                step = np.zeros((kr, width), np.float32)
                k_ok = min(kr, n_rows - r0)
                step[:k_ok, :e_ok] = wo[h, r0:r0 + k_ok, e0:e0 + e_ok]
                for r in range(k_ok):
                    acc = fma32(xs[r0 + r][:, None], step[r][None, :], acc)
            ws[h, g0:g0 + rows, e0:e0 + e_ok] = acc[:rows, :e_ok]
            cnt = (g0 // rb) * n_slices + s
            counters[cnt] += 1
            if counters[cnt] == hkv:       # the last of the slice's heads
                total = np.zeros((rows, e_ok), np.float32)
                for hh in range(hkv):
                    part = ws[hh, g0:g0 + rows, e0:e0 + e_ok]
                    assert np.all(np.isfinite(part))
                    total = (total + part).astype(np.float32)
                out[g0:g0 + rows, e0:e0 + e_ok] = total
                counters[cnt] = 0
    return out, ws, counters


# B, Hkv, G, D, E, window, cap: granite's grouping at Hkv 8 (slices of
# 128 at E 264: three, the last 8 columns wide, one cluster of 3); Hkv
# 16 and 32 (four and three slices of 128, one cluster each, the last
# slice ragged); head dims 16 and 96; window and cap; 18 and 20 batch
# rows (two groups of 16)
CASES = [
    (4, 8, 4, 32, 264, None, None),
    (3, 8, 4, 32, 264, 11, 20.0),
    (3, 16, 1, 16, 392, None, None),
    (2, 32, 1, 16, 264, 9, None),
    (5, 2, 2, 96, 136, None, 15.0),
    (18, 2, 2, 16, 72, 7, None),
    (20, 4, 1, 32, 264, None, None),
    # more blocks in a cluster than rows: each row's pages split 4 ways
    # (2 rows, cluster 8) and 2 ways with window and cap (3 rows); 20
    # rows: a group of 16 whole, then 4 rows split 2 ways
    (2, 8, 4, 32, 1024, None, None),
    (3, 2, 2, 96, 1024, 11, 15.0),
    (20, 2, 1, 16, 1024, None, None),
]


@pytest.mark.parametrize("b,hkv,g,d,e,window,cap", CASES)
def test_emulated_launch_matches_jax_and_plain(b, hkv, g, d, e, window, cap):
    """The emulated launch equals JAX's kernel (interpret mode) and the
    plain version in fp32 to 1e-5 abs + 1e-5 rel (the sums differ in
    order only: 2 G D Hkv fp32 terms of O(1 / sqrt(G D Hkv))); each
    workspace element the store reaches is written once, the counters end
    at zero, and another arrival order gives the same bits."""
    arrs = case(b, hkv, g, d, e)
    kw = dict(window=window, logit_cap=cap)
    got, ws, counters = emulate(*arrs, **kw)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(ws))
    assert not counters.any()
    again, _, _ = emulate(*arrs, **kw, seed=1)
    np.testing.assert_array_equal(got, again)
    plain = FD.paged_attention_oproj_ref(*map(torch.from_numpy, arrs),
                                         **kw).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    jax_out = np.asarray(jfd.flash_decode_oproj(
        *map(jnp.asarray, arrs), **kw, interpret=True))
    np.testing.assert_allclose(got, jax_out, atol=1e-5, rtol=1e-5)


def test_emulated_launch_in_bf16_matches_plain():
    """bf16 operands (the fp32 rows times a bf16 wo, one cast at the
    end): the emulation on the bf16 values against the plain version at
    bf16 output rounding (2e-2 abs + 1e-2 rel)."""
    q, kp, vp, bt, lengths, wo = case(6, 8, 4, 32, 264)
    r = [torch.from_numpy(t).bfloat16() for t in (q, kp, vp, wo)]
    f = [t.float().numpy() for t in r]
    got, _, _ = emulate(f[0], f[1], f[2], bt, lengths, f[3], itemsize=2)
    got = torch.from_numpy(got).bfloat16().float().numpy()
    plain = FD.paged_attention_oproj_ref(
        r[0], r[1], r[2], torch.from_numpy(bt), torch.from_numpy(lengths),
        r[3]).float().numpy()
    np.testing.assert_allclose(got, plain, atol=2e-2, rtol=1e-2)


# ----------------------------------------------------------- the grid --


@pytest.mark.parametrize("hkv,e,grid", [
    (8, 4096, (256, 16, 16)),     # granite: 128 blocks
    (16, 1024, (128, 8, 8)),      # seamless-m4t-medium: 128 blocks
    (32, 3072, (256, 12, 12)),    # phi-3-vision: 384 blocks
    (2, 512, (128, 4, 4)),        # too few heads to fill: the narrowest
    (2, 64, (128, 1, 1)),         # the reduced granite: one slice
    (8, 264, (128, 3, 3)),        # a ragged last slice
    (8, 4352, (256, 17, 1)),      # 17 slices: no divisor up to 16
])
def test_grid_fills_the_card(hkv, e, grid):
    """The slice is the widest of ``OPROJ_SLICES`` whose Hkv * E / slice
    blocks reach ``OPROJ_BLOCKS``, else the narrowest; the cluster is the
    largest divisor of the slice count up to ``MAX_CLUSTER``."""
    assert FD.oproj_grid(hkv, e) == grid
    width, n, c = grid
    assert n == -(-e // width) and n % c == 0 and c <= FD.MAX_CLUSTER
    if hkv * -(-e // max(FD.OPROJ_SLICES)) >= FD.OPROJ_BLOCKS:
        assert width == max(FD.OPROJ_SLICES)


def test_granite_decode_runs_128_blocks_and_reads_wo_once():
    """At granite's decode (B 8, Hkv 8, E 4096) the grid is 128 blocks
    and ``oproj_hbm_bytes`` counts ``wo`` once, where JAX's count reads
    it once per batch row."""
    width, n, _ = FD.oproj_grid(8, 4096)
    assert 8 * n == 128
    wo = 8 * 4 * 128 * 4096 * 2
    ours = FD.oproj_hbm_bytes(8, 8, 4, 128, 4096, 512, 32)
    theirs = jfd.oproj_hbm_bytes(8, 8, 4, 128, 4096, 512, 32)
    assert theirs - ours == 7 * wo - 2 * 8 * 8 * 4096 * 4
    # 20 rows: two groups, wo twice
    assert FD.oproj_hbm_bytes(20, 8, 4, 128, 4096, 512, 32) - \
        FD.oproj_hbm_bytes(16, 8, 4, 128, 4096, 512, 32) > wo


# ----------------------------------------------------- the footprint --


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def test_footprint_mirrors_the_kernel():
    """The Python constants are the .cu's, and the footprint is its
    ``smem_bytes``: the attention tiles or the wo ring, the larger, plus
    the group's fp32 rows at the true head dim."""
    assert cu_const("kMaxRows") == FD.OPROJ_MAX_ROWS
    assert cu_const("kStages") == FD.OPROJ_WO_STAGES
    assert cu_const("kStageBytes") == FD.OPROJ_STEP_BYTES
    assert "attn::kThreads * CPT" in CU
    assert all(w % THREADS == 0 and w // THREADS in (1, 2)
               for w in FD.OPROJ_SLICES)
    ring = FD.OPROJ_WO_STAGES * FD.OPROJ_STEP_BYTES
    # granite, page 32, bf16, 8 rows: the ring (65,536) over the tiles
    # (2 * 2 * 32 * 128 * 2 + 4 * 128 * 2 + 4 * 32 * 4 = 34,304)
    assert FD.smem_bytes_required(32, 4, 128) == 34304
    # plus one split's rows and its G (max, sum) pairs
    assert FD.oproj_smem_bytes_required(32, 4, 128, batch=8) == \
        ring + (9 * 4 * 128 + 2 * 4) * 4 == 84000
    # page 128: the tiles (133,632) over the ring; 16 rows past 8
    assert FD.oproj_smem_bytes_required(128, 4, 128, batch=9) == \
        FD.smem_bytes_required(128, 4, 128) + (17 * 4 * 128 + 8) * 4
    # B beyond 16 and E never grow it
    assert FD.oproj_smem_bytes_required(32, 4, 128, batch=64) == \
        FD.oproj_smem_bytes_required(32, 4, 128)
    # fp32, head dim 96 at the 128 instance: tiles at 128, rows at 96
    assert FD.oproj_smem_bytes_required(16, 1, 96, 4, batch=2) == \
        max(FD.smem_bytes_required(16, 4, 96, 4), ring) + (9 * 96 + 2) * 4
    assert "(size_t(rb + 1) * groups * hd + 2 * groups)" in CU
    assert cu_const("kMaxCluster") == FD.MAX_CLUSTER


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("g,d", [(4, 128), (1, 96), (8, 64), (2, 16)])
def test_pages_fit_the_footprint(dtype, g, d):
    """Every page the oproj key offers fits the two-block budget under
    the redesigned footprint (16 row slots), whatever E."""
    esz = 2 if dtype == "bfloat16" else 4
    budget = default_smem_budget()
    pages = flash_decode_oproj_tile_candidates(g, 512, d, 4096, esz)
    assert pages
    for (page,) in pages:
        assert FD.oproj_smem_bytes_required(page, g, d, esz) <= budget
    assert pages == flash_decode_oproj_tile_candidates(g, 512, d, 64, esz)


# ------------------------------------------------------- the wrapper --


class _Props:
    shared_memory_per_block_optin = 232_448


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake_card(monkeypatch):
    """``_build.load`` returning a C function that records its arguments
    and reports success (nothing is built or launched); meta tensors
    stand in for CUDA ones."""
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
    monkeypatch.setattr(FD, "_COUNTERS", {})
    return calls


def meta_args(b, hkv, g, d, e, dtype=torch.bfloat16, page=32, nb=16):
    m = dict(device="meta")
    return (torch.zeros((b, hkv, g, d), dtype=dtype, **m),
            torch.zeros((b * nb + 1, page, hkv, d), dtype=dtype, **m),
            torch.zeros((b * nb + 1, page, hkv, d), dtype=dtype, **m),
            torch.zeros((b, nb), dtype=torch.int32, **m),
            torch.zeros((b,), dtype=torch.int32, **m),
            torch.zeros((hkv, g * d, e), dtype=dtype, **m))


@pytest.mark.parametrize("b,hkv,g,d,e", [(8, 8, 4, 128, 4096),
                                         (20, 32, 1, 96, 3072),
                                         (2, 16, 1, 64, 1024)])
def test_wrapper_launches_the_grid(fake_card, b, hkv, g, d, e):
    """One launch with the grid's slice and cluster, an fp32 (Hkv, B, E)
    workspace and zeroed int32 counters, one per (group, slice), kept
    per device and grown when a launch needs more."""
    with torch.no_grad():
        out = FD.flash_decode_oproj(*meta_args(b, hkv, g, d, e))
    assert out.shape == (b, e) and out.dtype == torch.bfloat16
    (symbol, args), = fake_card
    assert symbol == "flash_decode_oproj_fwd"
    width, n, c = FD.oproj_grid(hkv, e)
    # batch, hkv, groups, page, n_blocks, e, slice, cluster
    assert args[11:19] == (b, hkv, g, 32, 16, e, width, c)
    counters = FD._COUNTERS[torch.device("meta")]
    assert counters.dtype == torch.int32
    assert counters.numel() == -(-b // FD.oproj_group_rows(b)) * n


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_card):
    """A wo that is not (Hkv, G*D, E), an E that is not whole 16-byte
    rows, and a page whose tiles overflow the card's shared memory raise
    before a launch."""
    args = meta_args(2, 2, 4, 128, 256)
    with torch.no_grad():
        with pytest.raises(ValueError, match="is not"):
            FD.flash_decode_oproj(*args[:5], args[5][:, :256])
        with pytest.raises(ValueError, match="multiple of 8"):
            FD.flash_decode_oproj(*args[:5], args[5][..., :252].contiguous())
        big = meta_args(2, 2, 4, 128, 256, page=256)
        with pytest.raises(ValueError, match="shared memory"):
            FD.flash_decode_oproj(*big)
    assert not fake_card
