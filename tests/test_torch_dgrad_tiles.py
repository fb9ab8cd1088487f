"""The dgrad GEMMs' tiles and their bf16 tensor-core instances (kernel
rows 7 and 8, ``csrc/matmul_bwd.cu`` over ``csrc/gemm_mma.cuh``).

* The warp grid: ``matmul_bwd.mma_layout`` at every ``"matmul_dgrad"``
  candidate of granite's four projection shapes at M = 2048 tokens, dA
  and dB: eight warps, fragments and fp32 sums a thread within the
  instance's limits, at most 1/8 of the computed rows empty, and both
  kernels' shared memory within the two-block budget.
* The staging: the Python mirror of the kernels' swizzle permutes each
  staged row's 16-byte chunks, and the 8 rows of every ``ldmatrix``
  sub-matrix fall into 8 bank groups, for the NT tile (rows of a
  reduction step of 16-128) and the TN tile (rows 16-128 wide).
* The launch: ``ops._matmul_da`` and ``_matmul_db`` ask ``best_schedule``
  and the wrappers launch its tiles with the instance's stage count
  (the loader monkeypatched, meta tensors: no card), and record the
  instance; tiles the instance does not hold raise.
"""

import pytest
import torch

from repro_torch.core.hopper_adapter import (H100_SXM, MAX_EMPTY_ROWS,
                                             backward_tile_candidates,
                                             default_smem_budget, dgrad_fits)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import matmul_bwd as MW

GRANITE_NK = ((4096, 4096), (1024, 4096), (12800, 4096), (4096, 12800))
TOKENS = 2048


def dgrad_dims(n, k):
    """The "matmul_dgrad" dims of the two cotangents of x (M, K) @ w (K,
    N): dA asks (M, K, N), dB (K, N, M)."""
    return {"dA": (TOKENS, k, n), "dB": (k, n, TOKENS)}


# ------------------------------ the warp grid -------------------------------


@pytest.mark.parametrize("which", ["dA", "dB"])
@pytest.mark.parametrize("n,k", GRANITE_NK)
def test_adapter_tiles_sit_on_the_warp_grid(n, k, which):
    budget = default_smem_budget()
    cands = backward_tile_candidates("matmul_dgrad", dgrad_dims(n, k)[which],
                                     2)
    assert cands
    for bm, bk, bn in cands:
        wm, wn, mt, nt = MW.mma_layout(bm, bn)
        assert wm * wn == MW.WARPS
        assert 16 * wm * mt >= bm and 8 * wn * nt >= bn   # covers the tile
        assert mt <= MW.MAX_M_TILES and nt <= MW.MAX_N_TILES
        assert nt & (nt - 1) == 0 and mt * nt <= MW.MAX_FRAGMENTS
        assert MW.accumulators_per_thread(bm, bn) == 4 * mt * nt \
            <= H100_SXM.acc_per_thread
        assert MW.empty_row_share(bm, bn) <= MAX_EMPTY_ROWS
        for kernel in ("nt", "tn"):
            assert MW.smem_bytes_required(bm, bk, bn, 2, kernel) <= budget
        assert dgrad_fits(bm, bk, bn, 2, budget)


@pytest.mark.parametrize("tile,layout", [
    ((128, 128), (4, 2, 2, 8)),    # the model's tile: 32 x 64 a warp
    ((128, 64), (4, 2, 2, 4)),
    ((80, 128), (1, 8, 5, 2)),     # no m16 rows left empty
    ((160, 64), (2, 4, 5, 2)),
    ((3, 64), (1, 8, 1, 1)),       # phase 3's ragged tiles
    ((32, 64), (2, 4, 1, 2)),
    ((16, 64), (1, 8, 1, 1)),
    ((128, 256), None),            # 128 sums a thread: no grid holds it
])
def test_layout_rule(tile, layout):
    assert MW.mma_layout(*tile) == layout
    if layout is None:
        assert MW.empty_row_share(*tile) == 1.0
        assert MW.accumulators_per_thread(*tile) > H100_SXM.acc_per_thread


def test_model_footprints_at_the_models_tile():
    """(128, 64, 128) in bf16: (128 + 128) rows of 64 elements, 32,768 B
    a stage in either kernel; two stages 65,536 B, three 98,304 B, both
    within the two-block budget of 115,712 B, so the instance runs three.
    fp32 keeps the CUDA-core footprint, the forward's."""
    for kernel in ("nt", "tn"):
        assert MW.smem_bytes_required(128, 64, 128, 2, kernel, 2) == 65_536
        assert MW.smem_bytes_required(128, 64, 128, 2, kernel, 3) == 98_304
    assert MW.mma_stages(128, 64, 128) == 3
    assert MW.smem_bytes_required(128, 64, 128) == 98_304 \
        <= default_smem_budget()
    assert MW.smem_bytes_required(128, 64, 128, 4) == 2 * 256 * 64 * 4


@pytest.mark.parametrize("tiles,stages", [
    ((128, 64, 128), 3), ((80, 64, 128), 3), ((16, 256, 64), 2),
    ((160, 128, 64), 2)])
def test_three_stages_where_the_budget_holds_them(tiles, stages):
    """Three stages where both kernels' three fit 115,712 B, else two; a
    tile fits the dgrad kernels when its two stages do."""
    budget = default_smem_budget()
    assert MW.mma_stages(*tiles) == stages
    assert MW.smem_bytes_required(*tiles) == \
        MW.smem_bytes_required(*tiles, 2, None, stages)
    three = MW.smem_bytes_required(*tiles, 2, None, 3)
    assert (three <= budget) == (stages == 3)


# ------------------------------ the staging ---------------------------------


def bank_groups_distinct(w):
    """Every 8 consecutive staged rows from a multiple of 8 put each chunk
    into 8 distinct 16-byte bank groups."""
    for r0 in range(0, 64, 8):
        for c in range(w):
            groups = {MW.chunk_at(w, r0 + j, c) % 8 for j in range(8)}
            if len(groups) != 8:
                return False
    return True


def is_row_permutation(w):
    ld = MW.staged_chunks(w)[0]
    return all(sorted(MW.chunk_at(w, r, c) - r * ld for c in range(w))
               == list(range(w)) for r in range(64))


@pytest.mark.parametrize("bk", [16, 24, 32, 40, 48, 64, 80, 96, 112, 128])
def test_nt_staging_swizzle(bk):
    """NT: a row of the step rounded up to whole k16 steps."""
    w = -(-bk // 16) * 2
    assert is_row_permutation(w) and bank_groups_distinct(w)


@pytest.mark.parametrize("bm", [16, 24, 32, 48, 64, 80, 96, 112, 128])
def test_tn_staging_swizzle(bm):
    """TN: a reduction row of the tile's width in whole chunks."""
    w = -(-bm // 8)
    assert is_row_permutation(w) and bank_groups_distinct(w)


@pytest.mark.parametrize("w", [1, 2, 4, 8, 16, 32])
def test_a_threads_staged_chunks_sit_one_stride_apart(w):
    """The kernels' fast copy loop: thread i stages chunk i % w of rows
    i / w + j * 256 / w, and for a power of two w up to 32 those land
    at one stride of (256 / w) * w chunks (the swizzle repeats every 8
    rows)."""
    rpi = MW.THREADS // w
    for i in range(MW.THREADS):
        r, c = divmod(i, w)
        first = MW.chunk_at(w, r, c)
        assert all(MW.chunk_at(w, r + j * rpi, c) == first + j * rpi * w
                   for j in range(4))


def test_swizzle_pads_only_where_it_must():
    """Powers of two and odd counts are not padded; other even counts get
    one chunk, to odd."""
    assert [MW.staged_chunks(w)[0] for w in (1, 2, 3, 4, 6, 8, 10, 16)] == \
        [1, 2, 3, 4, 7, 8, 11, 16]


# ------------------------------ the launch ----------------------------------


class FakeStream:
    cuda_stream = 0


class Props:
    shared_memory_per_block_optin = H100_SXM.smem_optin_bytes


class Sched:
    def __init__(self, tiles):
        self.tiles = tiles


@pytest.fixture
def fake_card(monkeypatch):
    """``_build.load`` returning C functions that record their arguments
    and report success (nothing is built or launched), and meta tensors
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
    monkeypatch.setattr(MW, "_check_operands", lambda name, x, y: None)
    return calls


@pytest.mark.parametrize("dtype,tiles,instance", [
    (torch.bfloat16, (128, 64, 128), ("mma", (4, 2, 2, 8), 3)),
    (torch.bfloat16, (80, 64, 128), ("mma", (1, 8, 5, 2), 3)),
    (torch.bfloat16, (16, 256, 64), ("mma", (1, 8, 1, 1), 2)),
    (torch.float32, (64, 64, 128), ("fma", 8, 2)),   # 8 rows a thread
])
def test_ops_launch_best_schedules_tiles(monkeypatch, fake_card, dtype,
                                         tiles, instance):
    """``ops._matmul_da`` asks ``best_schedule`` for the dA nest (M, K, N)
    and ``_matmul_db`` for the dB nest (K, N, M); each launches the
    answer's tiles, the instance's stages, and records the instance."""
    asked = []

    def best(op, dims, dtype_name):
        asked.append((op, dims, dtype_name))
        return Sched(tiles)
    monkeypatch.setattr(ops, "best_schedule", best)
    m, n, k = 48, 40, 24
    a = torch.zeros((m, k), dtype=dtype, device="meta")
    b = torch.zeros((k, n), dtype=dtype, device="meta")
    g = torch.zeros((m, n), dtype=dtype, device="meta")
    name = str(dtype).removeprefix("torch.")
    da = ops._matmul_da(g, b)
    db = ops._matmul_db(a, g)
    assert da.shape == (m, k) and db.shape == (k, n)
    assert asked == [("matmul_dgrad", (m, k, n), name),
                     ("matmul_dgrad", (k, n, m), name)]
    code = 1 if dtype == torch.bfloat16 else 0
    for (symbol, args), want in zip(fake_card,
                                    ("matmul_dgrad_a", "matmul_dgrad_b")):
        assert symbol == want
        assert args[0] == code
        assert args[4:7] == (m, n, k)
        assert args[7:10] == tiles
        assert args[10] == instance[2]                  # stages
    assert MW.matmul_dgrad_a.instance == instance
    assert MW.matmul_dgrad_b.instance == instance


def test_stages_override_and_refusals(fake_card):
    """``stages=`` picks the bf16 instance's 2 or 3 buffers; anything
    else, an fp32 stage count other than 2, a tile no warp grid holds or
    one over the card's shared memory raises before a launch."""
    g = torch.zeros((64, 64), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((32, 64), dtype=torch.bfloat16, device="meta")
    for st in (2, 3):
        MW.matmul_dgrad_a(g, b, bm=64, br=64, bo=32, stages=st)
        assert fake_card[-1][1][10] == st
        assert MW.matmul_dgrad_a.instance[2] == st
    n_calls = len(fake_card)
    with pytest.raises(ValueError, match="2 or 3 stages"):
        MW.matmul_dgrad_a(g, b, bm=64, br=64, bo=32, stages=4)
    with pytest.raises(ValueError, match="no warp grid"):
        MW.matmul_dgrad_a(g, b, bm=128, br=64, bo=256)
    with pytest.raises(ValueError, match="shared memory"):
        MW.matmul_dgrad_a(g, b, bm=128, br=512, bo=128, stages=3)
    gf, bf = g.float(), b.float()
    with pytest.raises(ValueError, match="fp32 instance runs 2"):
        MW.matmul_dgrad_a(gf, bf, bm=64, br=64, bo=32, stages=3)
    assert len(fake_card) == n_calls


def test_cpu_tensors_take_the_plain_versions(fake_card):
    g = torch.randn(5, 7, dtype=torch.bfloat16)
    b = torch.randn(3, 7, dtype=torch.bfloat16)
    a = torch.randn(5, 3, dtype=torch.bfloat16)
    assert torch.equal(MW.matmul_dgrad_a(g, b, bm=16, br=16, bo=16),
                       MW.matmul_dgrad_a_ref(g, b))
    assert torch.equal(MW.matmul_dgrad_b(a, g, bk=16, br=16, bn=16),
                       MW.matmul_dgrad_b_ref(a, g))
    assert fake_card == []
