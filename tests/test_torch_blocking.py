"""Port vs JAX: the paper's blocking model, and the Hopper adapter.

The port keeps its own copy of ``repro.core`` (imports re-pointed), so
the same ``Problem`` must give the same rankings, traffic and optimizer
results in both, exactly.  Problems: granite-3-8b's projection GEMMs at
decode and prefill M, and AlexNet conv layers 1, 2 and 5 restated from
``benchmarks/networks.py`` (no test imports ``benchmarks/``); the
optimizer's three-level beam search runs on a small GEMM so the file
stays fast.

The Hopper adapter's candidates are then held to the kernels' limits:
shared memory, the register accumulator, the tile multiples, and the
problem's extents.

The conv path's model pieces: ``PAPER_LAYERS``, ``simulate_fills``
against the closed-form access model, and the im2col lowering model
(``gemm_lowering``), each equal to JAX's.
"""

import dataclasses

import pytest

from repro.configs import PAPER_LAYERS as J_LAYERS
from repro.core import access as j_access
from repro.core import gemm_lowering as j_lowering
from repro.core import hierarchy as j_hierarchy
from repro.core import loopnest as j_loopnest
from repro.core import optimizer as j_optimizer
from repro.core import xeon_hierarchy as j_xeon
from repro.core.validate import simulate_fills as j_simulate_fills
from repro_torch.configs import PAPER_LAYERS
from repro_torch.core import (direct_blocking_accesses,
                              gemm_lowering_accesses, simulate_fills)
from repro_torch.core import access as t_access
from repro_torch.core import hierarchy as t_hierarchy
from repro_torch.core import loopnest as t_loopnest
from repro_torch.core import optimizer as t_optimizer
from repro_torch.core.hopper_adapter import (H100_SXM,
                                             backward_tile_candidates,
                                             conv_fits, default_smem_budget,
                                             dgrad_fits,
                                             flash_decode_tile_candidates,
                                             flash_tiles,
                                             matmul_tile_candidates)
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import matmul_blocked as MB

JAX = (j_loopnest, j_hierarchy, j_optimizer, j_access)
PORT = (t_loopnest, t_hierarchy, t_optimizer, t_access)

GEMMS = {f"gemm_m{m}_n{n}_k{k}": dict(M=m, N_cols=n, K_reduce=k)
         for m, n, k in ((8, 4096, 4096), (8, 1024, 4096),
                         (512, 12800, 4096), (512, 4096, 12800))}
CONVS = {"alexnet_conv1": dict(X=55, Y=55, C=3, K=96, Fw=11, Fh=11,
                               stride=4),
         "alexnet_conv2": dict(X=27, Y=27, C=96, K=256, Fw=5, Fh=5),
         "alexnet_conv5": dict(X=13, Y=13, C=384, K=256, Fw=3, Fh=3)}
SMALL = {"gemm_small": dict(M=16, N_cols=64, K_reduce=64)}
# the training step's dgrad nests at 2048 tokens, in the "matmul_dgrad"
# (M_out, N_out, K_reduce) convention: dA of the up projection (M, K, N)
# and dB of the down projection (K, N, M)
DGRADS = {"gemm_dgrad_a_up": dict(M=2048, N_cols=4096, K_reduce=12800),
          "gemm_dgrad_b_down": dict(M=12800, N_cols=4096, K_reduce=2048),
          "gemm_dgrad_b_qkv": dict(M=4096, N_cols=1024, K_reduce=2048)}
PROBLEMS = {**GEMMS, **CONVS, **SMALL, **DGRADS}


def problem(mods, name):
    loopnest = mods[0]
    kw = PROBLEMS[name]
    if name.startswith("gemm"):
        return loopnest.Problem.gemm(**kw)
    return loopnest.Problem(**kw)


def ranked(mods, name):
    loopnest, hierarchy, optimizer, _ = mods
    levels = [hierarchy.MemLevel.sram("SMEM", default_smem_budget()),
              hierarchy.MemLevel.dram("HBM")]
    align = {loopnest.Dim.X: 16, loopnest.Dim.K: 64, loopnest.Dim.C: 64}
    return [(e.X, e.Y, e.C, e.K, e.Fw, e.Fh, e.N)
            for e in optimizer.ranked_level0_tiles(
                problem(mods, name), levels, align=align, top=6,
                max_orders=4)]


@pytest.mark.parametrize("name", sorted({**GEMMS, **CONVS}))
def test_ranked_level0_tiles_match_jax(name):
    got = ranked(PORT, name)
    assert got and got == ranked(JAX, name)


def results(mods, name, n_levels, **kw):
    _, _, optimizer, access = mods
    out = []
    for r in optimizer.optimize(problem(mods, name), n_levels=n_levels,
                                top=4, **kw):
        rep = access.analyze(r.string)
        out.append((repr(r.string), r.energy_pj, rep.dram_accesses,
                    sorted((bt.buffer.name, bt.total_accesses,
                            bt.parent_traffic) for bt in rep.per_buffer)))
    return out


@pytest.mark.parametrize("name", sorted(GEMMS))
def test_optimize_and_traffic_match_jax(name):
    """Two-level exhaustive search on granite's GEMMs: the same strings,
    energies and per-buffer traffic of ``analyze``."""
    got = results(PORT, name, 2)
    assert got and got == results(JAX, name, 2)


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_beam_search_matches_jax(seed):
    """Three-level beam search: ``optimize`` seeds its own
    ``random.Random``, so one seed gives one answer in both packages."""
    got = results(PORT, "gemm_small", 3, seed=seed, beam=2)
    assert got and got == results(JAX, "gemm_small", 3, seed=seed, beam=2)


@pytest.mark.parametrize("dims", [(M, N, K) for M in (8, 512)
                                  for N, K in ((4096, 4096), (1024, 4096),
                                               (12800, 4096),
                                               (4096, 12800))])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_matmul_candidates_fit_the_kernel(dims, itemsize):
    M, N, K = dims
    budget = default_smem_budget()
    cands = matmul_tile_candidates(M, N, K, itemsize)
    assert cands
    for bm, bk, bn in cands:
        assert MB.smem_bytes_required(bm, bk, bn, itemsize) <= budget
        assert MB.accumulators_per_thread(bm, bn) <= H100_SXM.acc_per_thread
        assert bm <= M and bk <= K and bn <= N
        assert bm == M if M < H100_SXM.m_mult else bm % H100_SXM.m_mult == 0
        assert bk % H100_SXM.nk_mult == 0 and bn % H100_SXM.nk_mult == 0


@pytest.mark.parametrize("seq", [32, 64, 512, 1024, 2048])
@pytest.mark.parametrize("itemsize,head_dim", [(2, 128), (4, 128), (2, 64)])
def test_flash_decode_pages_divide_and_fit(seq, itemsize, head_dim):
    budget = default_smem_budget()
    for (page,) in flash_decode_tile_candidates(4, seq, head_dim, itemsize):
        assert seq % page == 0 and page % H100_SXM.key_mult == 0
        assert FD.smem_bytes_required(page, FD.ROWS_PER_BLOCK, head_dim,
                                      itemsize) <= budget


def test_budget_is_the_opt_in_limit_over_resident_blocks():
    """The SM's 233,472 B over the two resident blocks, less the 1 KB the
    card reserves for each (two blocks of 116,224 B would not fit), and
    never above what one block may opt in to."""
    assert H100_SXM.smem_optin_bytes == 232_448
    assert H100_SXM.smem_per_sm_bytes == 233_472
    assert default_smem_budget() == (
        233_472 // H100_SXM.blocks_per_sm
        - H100_SXM.smem_reserved_per_block) == 115_712
    assert H100_SXM.blocks_per_sm * (
        default_smem_budget() + H100_SXM.smem_reserved_per_block) \
        <= H100_SXM.smem_per_sm_bytes
    assert default_smem_budget(smem_budget_bytes=4096) == 4096
    # a hashable target: the tuner memoizes derivations on it
    assert hash(H100_SXM) == hash(H100_SXM)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_largest_page_is_the_last_that_fits(itemsize):
    optin = H100_SXM.smem_optin_bytes
    top = FD.largest_page(128, itemsize, optin)
    assert FD.smem_bytes_required(top, FD.ROWS_PER_BLOCK, 128,
                                  itemsize) <= optin
    assert FD.smem_bytes_required(top + 1, FD.ROWS_PER_BLOCK, 128,
                                  itemsize) > optin


@pytest.mark.parametrize("name", sorted(DGRADS))
def test_dgrad_problems_rank_as_jax(name):
    """The port's core ranks the dgrad GEMM nests exactly as JAX's core,
    and the "matmul_dgrad" candidates are the GEMM search over them,
    snapped to the dgrad kernels' own footprint: in bf16 the tensor-core
    instance's (``dgrad_fits``: its stages, sums and warp grid), in fp32
    the CUDA-core instance's, which is the forward's."""
    got = ranked(PORT, name)
    assert got and got == ranked(JAX, name)
    kw = DGRADS[name]
    dims = (kw["M"], kw["N_cols"], kw["K_reduce"])
    cands = backward_tile_candidates("matmul_dgrad", dims)
    assert cands == matmul_tile_candidates(*dims, dgrad=True)
    assert all(dgrad_fits(*t, 2, default_smem_budget()) for t in cands)
    assert backward_tile_candidates("matmul_dgrad", dims, 4) == \
        matmul_tile_candidates(*dims, 4)


@pytest.mark.parametrize("seq_q,seq_kv,head_dim,itemsize", [
    (512, 512, 128, 2), (512, 512, 128, 4), (64, 64, 128, 4),
    (64, 64, 64, 2), (2048, 2048, 128, 2), (24, 100, 64, 4),
    (64, 64, 128, 2),                      # the serving join (B 1, S 64)
    (512, 512, 64, 2), (16383, 16385, 128, 2), (40, 104, 128, 2),
    (1, 64, 128, 2)])
def test_flash_tiles_fit_the_backward_kernels(seq_q, seq_kv, head_dim,
                                              itemsize):
    """Hopper ``flash_tiles``: one (block_q, block_kv) for the forward and
    both backward passes.  bf16 (the tensor cores): both on the mma warp
    grid (one to four m16 row tiles, whole k16 steps), each pass's
    footprint within the repaired two-block budget of 115,712 B and its
    fp32 sums per thread within the stated cap.  fp32 (CUDA cores):
    whole multiples of 32 (or the extent under 32), each pass's footprint
    within the budget."""
    from repro_torch.kernels.flash_attention import (MMA_TILES,
                                                     fwd_accumulators,
                                                     fwd_smem_bytes)
    from repro_torch.kernels.flash_attention_bwd import (dkv_accumulators,
                                                         dkv_smem_bytes,
                                                         dq_accumulators,
                                                         dq_smem_bytes)
    bq, bkv = flash_tiles(seq_q, seq_kv, head_dim, itemsize)
    if itemsize == 2:
        assert bq in MMA_TILES and bkv in MMA_TILES
        assert bq % 16 == 0 and bq // 16 <= 4 and bkv % 16 == 0
        assert max(fwd_accumulators(bq, bkv, head_dim),
                   dq_accumulators(bq, bkv, head_dim),
                   dkv_accumulators(bq, bkv, head_dim)) \
            <= H100_SXM.attn_acc_per_thread
    else:
        for tile, seq in ((bq, seq_q), (bkv, seq_kv)):
            assert tile % 32 == 0 or tile == seq < 32
    for footprint in (fwd_smem_bytes, dq_smem_bytes, dkv_smem_bytes):
        assert footprint(bq, bkv, head_dim, itemsize) \
            <= default_smem_budget() == 115_712
    wgrad = backward_tile_candidates("conv2d_wgrad", (8, 8, 4, 8, 3, 3),
                                     itemsize)
    assert wgrad and all(
        conv_fits(*tiles, 3, 3, itemsize, default_smem_budget(), wgrad=True)
        for tiles in wgrad)


# ------------------- the conv path's model pieces ---------------------------


def test_paper_layers_equal_jax():
    assert list(PAPER_LAYERS) == list(J_LAYERS)
    for name, p in PAPER_LAYERS.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(J_LAYERS[name])


SMALL = dict(X=4, Y=4, C=4, K=8, Fw=3, Fh=3)


@pytest.mark.parametrize("text,dims", [
    ("Fw3 Fh3 X2 Y2 C2 K2 X4 Y4 C4 K8", SMALL),
    ("X2 C2 K2 Fw3 Fh3 Y4 X4 C4 K8", SMALL),
    ("Fw3 Fh3 K8 C4 Y4 X4", SMALL),
    ("C2 X3 K2 C4 X6 K4 N2", dict(X=6, Y=1, C=4, K=4, Fw=1, Fh=1, N=2)),
    ("Fw2 K2 Fh2 C2 Y2 X2 K4 C4 X4 Y4 K8",
     dict(X=4, Y=4, C=4, K=8, Fw=2, Fh=2)),
])
def test_simulate_fills_matches_model_and_jax(text, dims):
    """``test_blocking_model.py``'s cases: the simulation equals the
    closed-form access model, and both equal JAX's."""
    s = t_loopnest.BlockingString.parse(text, t_loopnest.Problem(**dims))
    sim = simulate_fills(s)
    js = j_loopnest.BlockingString.parse(text, j_loopnest.Problem(**dims))
    assert sim == j_simulate_fills(js)
    rep, jrep = t_access.analyze(s), j_access.analyze(js)
    for bt in rep.per_buffer:
        if bt.buffer.pos < 0:
            continue
        assert sim[bt.buffer.name] == (bt.fills, bt.writebacks)
    assert rep.dram_accesses == jrep.dram_accesses


@pytest.mark.parametrize("layer", ["Conv3", "Conv4", "Conv5"])
def test_direct_blocking_beats_gemm_lowering_as_jax(layer):
    """``test_multicore_and_gemm.py``'s Figs. 3-4 check, with the numbers
    equal to JAX's."""
    p, jp = PAPER_LAYERS[layer], J_LAYERS[layer]
    ours = direct_blocking_accesses(p, t_hierarchy.xeon_hierarchy())
    assert ours == j_lowering.direct_blocking_accesses(jp, j_xeon())
    for quality in ("mkl", "atlas"):
        theirs = gemm_lowering_accesses(p, t_hierarchy.xeon_hierarchy(),
                                        quality).cache_counts
        assert theirs == j_lowering.gemm_lowering_accesses(
            jp, j_xeon(), quality).cache_counts
        assert theirs["L2"] + theirs["L3"] > ours["L2"] + ours["L3"]


def test_lowering_replicates_data():
    p = PAPER_LAYERS["Conv4"]
    rep = gemm_lowering_accesses(p, t_hierarchy.xeon_hierarchy())
    assert rep.lowering_write_elems == p.X * p.Y * p.C * p.Fw * p.Fh
    assert rep.gemm.C == p.C * p.Fw * p.Fh
    jrep = j_lowering.gemm_lowering_accesses(J_LAYERS["Conv4"], j_xeon())
    assert (rep.lowering_write_elems, rep.lowering_read_elems) == \
        (jrep.lowering_write_elems, jrep.lowering_read_elems)
