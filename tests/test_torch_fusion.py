"""Port vs JAX: the fused producer-consumer model (``core/fusion.py``).

The port keeps a copy of ``repro.core.fusion`` with its imports
re-pointed, so the same chain, tiles and budget must give the same
numbers in both packages: byte counts exactly, energies to 1e-12
relative.  Every case of ``tests/test_fusion.py``'s model section is run
through both packages, and a hypothesis test draws chains, tiles and
budgets with that file's strategy.  The reference's capacity property
does not hold on the forced-resident path (``traffic(...,
always_resident=True)`` can total more than the unfused chain; ROADMAP
"Reference caveats"): these tests hold the port to JAX's numbers there,
not to that invariant.
"""

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import fusion as jf
from repro.core import loopnest as jl
from repro_torch.core import fusion as tf
from repro_torch.core import loopnest as tl

BUDGET = 2 * 1024 * 1024
PKGS = ((jf, jl), (tf, tl))


def both(build):
    """``build(fusion_module, loopnest_module)`` in JAX's package, then
    in the port's."""
    return [build(f, l) for f, l in PKGS]


def raised(build) -> list:
    out = []
    for f, l in PKGS:
        with pytest.raises(ValueError) as exc:
            build(f, l)
        out.append(str(exc.value))
    return out


def mlp(M, d_model, d_ff, swiglu=False, wb=None):
    return lambda f, l: f.FusedProblem.mlp(M, d_model, d_ff, swiglu=swiglu,
                                           weight_bytes=wb)


def same_traffic(j, t) -> None:
    assert type(t).__name__ == "FusedTraffic"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.total_bytes == j.total_bytes
    assert t.savings_bytes == j.savings_bytes
    assert t.savings_frac == j.savings_frac


def rel_equal(a: float, b: float, rel: float = 1e-12) -> None:
    assert abs(a - b) <= rel * max(abs(a), abs(b)), (a, b)


# ------------------------------ validation -----------------------------------


@pytest.mark.parametrize("build,match", [
    (lambda f, l: f.FusedProblem.pair(
        l.Problem.gemm(M=64, N_cols=128, K_reduce=32),
        l.Problem.gemm(M=64, N_cols=32, K_reduce=64)), "consumes"),
    (lambda f, l: f.FusedProblem.pair(
        l.Problem.gemm(M=64, N_cols=128, K_reduce=32),
        l.Problem.gemm(M=32, N_cols=32, K_reduce=128)), "row dim"),
    (lambda f, l: f.FusedProblem(
        (l.Problem.gemm(M=64, N_cols=128, K_reduce=32),),
        (f.Epilogue(),)), "at least two"),
    (lambda f, l: f.FusedProblem(
        (l.Problem.gemm(M=64, N_cols=128, K_reduce=32),) * 2,
        (f.Epilogue(),)), "one Epilogue"),
    (lambda f, l: f.FusedProblem.pair(
        l.Problem(X=8, Y=2, C=4, K=8),
        l.Problem.gemm(M=64, N_cols=32, K_reduce=128)), "GEMM-family"),
    (lambda f, l: f.FusedProblem.mlp(64, 32, 128).validate_tiles(
        [(16, 32, 64), (32, 128, 32)]), "shared fusion tile"),
    (lambda f, l: f.FusedProblem.mlp(64, 32, 128).validate_tiles(
        [(16, 32, 48), (16, 128, 32)]), "divide"),
    (lambda f, l: f.FusedProblem.mlp(64, 32, 128).validate_tiles(
        [(16, 32, 64)]), "one \\(bm, bk, bn\\) tile"),
    (lambda f, l: f.fused_multicore_dram_bytes(
        f.FusedProblem.mlp(256, 128, 512), [(64, 128, 128), (64, 512, 128)],
        BUDGET, "Z", 4), "scheme"),
    (lambda f, l: f.fused_multicore_dram_bytes(
        f.FusedProblem.mlp(24, 128, 512), [(8, 128, 128), (8, 512, 128)],
        BUDGET, "XY", 5), "not divisible"),
], ids=["consumes", "row-dim", "two-stages", "epilogues", "gemm-family",
        "shared-tile", "divide", "tile-count", "scheme", "xy-cores"])
def test_refusals_equal_jax(build, match):
    """The same invalid chain, tiles or scheme raises ``ValueError`` with
    the same message in both packages."""
    j, t = raised(build)
    assert t == j
    pytest.raises(ValueError, build, tf, tl).match(match)


def test_valid_chains_build_alike():
    j, t = both(lambda f, l: f.FusedProblem.pair(
        l.Problem.gemm(M=64, N_cols=128, K_reduce=32),
        l.Problem.gemm(M=64, N_cols=32, K_reduce=128),
        f.Epilogue(act="gelu", bias=True), f.Epilogue(extra_operands=1)))
    assert repr(t.stages) == repr(j.stages)
    assert dataclasses.asdict(t.epilogues[0]) == \
        dataclasses.asdict(j.epilogues[0])
    assert t.M == j.M == 64
    assert t.intermediate_elems(0) == j.intermediate_elems(0)
    assert t.intermediate_tile_bytes(0, 16) == \
        j.intermediate_tile_bytes(0, 16)


# ------------------------------- traffic -------------------------------------

# (chain, tiles, budget): tests/test_fusion.py's cases, SwiGLU and w8,
# a three-stage chain, and the forced-resident caveat (8 KiB).
TRAFFIC = [
    (mlp(256, 128, 512), [(64, 128, 128), (64, 512, 128)], BUDGET),
    (mlp(256, 128, 512), [(256, 128, 512), (256, 512, 128)], 4 * 1024),
    (mlp(256, 128, 512), [(64, 128, 128), (64, 512, 128)], 4 * 1024),
    (mlp(256, 128, 512), [(8, 32, 64), (8, 128, 64)], BUDGET),
    (mlp(256, 128, 512), [(32, 128, 128), (32, 128, 128)], BUDGET),
    (mlp(256, 128, 512, swiglu=True), [(64, 128, 128), (64, 512, 128)],
     BUDGET),
    (mlp(256, 128, 512, swiglu=True, wb=1),
     [(64, 128, 128), (64, 512, 128)], BUDGET),
    (mlp(16, 128, 128), [(16, 8, 8), (16, 8, 8)], 8 * 1024),
    (mlp(8, 4096, 12800, swiglu=True), [(8, 64, 64), (8, 64, 64)],
     115_712),
    (lambda f, l: f.FusedProblem(
        (l.Problem.gemm(M=64, N_cols=128, K_reduce=32),
         l.Problem.gemm(M=64, N_cols=64, K_reduce=128),
         l.Problem.gemm(M=64, N_cols=32, K_reduce=64)),
        (f.Epilogue(act="relu"), f.Epilogue(bias=True),
         f.Epilogue(extra_operands=1))),
     [(16, 32, 64), (16, 64, 32), (16, 32, 32)], 64 * 1024),
]
TRAFFIC_IDS = ["mlp", "tiny-spill", "tiny-epilogues", "small-tiles",
               "narrow-down", "swiglu", "swiglu-w8", "forced-caveat",
               "granite-decode", "three-stage"]


@pytest.mark.parametrize("forced", [False, True], ids=["chosen", "forced"])
@pytest.mark.parametrize("build,tiles,budget", TRAFFIC, ids=TRAFFIC_IDS)
def test_traffic_equals_jax(build, tiles, budget, forced):
    """Every field of ``FusedTraffic`` (per-stage, epilogue and
    intermediate bytes, residency, the unfused baseline), chosen or
    forced resident, and the intermediate-fits test per edge."""
    j, t = both(build)
    same_traffic(j.traffic(tiles, budget, always_resident=forced),
                 t.traffic(tiles, budget, always_resident=forced))
    for i in range(len(t.stages) - 1):
        assert t.intermediate_fits(i, tiles, budget) == \
            j.intermediate_fits(i, tiles, budget)


@pytest.mark.parametrize("build,tiles,budget", TRAFFIC, ids=TRAFFIC_IDS)
def test_dram_bytes_and_energy_equal_jax(build, tiles, budget):
    """``fused_dram_bytes`` and ``unfused_dram_bytes`` exactly,
    ``fused_energy_pj`` to 1e-12 relative."""
    j, t = both(build)
    assert t.fused_dram_bytes(tiles, budget) == \
        j.fused_dram_bytes(tiles, budget)
    assert t.unfused_dram_bytes(tiles, budget) == \
        j.unfused_dram_bytes(tiles, budget)
    rel_equal(tf.fused_energy_pj(t, tiles, budget),
              jf.fused_energy_pj(j, tiles, budget))


def test_forced_resident_caveat_numbers():
    """The reference's caveat, reproduced: forced resident, the chain
    totals 208,896 B against 102,400 B unfused, in both packages."""
    tiles = [(16, 8, 8), (16, 8, 8)]
    for fp in both(mlp(16, 128, 128)):
        assert fp.intermediate_fits(0, tiles, 8 * 1024)
        forced = fp.traffic(tiles, 8 * 1024, always_resident=True)
        assert forced.intermediate_resident == (True,)
        assert forced.intermediate_bytes == (0,)
        assert (forced.total_bytes, forced.unfused_total_bytes) == \
            (208_896, 102_400)


@pytest.mark.parametrize("scheme", ["K", "XY"])
@pytest.mark.parametrize("cores", [1, 2, 4, 8])
@pytest.mark.parametrize("build,tiles", [
    (mlp(256, 128, 512), [(64, 128, 128), (64, 512, 128)]),
    (mlp(256, 128, 512, swiglu=True, wb=1),
     [(256, 128, 128), (256, 512, 128)]),
    (mlp(64, 128, 512), [(64, 32, 64), (64, 64, 32)]),
], ids=["mlp", "swiglu-w8-wide-bm", "bm-shrinks"])
def test_multicore_dram_bytes_equal_jax(build, tiles, cores, scheme):
    """``fused_multicore_dram_bytes`` under K and XY partitioning at 1-8
    cores (XY shrinks the fusion tile to the per-core rows where it must)."""
    j, t = both(build)
    assert tf.fused_multicore_dram_bytes(t, tiles, BUDGET, scheme,
                                         cores) == \
        jf.fused_multicore_dram_bytes(j, tiles, BUDGET, scheme, cores)


# ------------------------------- search --------------------------------------


@pytest.mark.parametrize("build,budget,kw", [
    (mlp(512, 256, 1024), BUDGET, {}),
    (mlp(256, 128, 512, swiglu=True), 64 * 1024, {}),
    (mlp(256, 128, 512, swiglu=True, wb=1), BUDGET, {"top": 3}),
    (mlp(8, 4096, 12800, swiglu=True), 115_712, {}),
    (mlp(8, 4096, 12800, swiglu=True), 115_712,
     {"m_align": 16, "n_align": 64}),
    (mlp(512, 4096, 12800, swiglu=True), 115_712,
     {"m_align": 16, "n_align": 64}),
], ids=["mlp", "swiglu-64k", "w8-top3", "granite-decode-default",
        "granite-decode-hopper-align", "granite-prefill-hopper-align"])
def test_optimize_fused_equals_jax(build, budget, kw):
    """The ranked list (at most ``top``, 8 by default): each result's
    tiles, traffic, byte counts and summary line in the same order (the
    granite MLP at the Hopper budget finds nothing at the default
    128-column alignment, in both)."""
    j, t = both(build)
    jr = jf.optimize_fused(j, budget, **kw)
    tr = tf.optimize_fused(t, budget, **kw)
    assert len(tr) == len(jr) <= kw.get("top", 8)
    for a, b in zip(jr, tr):
        assert b.tiles == a.tiles
        same_traffic(a.traffic, b.traffic)
        assert (b.fused_bytes, b.unfused_bytes, b.savings_bytes) == \
            (a.fused_bytes, a.unfused_bytes, a.savings_bytes)
        assert b.summary() == a.summary()
    if tr:
        assert tr[0].fused_bytes == t.fused_dram_bytes(tr[0].tiles, budget)


# ------------------------------ property -------------------------------------


dims = st.sampled_from([16, 32, 64, 128, 256])
tile_of = st.sampled_from([8, 16, 32, 64, 128, 256])


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_port_equals_jax_property(data):
    """``tests/test_fusion.py``'s strategy (chains, tiles, budgets),
    holding the port to JAX on each drawn case: the chosen and the forced
    traffic, the fits test and the energy.  Equality, not the capacity
    invariant, which the reference breaks on the forced path."""
    M = data.draw(dims)
    d_model = data.draw(dims)
    d_ff = data.draw(dims)
    swiglu = data.draw(st.booleans())
    wb = data.draw(st.sampled_from([None, 1]))
    j, t = both(mlp(M, d_model, d_ff, swiglu, wb))

    def tile(full):
        v = data.draw(tile_of)
        while full % v:
            v //= 2
        return max(v, 1)

    bm = tile(M)
    tiles = [(bm, tile(d_model), tile(d_ff)),
             (bm, tile(d_ff), tile(d_model))]
    budget = data.draw(st.sampled_from([8 * 1024, 64 * 1024, 1024 * 1024]))
    same_traffic(j.traffic(tiles, budget), t.traffic(tiles, budget))
    fits = t.intermediate_fits(0, tiles, budget)
    assert fits == j.intermediate_fits(0, tiles, budget)
    if fits:
        same_traffic(j.traffic(tiles, budget, always_resident=True),
                     t.traffic(tiles, budget, always_resident=True))
    rel_equal(tf.fused_energy_pj(t, tiles, budget),
              jf.fused_energy_pj(j, tiles, budget))
