"""Port vs JAX: the paper's coarse-grain parallelism model
(``core/multicore.py``, §3.3) and the mesh-scale sharding rule
(``hopper_adapter.layer_sharding_advice`` against the TPU adapter's).

The port keeps a copy of ``repro.core.multicore`` with its imports
re-pointed.  Schedules: each Table-4 layer (``PAPER_LAYERS``) optimised
by both packages' exhaustive 2-level search (at most two loop orders a
level, so the file stays fast); the schedules must print alike, and
every multicore report built on them must agree -- energies to 1e-12
relative, everything else exactly -- or both packages must refuse with
the same message (a layer whose outer loops no core count divides).
"""

import dataclasses

import pytest

from repro.configs import PAPER_LAYERS as J_LAYERS
from repro.core import make_objective as j_objective
from repro.core import multicore as jm
from repro.core import optimize_exhaustive as j_optimize
from repro.core.tpu_adapter import \
    layer_sharding_advice as j_layer_sharding_advice
from repro_torch.configs import PAPER_LAYERS
from repro_torch.core import layer_sharding_advice, make_objective
from repro_torch.core import multicore as tm
from repro_torch.core import optimize_exhaustive

LAYERS = list(PAPER_LAYERS)
ENERGY_FIELDS = ("private_pj", "ll_ib_pj", "ll_kb_pj", "ll_ob_pj",
                 "dram_pj", "shuffle_pj", "broadcast_pj")


@pytest.fixture(scope="module")
def schedules() -> dict:
    """Each layer's best 2-level schedule, from each package's search."""
    out = {}
    for name in LAYERS:
        t = optimize_exhaustive(PAPER_LAYERS[name], make_objective("custom"),
                                n_levels=2, top=1, max_orders=2)[0].string
        j = j_optimize(J_LAYERS[name], j_objective("custom"), n_levels=2,
                       top=1, max_orders=2)[0].string
        assert repr(t) == repr(j), name
        out[name] = (j, t)
    return out


def rel_equal(a: float, b: float, rel: float = 1e-12) -> None:
    assert abs(a - b) <= rel * max(abs(a), abs(b)), (a, b)


def outcome(fn, *args):
    """A call's report, or the message of the ``ValueError`` it raised."""
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


def same_report(j, t) -> None:
    if isinstance(j, str):
        assert t == j
        return
    assert type(t).__name__ == "MulticoreReport"
    assert (t.scheme, t.cores) == (j.scheme, j.cores)
    assert repr(t.string) == repr(j.string)
    assert dataclasses.asdict(t.string.problem) == \
        dataclasses.asdict(j.string.problem)
    for f in ENERGY_FIELDS:
        rel_equal(getattr(t, f), getattr(j, f))
    rel_equal(t.onchip_pj, j.onchip_pj)
    rel_equal(t.total_pj, j.total_pj)
    rel_equal(t.pj_per_mac, j.pj_per_mac)
    assert t.total_macs == j.total_macs


@pytest.mark.parametrize("cores", [1, 2, 4, 8])
@pytest.mark.parametrize("scheme", ["K", "XY"])
@pytest.mark.parametrize("layer", LAYERS)
def test_evaluate_multicore_equals_jax(schedules, layer, scheme, cores):
    """Every field of the report (the cheapest partition of the outer
    loops), or the same refusal."""
    j, t = schedules[layer]
    same_report(outcome(jm.evaluate_multicore, j, scheme, cores),
                outcome(tm.evaluate_multicore, t, scheme, cores))


@pytest.mark.parametrize("layers", [0, 3])
@pytest.mark.parametrize("layer", ["Conv1", "Conv4", "FC2"])
def test_shuffle_over_layers_equals_jax(schedules, layer, layers):
    """The K scheme's per-layer shuffle, charged ``layers`` times."""
    j, t = schedules[layer]
    same_report(outcome(jm.evaluate_multicore, j, "K", 4, layers),
                outcome(tm.evaluate_multicore, t, "K", 4, layers))


@pytest.mark.parametrize("cores", [1, 2, 4, 8])
@pytest.mark.parametrize("layer", LAYERS)
def test_best_scheme_equals_jax(schedules, layer, cores):
    j, t = schedules[layer]
    same_report(outcome(jm.best_scheme, j, cores),
                outcome(tm.best_scheme, t, cores))


def test_partitioning_candidates_equal_jax(schedules):
    """The candidate per-core strings, in the same order, for each layer,
    scheme and core count where one exists."""
    for layer, (j, t) in schedules.items():
        for scheme in tm.PARTITION_SCHEMES:
            for cores in (2, 4, 8):
                jc = outcome(jm._partition_candidates, j, scheme, cores)
                tc = outcome(tm._partition_candidates, t, scheme, cores)
                if isinstance(jc, str):
                    assert tc == jc
                else:
                    assert [repr(s) for s in tc] == [repr(s) for s in jc]


def test_refusals_equal_jax(schedules):
    j, t = schedules["Conv4"]
    for fn, s in ((jm.evaluate_multicore, j), (tm.evaluate_multicore, t)):
        with pytest.raises(ValueError, match="scheme must be one of"):
            fn(s, "Z", 2)
    assert outcome(tm.evaluate_multicore, t, "K", 7) == \
        outcome(jm.evaluate_multicore, j, "K", 7)


@pytest.mark.parametrize("layer", LAYERS)
def test_sharding_advice_equals_jax(schedules, layer):
    j, t = schedules[layer]
    assert tm.sharding_advice(t.problem, t) == \
        jm.sharding_advice(j.problem, j)


def test_layer_sharding_advice_equals_tpu_rule():
    """The Hopper adapter's rule is the TPU adapter's: shard the large
    operand (ties shard the weights)."""
    sizes = [0, 1, 2, 1023, 1024, 1025, 4096 * 4096 * 2, 2 ** 40]
    for w in sizes:
        for a in sizes:
            assert layer_sharding_advice(w, a) == \
                j_layer_sharding_advice(w, a), (w, a)
    assert layer_sharding_advice(8, 8) == "model"
    assert layer_sharding_advice(8, 9) == "data"
