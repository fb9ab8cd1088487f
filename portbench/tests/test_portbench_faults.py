"""The check catches a broken timed path: each cell's run, on the CPU
at a reduced size, with a fault planted under it comes out not correct,
and the same run without one comes out correct.  The control (the
reference in float8 put in the program's place) reads above the limits
that the program's readings keep under."""

import pytest

from portbench import faults
from portbench.tests import tiny_cell

SERVE = "granite-3-8b.prefill-pool"
TRAIN = "granite-3-8b.train4k"
SEED = 2 ** 35 + 11


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_sound_run_is_correct(cell):
    out = tiny_cell.run(cell, SEED)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0


@pytest.mark.parametrize("cell,fault", [
    (SERVE, "token"), (SERVE, "kv_unwritten"),
    (TRAIN, "state_unchanged"), (TRAIN, "half_batch")])
def test_fault_makes_run_incorrect(cell, fault):
    with faults.FAULTS[fault]():
        out = tiny_cell.run(cell, SEED)
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_control_fails_a_limit(cell):
    out = tiny_cell.run(cell, SEED + 1, control=True)
    lim = {c.name: c.limit for c in out.checks}
    ctl = {k[:-len("_control")]: v for k, v in out.extra.items()
           if k.endswith("_control")}
    assert ctl and set(ctl) <= set(lim)
    assert any(v > lim[k] for k, v in ctl.items()), (ctl, lim)
