"""Blocking-schedule optimizer (paper §3.5).

The search space is (loop order) x (split sizes).  Following the paper:

* the *order* space is enumerated per blocking level (all permutations of
  the blockable dims at that level);
* for each order, the split sizes are optimized by coordinate descent over
  the divisor lattice of each dimension (the paper optimizes "parameters"
  per string);
* deep hierarchies are searched iteratively inner->outer with a beam of
  seeds (paper keeps the best 128 inner blockings, perturbs loop sizes and
  exchanges adjacent loops to create new seeds, then extends one level).

The objective is either co-designed-hardware energy (``mode="custom"``,
optionally area-budgeted) or energy/accesses on a fixed hierarchy
(``mode="fixed"``, e.g. a Xeon cache hierarchy).
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Callable, Sequence

from repro_torch.core.access import analyze
from repro_torch.core.hierarchy import (EnergyReport, MemLevel, energy_custom,
                                  energy_fixed)
from repro_torch.core.loopnest import (BlockingString, Dim, Loop, Problem,
                                 divisors, near_divisors)

BLOCK_DIMS = (Dim.X, Dim.Y, Dim.C, Dim.K)


@dataclasses.dataclass(frozen=True)
class OptResult:
    string: BlockingString
    report: EnergyReport

    @property
    def energy_pj(self) -> float:
        return self.report.total_pj

    @property
    def dram_accesses(self) -> int:
        """Total DRAM-boundary accesses (elements) of this schedule."""
        return analyze(self.string).dram_accesses

    def level0_extents(self):
        """Cumulative extents at the end of the innermost blocking level.

        The innermost level ends after the first occurrence of every
        blockable compute dim (X, C, K); the extents below that point are
        the level-0 tile a kernel should materialize on chip.  Used by the
        TPU lowering to turn an optimizer string into BlockSpec tiles.
        """
        s = self.string
        seen: set = set()
        for i, lp in enumerate(s.loops):
            seen.add(lp.dim)
            if {Dim.X, Dim.C, Dim.K} <= seen:
                return s.extents_below(i + 1)
        return s.extents_below(len(s.loops))


def ranked_level0_tiles(problem: Problem,
                        levels: Sequence[MemLevel],
                        align: dict[Dim, int] | None = None,
                        top: int = 8,
                        max_orders: int | None = None) -> list:
    """Ranked level-0 tile extents for a loop nest on a fixed hierarchy.

    The single candidate-ranking entry shared by forward AND backward
    kernel lowering (``core.tpu_adapter``): backward nests (dgrad/wgrad)
    are the same loop-nest family with dims relabelled, so they reuse
    this search + :meth:`OptResult.level0_extents` instead of growing
    their own.  Returns the per-schedule extents in energy rank order.
    """
    objective = make_objective("fixed", levels)
    results = optimize_exhaustive(problem, objective, n_levels=2, top=top,
                                  align=align, max_orders=max_orders)
    return [r.level0_extents() for r in results]


Objective = Callable[[BlockingString], EnergyReport]


def make_objective(mode: str = "custom",
                   levels: Sequence[MemLevel] | None = None,
                   sram_budget_bytes: int | None = None) -> Objective:
    if mode == "custom":
        return lambda s: energy_custom(s, sram_budget_bytes=sram_budget_bytes)
    if mode == "fixed":
        assert levels is not None, "fixed mode needs a hierarchy"
        return lambda s: energy_fixed(s, levels)
    raise ValueError(f"unknown mode {mode!r}")


# -- candidate construction ----------------------------------------------------


def _active_dims(problem: Problem) -> tuple[Dim, ...]:
    dims = [d for d in BLOCK_DIMS if problem.full_extent(d) > 1]
    if problem.N > 1:
        dims.append(Dim.N)
    return tuple(dims)


def _size_candidates(problem: Problem, d: Dim, lo: int, hi: int,
                     align: dict[Dim, int] | None,
                     max_count: int = 12) -> list[int]:
    """Divisors of the full extent within [lo, hi], multiples of ``lo``."""
    cands = [v for v in near_divisors(problem.full_extent(d), max_count * 2)
             if lo <= v <= hi and v % lo == 0 and hi % v == 0]
    if align and d in align:
        aligned = [v for v in cands if v % align[d] == 0 or v == hi or v == lo]
        if aligned:
            cands = aligned
    if not cands:
        cands = [hi]
    return sorted(set(cands))[:max_count * 2]


def build_string(level_orders: Sequence[Sequence[Dim]],
                 sizes: dict[tuple[int, Dim], int],
                 problem: Problem,
                 fw_fh_innermost: bool = True) -> BlockingString:
    """Assemble a BlockingString from per-level dim orders and split sizes.

    ``sizes[(lvl, d)]`` is the cumulative extent of dim ``d`` at level
    ``lvl``; the outermost level is forced to the full extent.
    """
    loops: list[Loop] = []
    if fw_fh_innermost:
        if problem.Fw > 1:
            loops.append(Loop(Dim.FW, problem.Fw))
        if problem.Fh > 1:
            loops.append(Loop(Dim.FH, problem.Fh))
    n_levels = len(level_orders)
    for lvl, order in enumerate(level_orders):
        for d in order:
            ext = (problem.full_extent(d) if lvl == n_levels - 1
                   else sizes.get((lvl, d), problem.full_extent(d)))
            loops.append(Loop(d, ext))
    # cover any dim never mentioned (Fw/Fh when not innermost, N, ...)
    covered = {lp.dim for lp in loops}
    for d in Dim:
        if d not in covered and problem.full_extent(d) > 1:
            loops.append(Loop(d, problem.full_extent(d)))
    return BlockingString(loops, problem)


def _initial_sizes(problem: Problem, dims: Sequence[Dim], n_levels: int,
                   align: dict[Dim, int] | None) -> dict[tuple[int, Dim], int]:
    """Geometric split heuristic: roughly equal ratios per level."""
    sizes: dict[tuple[int, Dim], int] = {}
    for d in dims:
        full = problem.full_extent(d)
        divs = divisors(full)
        for lvl in range(n_levels - 1):
            target = round(full ** ((lvl + 1) / n_levels))
            best = min(divs, key=lambda v: abs(v - target))
            lo = sizes.get((lvl - 1, d), 1)
            if best % lo != 0 or best < lo:
                best = lo
            sizes[(lvl, d)] = best
    return sizes


def coordinate_descent(level_orders: Sequence[Sequence[Dim]],
                       sizes: dict[tuple[int, Dim], int],
                       problem: Problem,
                       objective: Objective,
                       fw_fh_innermost: bool = True,
                       sweeps: int = 3) -> tuple[dict, float, BlockingString]:
    """Optimize split sizes for a fixed order by coordinate descent."""
    n_levels = len(level_orders)
    sizes = dict(sizes)

    def cost(sz) -> tuple[float, BlockingString]:
        s = build_string(level_orders, sz, problem, fw_fh_innermost)
        return objective(s).total_pj, s

    best_cost, best_string = cost(sizes)
    keys = [(lvl, d) for lvl in range(n_levels - 1)
            for d in level_orders[lvl]]
    for _ in range(sweeps):
        improved = False
        for key in keys:
            lvl, d = key
            lo = sizes.get((lvl - 1, d), 1) if lvl > 0 else 1
            hi = sizes.get((lvl + 1, d), problem.full_extent(d)) \
                if lvl + 1 < n_levels - 1 else problem.full_extent(d)
            for cand in _size_candidates(problem, d, lo, hi, None):
                if cand == sizes.get(key):
                    continue
                trial = dict(sizes)
                trial[key] = cand
                try:
                    c, s = cost(trial)
                except ValueError:
                    continue
                if c < best_cost:
                    best_cost, best_string, sizes = c, s, trial
                    improved = True
        if not improved:
            break
    return sizes, best_cost, best_string


# -- exhaustive (short strings) -------------------------------------------------


def optimize_exhaustive(problem: Problem,
                        objective: Objective,
                        n_levels: int = 2,
                        top: int = 32,
                        max_orders: int | None = None,
                        fw_fh_innermost: bool = True,
                        align: dict[Dim, int] | None = None,
                        ) -> list[OptResult]:
    """Enumerate all per-level orders; coordinate-descend sizes for each."""
    dims = _active_dims(problem)
    orders = list(itertools.permutations(dims))
    if max_orders:
        orders = orders[:max_orders]
    results: list[OptResult] = []
    seen: set = set()
    for combo in itertools.product(orders, repeat=n_levels):
        sizes = _initial_sizes(problem, dims, n_levels, align)
        _, cost, s = coordinate_descent(combo, sizes, problem, objective,
                                        fw_fh_innermost)
        if s in seen:
            continue
        seen.add(s)
        results.append(OptResult(s, objective(s)))
    results.sort(key=lambda r: r.energy_pj)
    return results[:top]


# -- iterative beam search (deep hierarchies, paper's fast method) --------------


def optimize_beam(problem: Problem,
                  objective: Objective,
                  n_levels: int = 3,
                  beam: int = 32,
                  perturbations: int = 8,
                  seed: int = 0,
                  fw_fh_innermost: bool = True,
                  align: dict[Dim, int] | None = None,
                  ) -> list[OptResult]:
    """Paper §3.5: optimize 2 levels exhaustively, then repeatedly add an
    outer level, re-optimizing with perturbed seeds."""
    rng = random.Random(seed)
    dims = _active_dims(problem)
    frontier = optimize_exhaustive(problem, objective, n_levels=2, top=beam,
                                   fw_fh_innermost=fw_fh_innermost,
                                   align=align)
    cur_levels = 2
    while cur_levels < n_levels:
        cur_levels += 1
        candidates: list[OptResult] = list(frontier)
        outer_orders = list(itertools.permutations(dims))
        for res in frontier[:beam]:
            inner = _decompose(res.string, problem, fw_fh_innermost)
            seeds = [inner] + [_perturb(inner, problem, rng)
                               for _ in range(perturbations)]
            for sd in seeds:
                for outer in rng.sample(outer_orders,
                                        min(len(outer_orders), 6)):
                    level_orders = list(sd["orders"]) + [outer]
                    sizes = dict(sd["sizes"])
                    # previous outermost level becomes a sized level: start
                    # it at its current full extents scaled down
                    lvl = len(sd["orders"]) - 1
                    for d in dims:
                        full = problem.full_extent(d)
                        lo = sizes.get((lvl - 1, d), 1)
                        cands = _size_candidates(problem, d, lo, full, align)
                        sizes[(lvl, d)] = rng.choice(cands)
                    try:
                        _, cost, s = coordinate_descent(
                            level_orders, sizes, problem, objective,
                            fw_fh_innermost, sweeps=2)
                    except ValueError:
                        continue
                    candidates.append(OptResult(s, objective(s)))
        dedup: dict = {}
        for r in candidates:
            dedup.setdefault(repr(r.string), r)
        frontier = sorted(dedup.values(), key=lambda r: r.energy_pj)[:beam]
    return frontier


def _decompose(s: BlockingString, problem: Problem,
               fw_fh_innermost: bool) -> dict:
    """Recover (level_orders, sizes) from a string built by build_string."""
    dims = _active_dims(problem)
    loops = [lp for lp in s.loops if lp.dim in dims]
    per_level = len(dims)
    orders: list[tuple[Dim, ...]] = []
    sizes: dict[tuple[int, Dim], int] = {}
    for lvl in range(0, len(loops) // per_level):
        chunk = loops[lvl * per_level:(lvl + 1) * per_level]
        orders.append(tuple(lp.dim for lp in chunk))
        for lp in chunk:
            sizes[(lvl, lp.dim)] = lp.extent
    return {"orders": orders, "sizes": sizes}


def _perturb(seed: dict, problem: Problem, rng: random.Random) -> dict:
    """Paper §3.5: random loop-size nudges + adjacent-loop exchanges."""
    orders = [list(o) for o in seed["orders"]]
    sizes = dict(seed["sizes"])
    # exchange two adjacent loops in a random level
    lvl = rng.randrange(len(orders))
    if len(orders[lvl]) >= 2:
        i = rng.randrange(len(orders[lvl]) - 1)
        orders[lvl][i], orders[lvl][i + 1] = orders[lvl][i + 1], orders[lvl][i]
    # nudge one size to an adjacent divisor
    keys = [k for k in sizes if k[0] < len(orders) - 1]
    if keys:
        k = rng.choice(keys)
        _, d = k
        divs = divisors(problem.full_extent(d))
        cur = sizes[k]
        idx = divs.index(cur) if cur in divs else 0
        step = rng.choice([-1, 1])
        sizes[k] = divs[max(0, min(len(divs) - 1, idx + step))]
    return {"orders": [tuple(o) for o in orders], "sizes": sizes}


def optimize(problem: Problem,
             n_levels: int = 2,
             mode: str = "custom",
             levels: Sequence[MemLevel] | None = None,
             sram_budget_bytes: int | None = None,
             beam: int = 32,
             top: int = 10,
             seed: int = 0,
             align: dict[Dim, int] | None = None) -> list[OptResult]:
    """One-call entry point: best ``top`` schedules for a layer."""
    objective = make_objective(mode, levels, sram_budget_bytes)
    if n_levels <= 2:
        return optimize_exhaustive(problem, objective, n_levels, top=top,
                                   align=align)
    return optimize_beam(problem, objective, n_levels, beam=beam, seed=seed,
                         align=align)[:top]
