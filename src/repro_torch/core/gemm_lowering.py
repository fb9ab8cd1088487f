"""im2col + GEMM baseline access model (paper §2.2, Figs. 3-4; the port's
copy of ``repro.core.gemm_lowering``, imports re-pointed).

Caffe-style implementations *lower* the 3-D convolution into a matrix
multiplication:

    weights  W  : (K, C*Fw*Fh)
    lowered  L  : (C*Fw*Fh, X*Y)     <- each input pixel replicated Fw*Fh x
    output   O  : (K, X*Y)

The lowering both (a) replicates input data ``Fw*Fh``-fold and (b) destroys
the sliding-window locality, so even a perfectly cache-blocked GEMM does
more cache traffic than direct blocked convolution.  We model the blocked
GEMM with the same analytical machinery (a GEMM is a degenerate conv) and
add the lowering pass traffic, giving the ATLAS/MKL-like curves of
Figs. 3-4.  MKL and ATLAS differ in their blocking quality; we model MKL
as a 2-level-blocked GEMM with register blocking and ATLAS as a more
conservative single-level cache blocking, which brackets the measured 2-8x
(L2) and 2-11x (L3) gaps in the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.access import analyze
from repro_torch.core.hierarchy import MemLevel, cache_accesses, pack_fixed
from repro_torch.core.loopnest import BlockingString, Dim, Loop, Problem
from repro_torch.core.optimizer import make_objective, optimize_exhaustive


@dataclasses.dataclass(frozen=True)
class GemmLoweringReport:
    conv: Problem
    gemm: Problem
    lowering_write_elems: int      # building the lowered matrix
    lowering_read_elems: int       # reading the input while lowering
    cache_counts: dict[str, int]   # per-level accesses incl. lowering


def lowered_gemm_problem(p: Problem) -> Problem:
    """The GEMM the conv becomes after im2col."""
    return Problem.gemm(M=p.X * p.Y * p.N, N_cols=p.K,
                        K_reduce=p.C * p.Fw * p.Fh,
                        bytes_per_elem=p.bytes_per_elem)


def _blocked_gemm_string(g: Problem, levels: Sequence[MemLevel],
                         quality: str) -> BlockingString:
    """A representative blocked-GEMM schedule.

    ``quality='mkl'``: 2-level blocking tuned per hierarchy (good GEMM).
    ``quality='atlas'``: fixed NB=64ish single-level cache blocking.
    """
    objective = make_objective("fixed", levels)
    if quality == "mkl":
        res = optimize_exhaustive(g, objective, n_levels=2, top=1,
                                  max_orders=8)
        return res[0].string
    # ATLAS-like: one cache-blocking level with square-ish NB tiles
    from repro_torch.core.loopnest import divisors

    def close_div(n: int, t: int) -> int:
        return min(divisors(n), key=lambda v: abs(v - t))

    mb = close_div(g.X, 64)
    nb = close_div(g.K, 64)
    kb = close_div(g.C, 64)
    loops = [Loop(Dim.C, kb), Loop(Dim.X, mb), Loop(Dim.K, nb),
             Loop(Dim.C, g.C), Loop(Dim.K, g.K), Loop(Dim.X, g.X)]
    if g.N > 1:
        loops.append(Loop(Dim.N, g.N))
    return BlockingString(loops, g)


def gemm_lowering_accesses(p: Problem, levels: Sequence[MemLevel],
                           quality: str = "mkl") -> GemmLoweringReport:
    """Cache accesses of lowering + blocked GEMM for conv layer ``p``."""
    g = lowered_gemm_problem(p)
    s = _blocked_gemm_string(g, levels, quality)
    counts = dict(cache_accesses(s, levels))

    # lowering pass: read every input pixel once per kernel position it
    # lands in (Fw*Fh), write the replicated matrix once.  These run
    # through the cache hierarchy; the write traffic is the lowered-matrix
    # size, which at CFwFh x XY rarely fits on chip -> charge to the level
    # that can hold it (usually L3/DRAM), reads stream through L1.
    lower_writes = g.X * g.C  # == X*Y*N * C*Fw*Fh elements
    lower_reads = lower_writes  # each written element is read from input
    lowered_bytes = lower_writes * p.bytes_per_elem
    home = len(levels) - 1
    for i, lv in enumerate(levels):
        if lv.capacity_bytes and lowered_bytes <= lv.capacity_bytes:
            home = i
            break
    # the lowering pass streams through every cache level up to where the
    # replicated matrix lives (cumulative counting, matching PAPI)
    for i in range(home + 1):
        counts[levels[i].name] = counts.get(levels[i].name, 0) + \
            lower_writes + lower_reads
    # GEMM then re-reads the lowered matrix from wherever it lives: already
    # accounted by the blocked-GEMM model's input traffic.
    return GemmLoweringReport(conv=p, gemm=g,
                              lowering_write_elems=lower_writes,
                              lowering_read_elems=lower_reads,
                              cache_counts=counts)


def direct_blocking_accesses(p: Problem, levels: Sequence[MemLevel],
                             n_levels: int = 2) -> dict[str, int]:
    """Our direct blocking's per-level cache accesses for comparison."""
    objective = make_objective("fixed", levels)
    res = optimize_exhaustive(p, objective, n_levels=n_levels, top=1)
    return dict(cache_accesses(res[0].string, levels))
