"""Fused producer-consumer loop nests (inter-layer blocking; the port's
copy of ``repro.core.fusion``, imports re-pointed).

The single-nest model blocks one loop nest at a time, so every op's
output round-trips through DRAM before the next op reads it.
Communication lower bounds for CNN pipelines (Demmel & Dinh 2018) and
fusion-aware design-space exploration (Li et al. 2021) both locate the
next order-of-magnitude win *between* nests: pick a joint level-0 tile such that the producer's
output tile stays resident in the fast level and feeds the consumer
directly — the intermediate operand then contributes **zero** DRAM
traffic.

:class:`FusedProblem` models a chain of GEMM-family :class:`Problem`
stages where stage ``i``'s output tensor is stage ``i+1``'s input
tensor (same row dim M, the fused dimension).  Pointwise epilogues
(bias, activation, gating multiply, residual add) attach to each stage
as an :class:`Epilogue`: run standalone they round-trip the stage
output through DRAM; fused they only stream their extra operands.

Traffic accounting reuses the paper's machinery verbatim: every stage
is scored by ``core.hierarchy.cache_accesses`` on the blocking string
its kernel executes, with per-operand byte weights — the intermediate
operand is eliminated by zeroing its weight on *both* sides (producer
output, consumer input) when its fusion tile fits the level-0 budget
alongside both stages' working sets.  Buffer sizing is fusion-aware:
stages adjacent to a resident intermediate search under a budget
reduced by the resident tile.  Energy and multicore traffic get the
same correction (:func:`fused_energy_pj`, :func:`fused_multicore_dram_bytes`);
under K-partitioning the intermediate's channels are scattered across
cores while the consumer reduces over all of them, so fusion across
that boundary buys nothing — only XY partitioning keeps the win.

The level-0 memory keeps the reference's name, ``"VMEM"``; on the H100
it stands for a block's shared memory, and the budget a caller passes
is the Hopper one (``hopper_adapter.default_smem_budget()``).  The
numbers are the reference's, caveats included: ``traffic(...,
always_resident=True)`` may report a resident intermediate and still
total more bytes than the unfused chain.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.buffers import Operand, operand_bytes
from repro_torch.core.energy import DRAM_PJ_PER_16B, access_energy_pj
from repro_torch.core.hierarchy import (MemLevel, cache_accesses,
                                        energy_fixed)
from repro_torch.core.loopnest import (BlockingString, Dim, Loop, Problem,
                                       divisors)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Pointwise tail of one stage (always fusible into its producer).

    ``extra_operands`` counts streamed same-shape-as-output tensors the
    epilogue reads (a residual add or a gating multiply each add one);
    ``bias`` adds one (N,)-row read.  ``act`` is informational (the
    kernels use it; the traffic model only cares about operand counts).
    """

    act: str = "none"
    bias: bool = False
    extra_operands: int = 0

    @property
    def is_trivial(self) -> bool:
        return (self.act == "none" and not self.bias
                and self.extra_operands == 0)


def _gemm_dims(p: Problem) -> tuple[int, int, int]:
    """(M, N, K) of a GEMM-family Problem (X=M, K=N_cols, C=K_reduce)."""
    return p.X, p.K, p.C


def _gemm_string(p: Problem, tiles: tuple[int, int, int]) -> BlockingString:
    """The blocking string the blocked-GEMM kernels execute: level-0
    (bk, bm, bn) VMEM block, then the grid with the reduction minor-most
    (mirrors ``tune.lowering.schedule_to_string``)."""
    M, N, K = _gemm_dims(p)
    bm, bk, bn = tiles
    return BlockingString(
        [Loop(Dim.C, bk), Loop(Dim.X, bm), Loop(Dim.K, bn),
         Loop(Dim.C, K), Loop(Dim.K, N), Loop(Dim.X, M)], p)


@dataclasses.dataclass(frozen=True)
class FusedTraffic:
    """DRAM-byte breakdown of one fused schedule."""

    tiles: tuple[tuple[int, int, int], ...]
    per_stage_bytes: tuple[int, ...]        # nest traffic, fused epilogues
    epilogue_bytes: tuple[int, ...]         # streamed extras (fused)
    intermediate_bytes: tuple[int, ...]     # per fusion edge; 0 = resident
    intermediate_resident: tuple[bool, ...]
    unfused_total_bytes: int                # same tiles, nothing fused

    @property
    def total_bytes(self) -> int:
        return (sum(self.per_stage_bytes) + sum(self.epilogue_bytes)
                + sum(self.intermediate_bytes))

    @property
    def savings_bytes(self) -> int:
        return self.unfused_total_bytes - self.total_bytes

    @property
    def savings_frac(self) -> float:
        return self.savings_bytes / max(self.unfused_total_bytes, 1)


@dataclasses.dataclass(frozen=True)
class FusedProblem:
    """A chain of GEMM stages sharing intermediates along the row dim.

    Stage ``i``'s output tensor (M x N_i) is stage ``i+1``'s input
    tensor, so consecutive stages must agree: ``stages[i].K ==
    stages[i+1].C`` (the produced width is the consumed reduction) and
    all stages share M (``X``) and batch (``N``).
    """

    stages: tuple[Problem, ...]
    epilogues: tuple[Epilogue, ...]

    def __post_init__(self):
        if len(self.stages) < 2:
            raise ValueError("a FusedProblem needs at least two stages")
        if len(self.epilogues) != len(self.stages):
            raise ValueError("one Epilogue per stage")
        for i, p in enumerate(self.stages):
            if p.Y != 1 or p.Fw != 1 or p.Fh != 1:
                raise ValueError(
                    f"stage {i} is not a GEMM-family nest: {p}")
            if p.X != self.stages[0].X or p.N != self.stages[0].N:
                raise ValueError(
                    f"stage {i} does not share the fused row dim "
                    f"(M={p.X}, expected {self.stages[0].X})")
        for i in range(len(self.stages) - 1):
            if self.stages[i].K != self.stages[i + 1].C:
                raise ValueError(
                    f"stage {i} produces width {self.stages[i].K} but "
                    f"stage {i + 1} consumes {self.stages[i + 1].C}")

    # -- constructors ---------------------------------------------------------

    @classmethod
    def pair(cls, producer: Problem, consumer: Problem,
             producer_epilogue: Epilogue | None = None,
             consumer_epilogue: Epilogue | None = None) -> "FusedProblem":
        return cls((producer, consumer),
                   (producer_epilogue or Epilogue(),
                    consumer_epilogue or Epilogue()))

    @classmethod
    def mlp(cls, M: int, d_model: int, d_ff: int,
            bytes_per_elem: int = 2, swiglu: bool = False,
            weight_bytes: int | None = None) -> "FusedProblem":
        """The transformer MLP block: up-projection (+ activation, + the
        gating multiply for SwiGLU) feeding the down-projection (+ the
        residual add).  ``weight_bytes=1`` models the w8-quantized
        variant (quantization composes with fusion)."""
        up = Problem.gemm(M=M, N_cols=d_ff, K_reduce=d_model,
                          bytes_per_elem=bytes_per_elem,
                          weight_bytes=weight_bytes)
        down = Problem.gemm(M=M, N_cols=d_model, K_reduce=d_ff,
                            bytes_per_elem=bytes_per_elem,
                            weight_bytes=weight_bytes)
        return cls((up, down),
                   (Epilogue(act="silu" if swiglu else "gelu",
                             extra_operands=1 if swiglu else 0),
                    Epilogue(extra_operands=1)))   # residual add

    # -- geometry -------------------------------------------------------------

    @property
    def M(self) -> int:
        return self.stages[0].X

    def intermediate_elems(self, i: int) -> int:
        """Elements of the tensor between stage ``i`` and ``i+1``."""
        return self.stages[i].output_elems

    def intermediate_bpe(self, i: int) -> int:
        return self.stages[i].output_bpe

    def intermediate_tile_bytes(self, i: int, bm: int) -> int:
        """Level-0 bytes of the fusion tile: ``bm`` rows of the full
        intermediate width (the consumer reduces over all of it)."""
        return bm * self.stages[i].K * self.stages[i].N * \
            self.intermediate_bpe(i)

    def _stage_tile_bytes(self, i: int,
                          tiles: tuple[int, int, int]) -> int:
        """Streamed + resident working set of stage ``i``'s kernel step
        (the reference's blocked-GEMM footprint: a double-buffered
        streamed pair plus the output tile and its fp32 accumulator)."""
        p = self.stages[i]
        bm, bk, bn = tiles
        streamed = 2 * (bm * bk * p.input_bpe + bk * bn * p.weight_bpe)
        resident = bm * bn * (p.output_bpe + 4)       # out + fp32 acc
        return streamed + resident

    def validate_tiles(self, tiles: Sequence[tuple[int, int, int]]) -> None:
        if len(tiles) != len(self.stages):
            raise ValueError("one (bm, bk, bn) tile per stage")
        bm0 = tiles[0][0]
        for i, (t, p) in enumerate(zip(tiles, self.stages)):
            bm, bk, bn = t
            M, N, K = _gemm_dims(p)
            if bm != bm0:
                raise ValueError(
                    f"stage {i} bm={bm} != shared fusion tile {bm0}")
            if M % bm or K % bk or N % bn:
                raise ValueError(
                    f"stage {i} tiles {t} do not divide dims "
                    f"{(M, N, K)}")

    def intermediate_fits(self, i: int,
                          tiles: Sequence[tuple[int, int, int]],
                          budget: int) -> bool:
        """True iff the fusion tile between stages ``i``/``i+1`` stays
        level-0 resident next to both stages' working sets."""
        bm = tiles[i][0]
        need = (self.intermediate_tile_bytes(i, bm)
                + self._stage_tile_bytes(i, tiles[i])
                + self._stage_tile_bytes(i + 1, tiles[i + 1]))
        return need <= budget

    # -- traffic --------------------------------------------------------------

    def _stage_operand_bytes(self, i: int, tiles: tuple[int, int, int],
                             budget: int) -> dict[Operand, int]:
        """One stage's DRAM bytes split per operand.

        ``cache_accesses`` is linear in its operand weights (the
        placement walk itself is weight-independent), so scoring each
        operand alone is an exact decomposition of the stage total —
        which is what lets the fusion model zero the intermediate on
        both sides without re-deriving the miss-path rules."""
        p = self.stages[i]
        s = _gemm_string(p, tiles)
        levels = [MemLevel.sram("VMEM", budget), MemLevel.dram("HBM")]
        out: dict[Operand, int] = {}
        for op in Operand:
            w = {o: (operand_bytes(p, o) if o is op else 0)
                 for o in Operand}
            out[op] = cache_accesses(s, levels, operand_weights=w)["HBM"]
        return out

    def _stage_dram_bytes(self, i: int, tiles: tuple[int, int, int],
                          budget: int) -> int:
        return sum(self._stage_operand_bytes(i, tiles, budget).values())

    def _epilogue_bytes(self, i: int, fused: bool) -> int:
        """Epilogue DRAM bytes.  Standalone (unfused) it re-reads and
        re-writes the stage output around the pointwise op; fused it
        only streams its extra operands (they are consumed tile-by-tile
        inside the producer's epilogue)."""
        ep = self.epilogues[i]
        p = self.stages[i]
        out_bytes = p.output_elems * p.output_bpe
        extras = ep.extra_operands * out_bytes
        bias = p.K * p.output_bpe if ep.bias else 0
        if fused:
            return extras + bias
        if ep.is_trivial:
            return 0
        return 2 * out_bytes + extras + bias    # read + write round-trip

    def unfused_dram_bytes(self, tiles: Sequence[tuple[int, int, int]],
                           budget: int) -> int:
        """The pair (chain) run as separate ops at the SAME tiles: every
        stage round-trips its output, every epilogue is a standalone
        pointwise pass."""
        self.validate_tiles(tiles)
        total = 0
        for i in range(len(self.stages)):
            total += self._stage_dram_bytes(i, tiles[i], budget)
            total += self._epilogue_bytes(i, fused=False)
        return total

    def _variant(self, tiles: Sequence[tuple[int, int, int]], budget: int,
                 resident: tuple[bool, ...],
                 ) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(per-stage bytes, per-edge intermediate bytes) for one choice
        of which fusion edges keep their intermediate level-0 resident.

        Fusion-aware buffer sizing: a stage adjacent to a resident
        intermediate is placed under a budget reduced by the resident
        tile — the VMEM pressure that can evict the weight tile and
        make fusion *lose* (docs/fusion.md)."""
        n = len(self.stages)
        per_stage: list[int] = []
        edge_io: list[list[int]] = [[0, 0] for _ in range(n - 1)]
        for i in range(n):
            eff = budget
            if i > 0 and resident[i - 1]:
                eff -= self.intermediate_tile_bytes(i - 1, tiles[i][0])
            if i < n - 1 and resident[i]:
                eff -= self.intermediate_tile_bytes(i, tiles[i][0])
            ob = self._stage_operand_bytes(i, tiles[i], max(eff, 1))
            stage = ob[Operand.WEIGHT]
            if i == 0:
                stage += ob[Operand.INPUT]
            else:
                edge_io[i - 1][1] = ob[Operand.INPUT]
            if i == n - 1:
                stage += ob[Operand.OUTPUT]
            else:
                edge_io[i][0] = ob[Operand.OUTPUT]
            per_stage.append(stage)
        inter = tuple(0 if resident[i] else sum(edge_io[i])
                      for i in range(n - 1))
        return tuple(per_stage), inter

    def traffic(self, tiles: Sequence[tuple[int, int, int]],
                budget: int,
                always_resident: bool = False) -> FusedTraffic:
        """DRAM bytes of the fused schedule (and the same-tile unfused
        baseline).  Epilogues always fuse.  An intermediate *may* be
        eliminated when its fusion tile fits level 0
        (:meth:`intermediate_fits`); by default the model keeps it
        resident only when that actually lowers total traffic —
        spilling the tile is always available to a fused kernel, so
        predicted fused bytes never exceed the unfused chain's.
        ``always_resident=True`` forces every fitting edge resident
        (the budget squeeze then shows exactly when fusion loses)."""
        self.validate_tiles(tiles)
        n = len(self.stages)
        fits = [self.intermediate_fits(i, tiles, budget)
                for i in range(n - 1)]
        free_edges = [i for i, f in enumerate(fits) if f]
        best: tuple[int, tuple, tuple, tuple] | None = None
        masks = ([(1 << len(free_edges)) - 1] if always_resident
                 else range(1 << len(free_edges)))
        for mask in masks:
            resident = [False] * (n - 1)
            for b, e in enumerate(free_edges):
                resident[e] = bool(mask >> b & 1)
            per_stage, inter = self._variant(tiles, budget,
                                             tuple(resident))
            total = sum(per_stage) + sum(inter)
            if best is None or total < best[0]:
                best = (total, per_stage, inter, tuple(resident))
        _, per_stage, inter, resident = best
        epi = tuple(self._epilogue_bytes(i, fused=True) for i in range(n))
        return FusedTraffic(
            tiles=tuple(tuple(t) for t in tiles),
            per_stage_bytes=per_stage,
            epilogue_bytes=epi,
            intermediate_bytes=inter,
            intermediate_resident=resident,
            unfused_total_bytes=self.unfused_dram_bytes(tiles, budget))

    def fused_dram_bytes(self, tiles: Sequence[tuple[int, int, int]],
                         budget: int) -> int:
        return self.traffic(tiles, budget).total_bytes


# -- energy & multicore (fusion-aware weighting) ------------------------------


def fused_energy_pj(fp: FusedProblem,
                    tiles: Sequence[tuple[int, int, int]],
                    budget: int) -> float:
    """Memory energy of the fused chain on a VMEM+DRAM hierarchy: the
    per-stage fixed-hierarchy energy, with each eliminated
    intermediate's DRAM round-trip re-priced at the on-chip level's
    access energy (the accesses still happen — in VMEM).

    Which intermediates count as eliminated comes from
    :meth:`FusedProblem.traffic`'s residency choice — NOT from the raw
    fits test — so the energy and byte models can never disagree about
    whether a fusion edge was taken."""
    fp.validate_tiles(tiles)
    resident = fp.traffic(tiles, budget).intermediate_resident
    levels = [MemLevel.sram("VMEM", budget), MemLevel.dram("HBM")]
    total = 0.0
    for i, p in enumerate(fp.stages):
        total += energy_fixed(_gemm_string(p, tiles[i]), levels).mem_pj
    vmem_pj = access_energy_pj(budget)
    for i in range(len(fp.stages) - 1):
        if resident[i]:
            words = (fp.intermediate_elems(i) * fp.intermediate_bpe(i)
                     / 2.0)
            # write-up + read-down round trip moves from DRAM to VMEM
            total -= 2 * words * DRAM_PJ_PER_16B
            total += 2 * words * vmem_pj
    return total


def fused_multicore_dram_bytes(fp: FusedProblem,
                               tiles: Sequence[tuple[int, int, int]],
                               budget: int, scheme: str,
                               cores: int) -> int:
    """DRAM bytes of the fused chain across ``cores`` (paper §3.3).

    XY partitioning splits the shared row dim M: each core owns a
    disjoint row slab of every stage AND of the intermediate, so the
    per-core fusion works and the intermediate is eliminated exactly as
    on one core.  K partitioning scatters stage ``i``'s output channels
    across cores while stage ``i+1`` reduces over all of them — the
    intermediate must be exchanged (the paper's shuffle), so fusion
    eliminates nothing across that boundary.
    """
    if scheme not in ("K", "XY"):
        raise ValueError(f"scheme must be 'K' or 'XY', got {scheme!r}")
    fp.validate_tiles(tiles)
    if scheme == "XY":
        # per-core: same chain with M/cores rows; total = cores x per-core
        if fp.M % cores:
            raise ValueError(f"M={fp.M} not divisible by {cores} cores")
        sub = FusedProblem(
            tuple(dataclasses.replace(p, X=p.X // cores)
                  for p in fp.stages), fp.epilogues)
        sub_tiles = [(min(t[0], sub.M), t[1], t[2]) for t in tiles]
        if any(sub.M % t[0] for t in sub_tiles):
            bm = max(d for d in divisors(sub.M) if d <= tiles[0][0])
            sub_tiles = [(bm, t[1], t[2]) for t in tiles]
        return cores * sub.fused_dram_bytes(sub_tiles, budget)
    # K scheme: per-stage traffic parallelizes, but every fusion edge is
    # forced through memory (count the intermediate even when it "fits")
    total = 0
    for i in range(len(fp.stages)):
        total += fp._stage_dram_bytes(i, tiles[i], budget)
        total += fp._epilogue_bytes(i, fused=True)
    return total


# -- joint schedule search ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusionResult:
    """One ranked joint schedule from :func:`optimize_fused`."""

    traffic: FusedTraffic

    @property
    def tiles(self) -> tuple[tuple[int, int, int], ...]:
        return self.traffic.tiles

    @property
    def fused_bytes(self) -> int:
        return self.traffic.total_bytes

    @property
    def unfused_bytes(self) -> int:
        return self.traffic.unfused_total_bytes

    @property
    def savings_bytes(self) -> int:
        return self.traffic.savings_bytes

    @property
    def savings_frac(self) -> float:
        return self.traffic.savings_frac

    def summary(self) -> str:
        res = "".join("R" if r else "-"
                      for r in self.traffic.intermediate_resident)
        return (f"tiles={self.tiles} fused={self.fused_bytes:.3e}B "
                f"unfused={self.unfused_bytes:.3e}B "
                f"saves {100 * self.savings_frac:.1f}% [{res}]")


def _aligned_divs(n: int, align: int, cap: int = 16) -> list[int]:
    divs = [d for d in divisors(n) if d % align == 0 or d == n]
    if not divs:
        divs = [n]
    return divs[-cap:]


def optimize_fused(fp: FusedProblem, budget: int,
                   m_align: int = 8, n_align: int = 128,
                   top: int = 8) -> list[FusionResult]:
    """Search joint level-0 tiles for the fused chain.

    The shared fusion tile ``bm`` couples the stages; given ``bm`` (and
    the budget squeeze of any resident intermediate) the per-stage
    (bk, bn) choices decouple, so each stage greedily minimizes its own
    walk — the paper's coordinate-descent shape specialized to the
    fusion structure.  Results are ranked by fused DRAM bytes.
    """
    results: list[FusionResult] = []
    for bm in _aligned_divs(fp.M, m_align):
        tiles: list[tuple[int, int, int]] = []
        feasible = True
        for i, p in enumerate(fp.stages):
            M, N, K = _gemm_dims(p)
            # budget squeeze: assume the adjacent intermediates resident
            squeeze = 0
            if i > 0:
                squeeze += fp.intermediate_tile_bytes(i - 1, bm)
            if i < len(fp.stages) - 1:
                squeeze += fp.intermediate_tile_bytes(i, bm)
            eff = max(budget - squeeze, 1)
            best: tuple[int, tuple[int, int, int]] | None = None
            for bk in _aligned_divs(K, min(n_align, K)):
                for bn in _aligned_divs(N, min(n_align, N)):
                    t = (bm, bk, bn)
                    if fp._stage_tile_bytes(i, t) > max(eff, budget // 4):
                        continue
                    cost = fp._stage_dram_bytes(i, t, budget)
                    if best is None or cost < best[0]:
                        best = (cost, t)
            if best is None:
                feasible = False
                break
            tiles.append(best[1])
        if not feasible:
            continue
        results.append(FusionResult(fp.traffic(tiles, budget)))
    results.sort(key=lambda r: (r.fused_bytes, -r.tiles[0][0]))
    return results[:top]
