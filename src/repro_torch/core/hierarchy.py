"""Mapping buffers onto memories and computing total energy (paper §3.5).

Two modes:

* ``custom``  — co-designed hardware: every buffer gets its own SRAM/RF of
  exactly its size (DRAM above 16 MB).  This is the mode used for the
  DianNao-style studies (Figs. 5-8); an optional ``sram_budget_bytes``
  caps total on-chip SRAM: buffers that don't fit are spilled to DRAM,
  largest-and-least-accessed first.
* ``fixed``   — a given memory hierarchy (e.g. a Xeon's L1/L2/L3/DRAM).
  Buffers are packed greedily: repeatedly take the unpacked buffer with
  the highest access count into the lowest memory level with room; once a
  level overflows, that buffer and all later ones go to higher levels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.access import BufferTraffic, TrafficReport, analyze
from repro_torch.core.buffers import (Buffer, Operand, operand_bytes,
                                place_buffers)
from repro_torch.core.energy import (DRAM_PJ_PER_16B, MAC_ENERGY_PJ,
                               access_energy_pj, sram_area_mm2,
                               DATAPATH_AREA_MM2)
from repro_torch.core.loopnest import BlockingString


@dataclasses.dataclass(frozen=True)
class MemLevel:
    name: str
    capacity_bytes: int          # 0 -> unbounded (DRAM)
    energy_pj_per_16b: float

    @classmethod
    def sram(cls, name: str, capacity_bytes: int) -> "MemLevel":
        return cls(name, capacity_bytes, access_energy_pj(capacity_bytes))

    @classmethod
    def dram(cls, name: str = "DRAM") -> "MemLevel":
        return cls(name, 0, DRAM_PJ_PER_16B)


def xeon_hierarchy() -> list[MemLevel]:
    """The paper's evaluation platform (Xeon E5645, §4.1)."""
    return [MemLevel.sram("L1", 32 * 1024),
            MemLevel.sram("L2", 256 * 1024),
            MemLevel.sram("L3", 12 * 1024 * 1024),
            MemLevel.dram()]


def diannao_hierarchy() -> list[MemLevel]:
    """DianNao's split buffers (IB 2KB, KB 32KB, OB 2KB) + DRAM (§5.2)."""
    return [MemLevel.sram("IBuf", 2 * 1024),
            MemLevel.sram("KBuf", 32 * 1024),
            MemLevel.sram("OBuf", 2 * 1024),
            MemLevel.dram()]


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    string: BlockingString
    total_pj: float
    mem_pj: float
    mac_pj: float
    per_buffer_pj: dict[str, float]
    per_level_pj: dict[str, float]
    dram_pj: float
    sram_bytes: int
    area_mm2: float
    placements: dict[str, str]  # buffer name -> level name

    @property
    def pj_per_mac(self) -> float:
        return self.total_pj / self.string.problem.macs

    def summary(self) -> str:
        lines = [f"schedule: {self.string}",
                 f"total {self.total_pj/1e6:.3f} uJ  "
                 f"(mem {self.mem_pj/1e6:.3f} uJ, mac {self.mac_pj/1e6:.3f} "
                 f"uJ, dram {self.dram_pj/1e6:.3f} uJ)  "
                 f"{self.pj_per_mac:.3f} pJ/MAC, area {self.area_mm2:.2f} mm2"]
        for name, pj in sorted(self.per_buffer_pj.items(),
                               key=lambda kv: -kv[1]):
            lines.append(f"  {name:12s} {pj/1e6:10.4f} uJ "
                         f"({self.placements.get(name, '?')})")
        return "\n".join(lines)


def _words(elems: int, bytes_per_elem: int) -> float:
    """accesses in 16-bit words (the Table-3 unit).

    Mixed-precision nests pass each operand's own width here — a 1-byte
    quantized operand moves half the words of the paper's 16-bit data."""
    return elems * bytes_per_elem / 2.0


def energy_custom(s: BlockingString,
                  report: TrafficReport | None = None,
                  sram_budget_bytes: int | None = None,
                  broadcast_extra_pj: float = 0.0) -> EnergyReport:
    """Co-designed hardware: one memory per buffer, sized exactly.

    ``broadcast_extra_pj`` adds a per-16b-word surcharge on the outermost
    on-chip level's fills (used by the multicore model).
    """
    report = report or analyze(s)
    per_buffer: dict[str, float] = {}
    placements: dict[str, str] = {}
    per_level: dict[str, float] = {}
    dram_pj = 0.0
    sram_bytes = 0

    # decide spills under a budget: keep buffers with the highest
    # accesses-per-byte on chip first.
    onchip: dict[str, bool] = {}
    ranked = sorted(report.per_buffer,
                    key=lambda bt: -(bt.total_accesses /
                                     max(bt.buffer.size_elems, 1)))
    used = 0
    for bt in ranked:
        size = bt.buffer.size_bytes(s.problem)
        fits = (size <= 16 * 1024 * 1024 and
                (sram_budget_bytes is None or used + size <=
                 sram_budget_bytes))
        onchip[bt.buffer.name] = fits
        if fits:
            used += size

    for bt in report.per_buffer:
        b = bt.buffer
        size = b.size_bytes(s.problem)
        if onchip[b.name]:
            e_self = access_energy_pj(size)
            sram_bytes += size
        else:
            e_self = DRAM_PJ_PER_16B
        # serving reads below + receiving fills/writebacks happens here
        pj = _words(bt.total_accesses,
                    operand_bytes(s.problem, b.operand)) * e_self
        # the parent of the outermost buffer of each operand is DRAM; its
        # reads/writes on our behalf are DRAM accesses.
        per_buffer[b.name] = pj
        placements[b.name] = "DRAM" if not onchip[b.name] else \
            f"SRAM{size//1024}K" if size >= 1024 else f"RF{size}B"
        per_level[placements[b.name]] = per_level.get(placements[b.name],
                                                      0.0) + pj

    # DRAM traffic: the fills+writebacks of each operand's outermost ON-CHIP
    # buffer cross the DRAM boundary (plus all accesses of spilled buffers,
    # already costed at DRAM energy above).
    for op, elems in report.dram_accesses_by_operand.items():
        pj = _words(elems, operand_bytes(s.problem, op)) * DRAM_PJ_PER_16B
        dram_pj += pj
    per_level["DRAM"] = per_level.get("DRAM", 0.0) + dram_pj

    if broadcast_extra_pj:
        # surcharge on outermost-level fills (multicore broadcast)
        outer = {}
        for bt in report.per_buffer:
            outer[bt.buffer.operand] = bt  # last one per operand is outermost
        for bt in outer.values():
            per_buffer[bt.buffer.name] += _words(
                bt.parent_traffic,
                operand_bytes(s.problem, bt.buffer.operand)) * \
                broadcast_extra_pj

    mem_pj = sum(per_buffer.values()) + dram_pj
    mac_pj = s.problem.macs * MAC_ENERGY_PJ
    return EnergyReport(
        string=s, total_pj=mem_pj + mac_pj, mem_pj=mem_pj, mac_pj=mac_pj,
        per_buffer_pj=per_buffer, per_level_pj=per_level, dram_pj=dram_pj,
        sram_bytes=sram_bytes,
        area_mm2=sram_area_mm2(sram_bytes) + DATAPATH_AREA_MM2,
        placements=placements)


def pack_fixed(report: TrafficReport,
               levels: Sequence[MemLevel]) -> dict[str, MemLevel]:
    """Paper §3.5 greedy packing onto a fixed hierarchy."""
    problem = report.string.problem
    remaining = {lv.name: lv.capacity_bytes for lv in levels}
    order = sorted(report.per_buffer, key=lambda bt: -bt.total_accesses)
    placements: dict[str, MemLevel] = {}
    level_idx = 0
    for bt in order:
        size = bt.buffer.size_bytes(problem)
        while level_idx < len(levels) - 1 and \
                remaining[levels[level_idx].name] < size:
            level_idx += 1  # this and all subsequent buffers go higher
        lv = levels[level_idx]
        if lv.capacity_bytes:
            remaining[lv.name] -= size
        placements[bt.buffer.name] = lv
    return placements


def energy_fixed(s: BlockingString, levels: Sequence[MemLevel],
                 report: TrafficReport | None = None) -> EnergyReport:
    """Energy of a blocking on a fixed (e.g. CPU cache) hierarchy."""
    report = report or analyze(s)
    placements = pack_fixed(report, levels)
    per_buffer: dict[str, float] = {}
    per_level: dict[str, float] = {}
    dram_pj = 0.0
    sram_bytes = 0
    for bt in report.per_buffer:
        lv = placements[bt.buffer.name]
        pj = _words(bt.total_accesses,
                    operand_bytes(s.problem, bt.buffer.operand)) * \
            lv.energy_pj_per_16b
        per_buffer[bt.buffer.name] = pj
        per_level[lv.name] = per_level.get(lv.name, 0.0) + pj
        if lv.capacity_bytes:
            sram_bytes += bt.buffer.size_bytes(s.problem)
    for op, elems in report.dram_accesses_by_operand.items():
        dram_pj += _words(elems, operand_bytes(s.problem, op)) * \
            DRAM_PJ_PER_16B
    per_level["DRAM"] = per_level.get("DRAM", 0.0) + dram_pj
    mem_pj = sum(per_buffer.values()) + dram_pj
    mac_pj = s.problem.macs * MAC_ENERGY_PJ
    return EnergyReport(
        string=s, total_pj=mem_pj + mac_pj, mem_pj=mem_pj, mac_pj=mac_pj,
        per_buffer_pj=per_buffer, per_level_pj=per_level, dram_pj=dram_pj,
        sram_bytes=sram_bytes,
        area_mm2=sram_area_mm2(sram_bytes) + DATAPATH_AREA_MM2,
        placements={k: v.name for k, v in placements.items()})


def cache_accesses(s: BlockingString, levels: Sequence[MemLevel],
                   report: TrafficReport | None = None,
                   operand_weights: dict[Operand, int] | None = None,
                   ) -> dict[str, int]:
    """Access counts per fixed level — reproduces the paper's Fig. 3/4
    L2/L3 access-count comparison.

    Counts are CUMULATIVE down the hierarchy, matching hardware counters
    on inclusive caches: a request served by an L3-resident buffer also
    accesses L2 (allocation on the miss path), so accesses(L) includes the
    demand of every buffer living at L or further out.

    ``operand_weights`` multiplies each operand's accesses (default 1 =
    element counts).  Passing per-operand byte widths turns the same
    placement walk into byte traffic — the single accounting shared with
    ``tune.predicted_dram_bytes``, so the miss-path rules can never
    diverge between the count and byte ranks."""
    from repro_torch.core.buffers import buffers_by_operand

    report = report or analyze(s)
    placements = pack_fixed(report, levels)
    level_idx = {lv.name: i for i, lv in enumerate(levels)}
    dram_idx = len(levels) - 1
    counts: dict[str, int] = {lv.name: 0 for lv in levels}
    traffic = {bt.buffer.name: bt for bt in report.per_buffer}
    by_op = buffers_by_operand([bt.buffer for bt in report.per_buffer])
    for op, chain in by_op.items():
        w = 1 if operand_weights is None else operand_weights[op]
        homes = [level_idx[placements[b.name].name] for b in chain]
        for i, b in enumerate(chain):
            bt = traffic[b.name]
            home = homes[i]
            parent = homes[i + 1] if i + 1 < len(chain) else dram_idx
            # demand served to the level below passes through this level
            # and every level between it and the datapath
            for lv in range(home, -1, -1):
                counts[levels[lv].name] += bt.reads_served * w
            # fills/writebacks travel the miss path up to the parent home
            for lv in range(min(home + 1, dram_idx), max(parent, home) + 1):
                counts[levels[lv].name] += bt.parent_traffic * w
    return counts
