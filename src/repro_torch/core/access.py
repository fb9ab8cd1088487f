"""Exact per-level access counts for a blocked loop nest (paper §3.4, Eq. 1).

The paper expresses per-level accesses through refetch rates ``RR_i`` (its
Table 2) and ``total = alpha * prod RR_i``.  We implement the same quantity
from first principles, which handles every loop order uniformly (including
the ``Fw``/``Fh``-outside orders the table elides):

For a buffer ``B`` of operand ``P`` allocated at string position ``p``,
its contents are a function of the indices of the loops *above* ``p`` whose
dimension indexes ``P``.  Reuse across an outer loop is captured only when
no content-changing loop lies between ``B`` and that outer loop, hence:

    fills(B) = footprint_P(extents below p) * prod_{q >= r*} iters(q)

where ``r*`` is the innermost loop above ``p`` whose dim indexes ``P``
(no such loop -> the buffer is filled exactly once).

Outputs additionally move partial sums: with addressing dims
``A = {X, Y, K, N}`` and reduction dims ``R = {C, Fw, Fh}``, a block is
written up at the end of each residency epoch and read back when a
reduction loop above an addressing loop revisits it:

    epochs  = prod_{q >= rA*} iters(q)        (rA* = first A-loop above p)
    blocks  = prod_{q > p, dim in A} iters(q)
    writes_up  = footprint * epochs
    reads_down = footprint * (epochs - blocks)   # first visit starts at 0

The halo of input blocks is refetched on every fill (the paper's
"refetches to overlapping regions of blocked tiles").
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.buffers import (Buffer, Operand, OPERAND_DIMS,
                                buffers_by_operand, place_buffers)
from repro_torch.core.loopnest import BlockingString, Dim, Extents

OUTPUT_ADDR_DIMS = frozenset({Dim.X, Dim.Y, Dim.K, Dim.N})


@dataclasses.dataclass(frozen=True)
class BufferTraffic:
    """Traffic (elements) crossing the boundary just above one buffer."""

    buffer: Buffer
    fills: int          # elements written into this buffer from its parent
    writebacks: int     # elements written up to the parent (outputs only)
    reads_served: int   # elements this buffer serves to the level below it

    @property
    def parent_traffic(self) -> int:
        """Accesses the *parent* level performs on this buffer's behalf."""
        return self.fills + self.writebacks

    @property
    def total_accesses(self) -> int:
        """Accesses performed *at* this buffer (serve below + own fills)."""
        return self.reads_served + self.fills + self.writebacks


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    string: BlockingString
    per_buffer: tuple[BufferTraffic, ...]
    dram_accesses_by_operand: dict[Operand, int]

    @property
    def dram_accesses(self) -> int:
        return sum(self.dram_accesses_by_operand.values())

    def accesses_at(self, buffer_name: str) -> int:
        for bt in self.per_buffer:
            if bt.buffer.name == buffer_name:
                return bt.total_accesses
        raise KeyError(buffer_name)


def _first_relevant_above(s: BlockingString, pos: int,
                          dims: frozenset[Dim]) -> int | None:
    for q in range(pos + 1, len(s.loops)):
        if s.loops[q].dim in dims and s.iterations(q) > 1:
            return q
    return None


def _prod_iters_from(s: BlockingString, start: int | None) -> int:
    if start is None:
        return 1
    return s.prod_iterations_from(start)


def _blocks_above(s: BlockingString, pos: int, dims: frozenset[Dim]) -> int:
    n = 1
    for q in range(pos + 1, len(s.loops)):
        if s.loops[q].dim in dims:
            n *= s.iterations(q)
    return n


def _read_fills(s: BlockingString, b: Buffer) -> int:
    """fills (elements) of a read-only operand buffer."""
    rel = OPERAND_DIMS[b.operand]
    r_star = _first_relevant_above(s, b.pos, rel)
    return b.size_elems * _prod_iters_from(s, r_star)


def _output_traffic(s: BlockingString, b: Buffer) -> tuple[int, int]:
    """(reads_down, writes_up) for an output buffer."""
    ra = _first_relevant_above(s, b.pos, OUTPUT_ADDR_DIMS)
    epochs = _prod_iters_from(s, ra)
    blocks = _blocks_above(s, b.pos, OUTPUT_ADDR_DIMS)
    writes_up = b.size_elems * epochs
    reads_down = b.size_elems * max(epochs - blocks, 0)
    return reads_down, writes_up


def analyze(s: BlockingString,
            buffers: Sequence[Buffer] | None = None) -> TrafficReport:
    """Compute traffic for every buffer implied by the blocking string."""
    bufs = list(buffers) if buffers is not None else place_buffers(s)
    by_op = buffers_by_operand(bufs)
    traffic: list[BufferTraffic] = []
    dram: dict[Operand, int] = {}

    for op, chain in by_op.items():
        # chain sorted inner -> outer; parent of the outermost is DRAM.
        fills_chain: list[int] = []
        wb_chain: list[int] = []
        for b in chain:
            if op is Operand.OUTPUT:
                reads_down, writes_up = _output_traffic(s, b)
                fills_chain.append(reads_down)
                wb_chain.append(writes_up)
            else:
                fills_chain.append(_read_fills(s, b))
                wb_chain.append(0)
        # reads each buffer serves below = the child's parent-side traffic;
        # the innermost buffer serves the datapath (1 access / MAC; 2 for
        # the output read-modify-write).
        macs = s.problem.macs
        demand0 = 2 * macs if op is Operand.OUTPUT else macs
        for i, b in enumerate(chain):
            served = demand0 if i == 0 else fills_chain[i - 1] + wb_chain[i - 1]
            traffic.append(BufferTraffic(b, fills_chain[i], wb_chain[i],
                                         served))
        dram[op] = fills_chain[-1] + wb_chain[-1] if chain else demand0
    return TrafficReport(s, tuple(traffic), dram)
