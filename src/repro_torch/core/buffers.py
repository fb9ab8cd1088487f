"""Buffer placement for a blocking string (paper §3.2, Table 2).

Walking the string inner -> outer, every loop that *reuses* one operand
forces a buffer for that operand sized to the footprint of everything below:

* a new ``K`` loop reuses the **input** block across kernels  -> ``IB``
* a new ``C`` loop reduces into the same **outputs**          -> ``OB``
* a new ``X``/``Y`` (or ``N``) loop reuses the **weights**    -> ``KB``
* a new ``Fw``/``Fh`` loop reuses both inputs and outputs     -> ``IB`` + ``OB``

Level-0 registers for all three operands always exist below the innermost
loop (the datapath reads operands from somewhere).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

from repro_torch.core.loopnest import (BlockingString, Dim, Extents, Problem,
                                 INPUT_DIMS, OUTPUT_DIMS, WEIGHT_DIMS)


class Operand(enum.Enum):
    INPUT = "IB"
    WEIGHT = "KB"
    OUTPUT = "OB"

    def __repr__(self) -> str:
        return self.value


OPERAND_DIMS = {
    Operand.INPUT: INPUT_DIMS,
    Operand.WEIGHT: WEIGHT_DIMS,
    Operand.OUTPUT: OUTPUT_DIMS,
}


def operand_bytes(problem: Problem, op: "Operand") -> int:
    """Element width of one operand — the single mixed-precision lookup
    shared by buffer sizing (here) and traffic/energy weighting
    (``core.hierarchy`` / ``core.access``)."""
    if op is Operand.INPUT:
        return problem.input_bpe
    if op is Operand.WEIGHT:
        return problem.weight_bpe
    return problem.output_bpe

# Which loop dimensions trigger a buffer for which operand when added above.
REUSE_RULES: dict[Dim, tuple[Operand, ...]] = {
    Dim.K: (Operand.INPUT,),
    Dim.C: (Operand.OUTPUT,),
    Dim.X: (Operand.WEIGHT,),
    Dim.Y: (Operand.WEIGHT,),
    Dim.N: (Operand.WEIGHT,),
    Dim.FW: (Operand.INPUT, Operand.OUTPUT),
    Dim.FH: (Operand.INPUT, Operand.OUTPUT),
}


@dataclasses.dataclass(frozen=True)
class Buffer:
    """One buffer in the hierarchy implied by a blocking string.

    ``pos`` is the string position the buffer sits *below* (the loop at
    ``pos`` is the one whose reuse this buffer captures).  ``pos == -1``
    denotes the level-0 register operand latches below everything.
    """

    operand: Operand
    pos: int
    size_elems: int
    extents: Extents  # extents covered below ``pos`` (the block it holds)

    def size_bytes(self, problem: Problem) -> int:
        return self.size_elems * operand_bytes(problem, self.operand)

    @property
    def name(self) -> str:
        return f"{self.operand.value}@{self.pos}"

    def __repr__(self) -> str:
        return f"{self.name}[{self.size_elems}]"


def _footprint(op: Operand, e: Extents, problem: Problem) -> int:
    if op is Operand.INPUT:
        return e.input_footprint(problem.stride)
    if op is Operand.WEIGHT:
        return e.weight_footprint()
    return e.output_footprint()


def place_buffers(s: BlockingString) -> list[Buffer]:
    """Paper §3.2 placement: returns buffers sorted inner -> outer.

    A buffer is only materialized when the loop actually provides reuse
    (trip count > 1) and when the buffer would be larger than what already
    exists for that operand below (placing an identical copy is pointless).
    """
    problem = s.problem
    bufs: list[Buffer] = []
    # level-0 operand registers (one element each, conceptually the datapath
    # latches); they anchor the access-count recursion.
    e0 = Extents()
    for op in Operand:
        bufs.append(Buffer(op, -1, 1, e0))
    largest: dict[Operand, int] = {op: 1 for op in Operand}

    for pos, lp in enumerate(s.loops):
        if s.iterations(pos) <= 1:
            continue  # degenerate loop: no reuse, no buffer
        below = s.extents_below(pos)
        for op in REUSE_RULES[lp.dim]:
            size = _footprint(op, below, problem)
            if size > largest[op]:
                bufs.append(Buffer(op, pos, size, below))
                largest[op] = size
    return bufs


def buffers_by_operand(bufs: Iterable[Buffer]) -> dict[Operand, list[Buffer]]:
    out: dict[Operand, list[Buffer]] = {op: [] for op in Operand}
    for b in bufs:
        out[b.operand].append(b)
    for op in out:
        out[op].sort(key=lambda b: b.pos)
    return out


def table2_refetch_rate(s: BlockingString, pos: int,
                        op: Operand) -> float:
    """Paper Table 2 refetch rates, for cross-checking the access model.

    Only defined for the (new-loop, buffer) pairs the table lists.
    """
    lp = s.loops[pos]
    below = s.extents_below(pos)
    p = s.problem
    if lp.dim is Dim.K and op is Operand.INPUT:
        ix = (below.X - 1) * p.stride + below.Fw
        iy = (below.Y - 1) * p.stride + below.Fh
        return (lp.extent * iy * ix) / (below.K * below.Y * below.X)
    if lp.dim is Dim.C and op is Operand.OUTPUT:
        return 2.0 * lp.extent / below.C
    if lp.dim in (Dim.X, Dim.Y, Dim.N) and op is Operand.WEIGHT:
        return lp.extent / below.get(lp.dim)
    raise ValueError(f"Table 2 has no entry for loop {lp} / {op}")
