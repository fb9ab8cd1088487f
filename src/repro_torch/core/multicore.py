"""Coarse-grain parallelism model (paper §3.3, Fig. 2, Fig. 9; the port's
copy of ``repro.core.multicore``, imports re-pointed).

Unrolling an outer loop of the blocking string across ``S`` cores:

* **K partitioning**  — unroll an outer ``K`` loop.  KB and OB are
  partitioned per-core (each 1/S the size -> cheaper accesses); IB stays
  global and every fill is a *broadcast* whose energy is modeled as an
  access to a memory the size of the total on-chip memory (paper §3.4).
* **XY partitioning** — unroll an outer ``X``/``Y`` loop.  IB and OB are
  partitioned; KB is global and broadcast.

A multi-layer CNN also pays a *shuffle* cost between layers when the next
layer needs data partitioned differently (for K partitioning the output
channels are scattered across cores and must be re-broadcast).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.access import analyze
from repro_torch.core.buffers import (Operand, buffers_by_operand,
                                      operand_bytes, place_buffers)
from repro_torch.core.energy import (DRAM_PJ_PER_16B, access_energy_pj,
                                     broadcast_energy_pj)
from repro_torch.core.loopnest import BlockingString, Dim, Loop, Problem


PARTITION_SCHEMES = ("K", "XY")

# which operand stays global (broadcast) under each scheme
_BROADCAST_OPERAND = {"K": Operand.INPUT, "XY": Operand.WEIGHT}
# which dims get divided across cores
_PARTITION_DIMS = {"K": (Dim.K,), "XY": (Dim.X, Dim.Y)}


@dataclasses.dataclass(frozen=True)
class MulticoreReport:
    scheme: str
    cores: int
    string: BlockingString
    private_pj: float        # energy inside each core, summed over cores
    ll_ib_pj: float          # last-level IB
    ll_kb_pj: float          # last-level KB
    ll_ob_pj: float          # last-level OB
    dram_pj: float
    shuffle_pj: float
    broadcast_pj: float

    @property
    def onchip_pj(self) -> float:
        return (self.private_pj + self.ll_ib_pj + self.ll_kb_pj +
                self.ll_ob_pj + self.shuffle_pj + self.broadcast_pj)

    @property
    def total_pj(self) -> float:
        return self.onchip_pj + self.dram_pj

    @property
    def total_macs(self) -> int:
        # ``string`` is the per-core problem; all cores run concurrently
        return self.string.problem.macs * self.cores

    @property
    def pj_per_mac(self) -> float:
        return self.total_pj / self.total_macs


def _partition_candidates(s: BlockingString, scheme: str,
                          cores: int) -> list[BlockingString]:
    """All ways to divide one outer partitionable loop by ``cores`` (the
    unrolled loop disappears into space); the per-core problem shrinks on
    that dim.  The caller picks the cheapest — the paper unrolls whichever
    outer loop preserves the most reuse."""
    dims = _PARTITION_DIMS[scheme]
    problem = s.problem
    out: list[BlockingString] = []
    seen_dims: set[Dim] = set()
    for pos in range(len(s.loops) - 1, -1, -1):
        lp = s.loops[pos]
        if lp.dim in seen_dims:
            continue  # only the outermost occurrence of each dim
        if lp.dim not in dims or s.iterations(pos) % cores or \
                s.iterations(pos) < cores:
            continue
        seen_dims.add(lp.dim)
        field = {Dim.X: "X", Dim.Y: "Y", Dim.K: "K"}[lp.dim]
        sub_problem = dataclasses.replace(
            problem, **{field: problem.full_extent(lp.dim) // cores})
        new_loops = []
        for q, l2 in enumerate(s.loops):
            if l2.dim is lp.dim and \
                    l2.extent > sub_problem.full_extent(lp.dim):
                ext = max(l2.extent // cores,
                          s.extents_below(q).get(l2.dim))
                new_loops.append(Loop(l2.dim, ext))
            else:
                new_loops.append(l2)
        out.append(BlockingString(new_loops, sub_problem))
    if not out:
        raise ValueError(f"no outer {dims} loop divisible by {cores} "
                         f"cores in {s}")
    return out


def evaluate_multicore(s: BlockingString, scheme: str, cores: int,
                       layers: int = 1) -> MulticoreReport:
    """Total energy of ``cores`` cores running the blocking ``s``.

    The per-core blocking is ``s`` with the partitioned dim divided by S.
    The broadcast operand's last-level fills each pay the broadcast bus
    energy; the partitioned operands' last-level buffers shrink by S.
    """
    if scheme not in PARTITION_SCHEMES:
        raise ValueError(f"scheme must be one of {PARTITION_SCHEMES}")
    if cores > 1:
        cands = _partition_candidates(s, scheme, cores)
        reports = [_evaluate_partitioned(c, scheme, cores, layers)
                   for c in cands]
        return min(reports, key=lambda r: r.total_pj)
    return _evaluate_partitioned(s, scheme, cores, layers)


def _evaluate_partitioned(per_core: BlockingString, scheme: str,
                          cores: int, layers: int) -> MulticoreReport:
    report = analyze(per_core)
    problem = per_core.problem

    by_op = buffers_by_operand([bt.buffer for bt in report.per_buffer])
    last_level = {op: chain[-1] for op, chain in by_op.items() if chain}
    traffic = {bt.buffer.name: bt for bt in report.per_buffer}

    # total on-chip bytes across all cores (for broadcast distance and area)
    total_onchip = 0
    for op, chain in by_op.items():
        for b in chain:
            sz = b.size_bytes(problem)
            if sz <= 16 * 1024 * 1024:
                total_onchip += sz * (1 if b is last_level[op] and
                                      op is _BROADCAST_OPERAND[scheme]
                                      else cores)
    e_bcast = broadcast_energy_pj(total_onchip)

    private_pj = 0.0
    ll_pj = {Operand.INPUT: 0.0, Operand.WEIGHT: 0.0, Operand.OUTPUT: 0.0}
    broadcast_pj = 0.0

    for op, chain in by_op.items():
        # mixed-precision nests: each operand's words counted at its own
        # width, matching the per-operand buffer sizes fed to
        # access_energy_pj below
        bpe = operand_bytes(problem, op)
        for b in chain:
            bt = traffic[b.name]
            words = bt.total_accesses * bpe / 2.0
            size = b.size_bytes(problem)
            is_ll = b is last_level[op]
            shared = is_ll and op is _BROADCAST_OPERAND[scheme]
            if shared:
                # one shared structure; every fill it serves below is a
                # broadcast across the die (no surcharge at 1 core)
                ll_pj[op] += words * access_energy_pj(size)
                if cores > 1:
                    broadcast_pj += (bt.reads_served * bpe / 2.0) * e_bcast
                # the shared buffer serves all cores with one broadcast, so
                # reads_served is NOT multiplied by cores.
            elif is_ll:
                ll_pj[op] += cores * words * access_energy_pj(size)
            else:
                private_pj += cores * words * access_energy_pj(size)

    # DRAM traffic: partitioned operands stream disjoint data (cores x
    # per-core traffic = whole-problem traffic); the broadcast operand is
    # fetched once for all cores.
    dram_pj = 0.0
    for op, elems in report.dram_accesses_by_operand.items():
        mult = 1 if op is _BROADCAST_OPERAND[scheme] else cores
        dram_pj += (elems * operand_bytes(problem, op) / 2.0) * \
            DRAM_PJ_PER_16B * mult

    # shuffle: restoring the output layout for the next layer (K scheme
    # scatters channels across cores -> all-to-all once per layer)
    shuffle_pj = 0.0
    if cores > 1 and layers > 0 and scheme == "K":
        out_words = problem.output_elems * cores * problem.output_bpe / 2.0
        shuffle_pj = out_words * e_bcast * layers

    return MulticoreReport(
        scheme=scheme, cores=cores, string=per_core,
        private_pj=private_pj, ll_ib_pj=ll_pj[Operand.INPUT],
        ll_kb_pj=ll_pj[Operand.WEIGHT], ll_ob_pj=ll_pj[Operand.OUTPUT],
        dram_pj=dram_pj, shuffle_pj=shuffle_pj, broadcast_pj=broadcast_pj)


def best_scheme(s: BlockingString, cores: int) -> MulticoreReport:
    """Paper's rule, derived: share the LARGE buffer (its broadcast is then
    ~free relative to its access energy); partition the small ones."""
    reports = [evaluate_multicore(s, sch, cores) for sch in PARTITION_SCHEMES]
    return min(reports, key=lambda r: r.total_pj)


def sharding_advice(problem: Problem, s: BlockingString) -> str:
    """The scheme choice at mesh scale: K-partitioning == tensor-parallel
    (shard weights), XY == data/sequence parallel."""
    kb = problem.weight_elems * problem.weight_bpe
    ib = problem.input_elems * problem.input_bpe
    return "tensor_parallel" if kb >= ib else "data_parallel"
