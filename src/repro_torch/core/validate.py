"""Independent validation of the analytical access model (the port's copy
of ``repro.core.validate``, imports re-pointed).

``simulate_fills`` *executes* the blocked loop nest index space in program
order and tracks, for every buffer the placement rules allocate, the tuple
of relevant outer-loop indices that determines its contents.  Fills are
counted when that tuple changes (i.e. eviction/refill events are observed,
not derived from a closed-form product).  Agreement with
:func:`repro_torch.core.access.analyze` is a strong check on the
reuse/eviction logic — the two implementations share only the
buffer-placement rules.

Only practical for small problems (the trace has ``total_iterations``
steps); tests use reduced layer dims.
"""

from __future__ import annotations

import itertools

from repro_torch.core.access import OUTPUT_ADDR_DIMS
from repro_torch.core.buffers import OPERAND_DIMS, Operand, place_buffers
from repro_torch.core.loopnest import BlockingString


def simulate_fills(s: BlockingString) -> dict[str, tuple[int, int]]:
    """Returns {buffer_name: (fill_elems, writeback_elems)} by simulation."""
    bufs = [b for b in place_buffers(s) if b.pos >= 0]
    n = len(s.loops)
    trip = [s.iterations(q) for q in range(n)]

    state = {}
    for b in bufs:
        rel = OPERAND_DIMS[b.operand]
        rel_pos = [q for q in range(b.pos + 1, n) if s.loops[q].dim in rel]
        if b.operand is Operand.OUTPUT:
            # the block leaves the buffer when its ADDRESSING key changes;
            # reduction loops accumulate in place (no writeback).
            addr_pos = [q for q in range(b.pos + 1, n)
                        if s.loops[q].dim in OUTPUT_ADDR_DIMS]
            state[b.name] = {
                "buffer": b, "addr_pos": addr_pos,
                "last_addr": None, "seen_addr": set(),
                "fills": 0, "writebacks": 0}
        else:
            state[b.name] = {"buffer": b, "rel_pos": rel_pos,
                             "last_key": None, "fills": 0, "writebacks": 0}

    # iterate the index space in execution order (outermost varies slowest)
    ranges = [range(trip[q]) for q in range(n - 1, -1, -1)]  # outer..inner
    for idx_outer_first in itertools.product(*ranges):
        idx = idx_outer_first[::-1]  # idx[q] = current index of loop q
        for st in state.values():
            b = st["buffer"]
            if b.operand is Operand.OUTPUT:
                addr = tuple(idx[q] for q in st["addr_pos"])
                if addr != st["last_addr"]:
                    if st["last_addr"] is not None:
                        st["writebacks"] += b.size_elems  # epoch ended
                    if addr in st["seen_addr"]:
                        st["fills"] += b.size_elems  # partials read back
                    st["seen_addr"].add(addr)
                    st["last_addr"] = addr
            else:
                key = tuple(idx[q] for q in st["rel_pos"])
                if key != st["last_key"]:
                    st["fills"] += b.size_elems
                    st["last_key"] = key
    # final epoch writeback for outputs
    for st in state.values():
        if st["buffer"].operand is Operand.OUTPUT and \
                st["last_addr"] is not None:
            st["writebacks"] += st["buffer"].size_elems
    return {name: (st["fills"], st["writebacks"])
            for name, st in state.items()}
