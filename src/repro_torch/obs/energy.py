"""Per-op energy pricing for the kernel profiler (the port of
``repro.obs.energy``).

Every number here is *modeled with the paper's figures* (the
per-16-bit DRAM access at 320 pJ, size-dependent SRAM accesses, the MAC
array), not measured on the card: the card reports no energy per
kernel.  The paper's model (``core.energy`` /
``core.hierarchy``) prices a blocking string: every on-chip buffer at
its size-dependent SRAM cost, the DRAM boundary at the fixed
per-16-byte cost, plus the MACs.  The profiler re-prices the DRAM
component on the kernel's own byte count (``kernels.*.hbm_bytes``, the
bytes the CUDA grid's loads and stores request) instead of the model's
idealized stream, so a stale cached schedule that moves more bytes shows
up in picojoules too.

Ops whose resolved tiles do not divide the problem price as ``None``:
the kernels run such tiles masked, but the paper's model has no blocking
string for them.
"""

from __future__ import annotations

from repro_torch.core.energy import DRAM_PJ_PER_16B


def op_energy_pj(spec, tiles: tuple[int, ...],
                 dram_bytes: int | None) -> dict | None:
    """Modeled energy split (pJ) of one kernel call under ``tiles``.

    ``dram_bytes`` is the call's byte count; the SRAM and MAC components
    come from the paper's model evaluated on the blocking string the
    kernel executes (``tune.schedule_to_string``).  Returns ``None``
    when the tiles do not divide the problem."""
    from repro_torch.core.hierarchy import energy_custom
    from repro_torch.tune import divides, schedule_to_string

    if dram_bytes is None or not divides(spec, tuple(tiles)):
        return None
    rep = energy_custom(schedule_to_string(spec, tuple(tiles)))
    dram_pj = dram_bytes / 2.0 * DRAM_PJ_PER_16B   # per 16-bit word
    sram_pj = max(rep.mem_pj - rep.dram_pj, 0.0)
    mac_pj = rep.mac_pj
    total = dram_pj + sram_pj + mac_pj
    macs = spec.problem().macs
    return {
        "dram_pj": dram_pj,
        "sram_pj": sram_pj,
        "mac_pj": mac_pj,
        "total_pj": total,
        "pj_per_mac": total / macs if macs else None,
    }
