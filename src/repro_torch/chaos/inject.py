"""Schedule-cache fault injection (the port of
``repro.chaos.inject.CorruptScheduleCache``)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.hopper_adapter import default_smem_budget


def _halvings(t: int) -> list[int]:
    """``t``, and its half where that is whole and at least 8."""
    return [t, t // 2] if t % 2 == 0 and t >= 16 else [t]


class CorruptScheduleCache:
    """A schedule cache whose hits are deliberately pessimal.

    For ops whose name contains ``match`` it returns the analytic winner
    with its tiles replaced by the variant that requests the most bytes
    (``obs.profile.kernel_hbm_bytes``) among the winner's tiles, each
    kept or halved (down to 8), that its kernel still runs: the key's own footprint and
    instance checks (``tune.fits_smem``; for the bf16 GEMM keys the
    tensor-core instances' warp grids and, at M <= 16, the decode
    instance's bn), which ``best_schedule`` applies to cached tiles too.
    JAX halves every tile, which its kernels' DMA elision turns into more
    traffic; here a plain halving may be refused, or move no more bytes
    (a bk only changes the staging step).  Specs with no such variant are
    not corrupted (the lookup misses).  Installed with
    ``tune.set_default_cache`` by ``python -m repro_torch.profile
    --corrupt`` to exercise the profiler's fidelity gate end to end.
    """

    def __init__(self, match: str):
        self.match = match

    def lookup(self, spec):
        from repro_torch import tune
        from repro_torch.obs.profile import kernel_hbm_bytes
        if self.match not in spec.op:
            return None
        top = tune.analytic_schedule(spec)
        budget = default_smem_budget()
        best, best_bytes = None, kernel_hbm_bytes(spec, top.tiles)
        variants = [()]
        for t in top.tiles:
            variants = [v + (h,) for v in variants for h in _halvings(t)]
        for tiles in variants:
            if tiles == top.tiles or not tune.fits_smem(spec, tiles, budget):
                continue
            b = kernel_hbm_bytes(spec, tiles)
            if b > best_bytes:
                best, best_bytes = tiles, b
        if best is None:
            return None
        return dataclasses.replace(top, tiles=best, source="cache")

    def store(self, schedule):
        pass
