"""Schedule tuner: the paper's blocking optimizer driving the port's
kernels (the port of ``repro.tune``: ``"matmul"``, ``"matmul_dgrad"``
(the training path's backward GEMMs), ``"flash_decode"``, the fused
path's ``"matmul_fused"``, ``"qkv_fused"`` and ``"flash_decode_oproj"``,
the quantized path's ``"matmul_w8"``, ``"matmul_fused_w8"`` and
``"flash_decode_fp8"``, and the
conv path's ``"conv2d"``, ``"conv2d_dgrad"`` and ``"conv2d_wgrad"``, each
with a stride).

The analytical model (``repro_torch.core``) derives candidate blockings
on the Hopper target; this package lowers them to the CUDA kernels' tile
tuples, optionally times the top few on the card, and persists winners in
a JSON cache so every later process -- including the default paths of
``kernels.ops`` and the paged engine's page size -- gets tuned tiles.

Entry points:

* :func:`best_schedule` -- cheap, never measures: the cached schedule if
  one exists for this (op, shapes, dtype, stride, device), else the
  analytic winner.  ``kernels.ops.matmul`` and ``ops.conv2d`` consult it
  on every call with ``tiles=None``.
* :func:`tune_op` -- the full loop: rank candidates analytically, time
  the top-N on the card, persist the winner.  Run offline
  (``python -m repro_torch.tune ...``) to pre-populate the cache.
"""

from __future__ import annotations

import functools

from repro_torch.core.hopper_adapter import (H100_SXM, HopperTarget,
                                             default_smem_budget)
from repro_torch.tune.cache import (ScheduleCache, default_cache_path,
                                    device_kind)
from repro_torch.tune.lowering import (candidates, divides, fits_smem,
                                       level0_dram_bytes,
                                       predicted_dram_accesses,
                                       predicted_dram_bytes,
                                       schedule_to_string)
from repro_torch.tune.schedule import (CONV_OPS, MMA_GEMM_OPS, OpSpec,
                                      Schedule)

__all__ = [
    "OpSpec", "Schedule", "ScheduleCache", "analytic_schedule",
    "best_schedule", "candidates",
    "default_cache_path", "describe_candidates", "device_kind", "divides",
    "fits_smem", "level0_dram_bytes", "predicted_dram_accesses",
    "predicted_dram_bytes", "schedule_to_string", "set_default_cache",
    "set_schedule_observer", "tune_op",
]

_default_cache = ScheduleCache()


def set_default_cache(cache: ScheduleCache) -> ScheduleCache:
    """Swap the process-wide schedule cache; returns the previous one.

    The profiler's ``--corrupt`` fault injection plants a deliberately
    bad cached schedule this way and watches the fidelity gate catch it;
    tests use it to isolate cache state.  Also drops the analytic memo,
    so the swap is visible to specs resolved before it."""
    global _default_cache
    prev = _default_cache
    _default_cache = cache
    _derive.cache_clear()
    return prev


# One process-wide callable notified of every best_schedule resolution
# with ``(spec, schedule)`` -- in the eager port, every tuned kernel call;
# it must be cheap and must not call back into best_schedule.  ``None``
# (the default) costs one comparison.  ``obs.dram.DramLedger.scope``
# installs its ledger here for the scope's duration.
_SCHEDULE_OBSERVER = None


def set_schedule_observer(fn):
    """Install ``fn(spec, schedule)`` as the resolution observer;
    returns the previous observer (``None`` to uninstall)."""
    global _SCHEDULE_OBSERVER
    prev = _SCHEDULE_OBSERVER
    _SCHEDULE_OBSERVER = fn
    return prev


def describe_candidates(spec: OpSpec) -> str:
    """Human-readable ranked candidate table (CLI output)."""
    lines = []
    for i, s in enumerate(candidates(spec)):
        acc = (f"{s.predicted_dram_accesses:.3e}"
               if s.predicted_dram_accesses is not None else "n/a")
        lines.append(f"  #{i}: tiles={s.tiles}  "
                     f"predicted DRAM accesses={acc}")
    return "\n".join(lines)


@functools.lru_cache(maxsize=1024)
def _derive(spec: OpSpec, smem_budget_bytes: int | None,
            target: HopperTarget) -> Schedule:
    return candidates(spec, smem_budget_bytes, target)[0]


def analytic_schedule(spec: OpSpec,
                      target: HopperTarget = H100_SXM) -> Schedule:
    """The blocking model's winner for ``spec`` at the default budget
    (memoized; never reads the cache): what :func:`best_schedule`
    returns on a miss."""
    return _derive(spec, None, target)


def best_schedule(op: str, dims: tuple[int, ...], dtype: str = "float32",
                  cache: ScheduleCache | None = None,
                  smem_budget_bytes: int | None = None,
                  target: HopperTarget = H100_SXM,
                  stride: int = 1) -> Schedule:
    """Cached-or-derived schedule for one op instance (never measures).

    ``dims`` is ``(M, N, K)`` for ``"matmul"``, ``"matmul_fused"``,
    ``"matmul_w8"`` and ``"matmul_fused_w8"``, the cotangent's ``(M_out,
    N_out, K_reduce)`` for ``"matmul_dgrad"``, ``(M, Nkv, K, G)`` for
    ``"qkv_fused"``, ``(G, S, D)`` for ``"flash_decode"`` and
    ``"flash_decode_fp8"``, ``(G, S, D, E)`` for ``"flash_decode_oproj"``
    and ``(X, Y, C, K, Fw, Fh)`` for the conv keys, whose ``stride`` is
    part of the spec (``"conv2d_dgrad"`` is searched at stride 1).  A
    cache hit (same op, shapes, dtype, stride and device kind) wins
    outright, unless an explicit
    ``smem_budget_bytes`` is given that its tiles overflow, or a conv
    key's or a bf16 ``MMA_GEMM_OPS`` key's tiles do not fit its kernel's
    footprint at the default budget (a tile cached for another
    footprint, which the kernel's wrapper would refuse: row 12's bf16
    instance stages every tap in whole 8-channel chunks; the bf16 GEMM
    instances take their own warp grids, and at decode a bn of
    ``MMA_T_COLS``); otherwise the analytic top candidate is derived
    in-process (memoized, not persisted -- run :func:`tune_op` to
    measure and persist).
    """
    spec = OpSpec(op, tuple(dims), dtype, stride)
    hit = (cache or _default_cache).lookup(spec)
    if hit is not None and hit.spec == spec and (
            (smem_budget_bytes is None and spec.op not in CONV_OPS
             and not (spec.op in MMA_GEMM_OPS and spec.itemsize == 2)) or
            fits_smem(spec, hit.tiles,
                      default_smem_budget(target, smem_budget_bytes),
                      target)):
        result = hit
    else:
        result = _derive(spec, smem_budget_bytes, target)
    obs = _SCHEDULE_OBSERVER
    if obs is not None:
        obs(spec, result)
    return result


def tune_op(op: str, dims: tuple[int, ...], dtype: str = "float32",
            top_n: int = 3, measure: bool = True,
            cache: ScheduleCache | None = None,
            stride: int = 1) -> Schedule:
    """Full tuning loop for one op instance; returns the winner.

    Candidates are ranked by the paper's predicted DRAM accesses; with
    ``measure=True`` the top ``top_n`` are also timed on the card
    (``tune.measure``; raises without a CUDA device) and the fastest
    wins.  The winner lands in the schedule cache under the current
    device kind, where :func:`best_schedule` -- and so the default paths
    of ``kernels.ops`` and the paged engine -- will find it.
    """
    spec = OpSpec(op, tuple(dims), dtype, stride)
    ranked = candidates(spec)
    if measure:
        from repro_torch.tune import measure as measure_mod
        ranked = measure_mod.measure_top(ranked, top_n=top_n)
    winner = ranked[0]
    (cache or _default_cache).store(winner)
    return winner
