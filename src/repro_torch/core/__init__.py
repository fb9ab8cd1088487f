"""The paper's analytical blocking model (the port's copy of
``repro.core``, imports re-pointed) and its Hopper instantiation.

    Problem, BlockingString, Loop, Dim     -- loop-nest IR
    place_buffers, analyze                 -- buffer placement + traffic
    energy_fixed, optimize, ranked_level0_tiles -- energy model + search
    HopperTarget, H100_SXM, matmul_tiles, conv_tiles,
    flash_decode_tile_candidates,
    conv_tile_candidates                   -- Hopper tile derivation
    gemm_lowering_accesses,
    direct_blocking_accesses               -- im2col vs direct blocking
    simulate_fills                         -- the access model, simulated

``fusion`` and ``multicore`` are not ported yet (``ROADMAP.md``, queue 1,
items 13 and 4).
"""

from repro_torch.core.access import TrafficReport, analyze
from repro_torch.core.buffers import Buffer, Operand, place_buffers
from repro_torch.core.gemm_lowering import (GemmLoweringReport,
                                            direct_blocking_accesses,
                                            gemm_lowering_accesses,
                                            lowered_gemm_problem)
from repro_torch.core.hierarchy import (EnergyReport, MemLevel,
                                        cache_accesses, energy_fixed)
from repro_torch.core.hopper_adapter import (H100_SXM, HopperTarget,
                                             conv_tile_candidates,
                                             conv_tiles,
                                             default_smem_budget,
                                             flash_decode_tile_candidates,
                                             matmul_tile_candidates,
                                             matmul_tiles)
from repro_torch.core.loopnest import (BlockingString, Dim, Loop, Problem,
                                       divisors)
from repro_torch.core.optimizer import (OptResult, optimize,
                                        ranked_level0_tiles)
from repro_torch.core.validate import simulate_fills

__all__ = [
    "BlockingString", "Dim", "Loop", "Problem", "divisors",
    "Buffer", "Operand", "place_buffers", "TrafficReport", "analyze",
    "EnergyReport", "MemLevel", "cache_accesses", "energy_fixed",
    "OptResult", "optimize", "ranked_level0_tiles",
    "H100_SXM", "HopperTarget", "default_smem_budget",
    "conv_tile_candidates", "conv_tiles",
    "flash_decode_tile_candidates", "matmul_tile_candidates",
    "matmul_tiles",
    "GemmLoweringReport", "direct_blocking_accesses",
    "gemm_lowering_accesses", "lowered_gemm_problem",
    "simulate_fills",
]
