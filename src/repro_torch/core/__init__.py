"""The paper's analytical blocking model (the port's copy of
``repro.core``, imports re-pointed) and its Hopper instantiation.

    Problem, BlockingString, Loop, Dim     -- loop-nest IR
    place_buffers, analyze                 -- buffer placement + traffic
    energy_custom, energy_fixed, optimize,
    ranked_level0_tiles                    -- energy model + search
    evaluate_multicore, best_scheme        -- coarse-grain parallelism
    FusedProblem, optimize_fused           -- fused producer-consumer
                                              GEMM chains
    HopperTarget, H100_SXM, matmul_tiles, conv_tiles, flash_tiles,
    flash_decode_tile_candidates,
    conv_tile_candidates                   -- Hopper tile derivation
    gemm_lowering_accesses,
    direct_blocking_accesses               -- im2col vs direct blocking
    simulate_fills                         -- the access model, simulated

Everything ``repro.core`` exports has its counterpart here; the Hopper
names (``H100_SXM``, ``HopperTarget``, ``default_smem_budget``) stand in
for the TPU ones (``TPU_V5E``, ``TpuTarget``).
"""

from repro_torch.core.access import TrafficReport, analyze
from repro_torch.core.buffers import (Buffer, Operand, operand_bytes,
                                      place_buffers, table2_refetch_rate)
from repro_torch.core.energy import (DRAM_PJ_PER_16B, MAC_ENERGY_PJ,
                                     access_energy_pj, broadcast_energy_pj,
                                     sram_area_mm2)
from repro_torch.core.fusion import (Epilogue, FusedProblem, FusedTraffic,
                                     FusionResult, fused_energy_pj,
                                     fused_multicore_dram_bytes,
                                     optimize_fused)
from repro_torch.core.gemm_lowering import (GemmLoweringReport,
                                            direct_blocking_accesses,
                                            gemm_lowering_accesses,
                                            lowered_gemm_problem)
from repro_torch.core.hierarchy import (EnergyReport, MemLevel,
                                        cache_accesses, diannao_hierarchy,
                                        energy_custom, energy_fixed,
                                        xeon_hierarchy)
from repro_torch.core.hopper_adapter import (H100_SXM, HopperTarget,
                                             conv_tile_candidates,
                                             conv_tiles,
                                             default_smem_budget,
                                             flash_decode_tile_candidates,
                                             flash_tiles,
                                             layer_sharding_advice,
                                             matmul_tile_candidates,
                                             matmul_tiles)
from repro_torch.core.loopnest import (BlockingString, Dim, Extents, Loop,
                                       Problem, divisors)
from repro_torch.core.multicore import (MulticoreReport, best_scheme,
                                        evaluate_multicore,
                                        sharding_advice)
from repro_torch.core.optimizer import (OptResult, make_objective,
                                        optimize, optimize_beam,
                                        optimize_exhaustive,
                                        ranked_level0_tiles)
from repro_torch.core.validate import simulate_fills

__all__ = [
    "BlockingString", "Dim", "Extents", "Loop", "Problem", "divisors",
    "Buffer", "Operand", "operand_bytes", "place_buffers",
    "table2_refetch_rate",
    "TrafficReport", "analyze",
    "access_energy_pj", "broadcast_energy_pj", "sram_area_mm2",
    "MAC_ENERGY_PJ", "DRAM_PJ_PER_16B",
    "EnergyReport", "MemLevel", "cache_accesses", "diannao_hierarchy",
    "energy_custom", "energy_fixed", "xeon_hierarchy",
    "OptResult", "make_objective", "optimize", "optimize_beam",
    "optimize_exhaustive", "ranked_level0_tiles",
    "MulticoreReport", "best_scheme", "evaluate_multicore",
    "sharding_advice",
    "Epilogue", "FusedProblem", "FusedTraffic", "FusionResult",
    "fused_energy_pj", "fused_multicore_dram_bytes", "optimize_fused",
    "GemmLoweringReport", "direct_blocking_accesses",
    "gemm_lowering_accesses", "lowered_gemm_problem",
    "H100_SXM", "HopperTarget", "default_smem_budget",
    "conv_tile_candidates", "conv_tiles", "flash_decode_tile_candidates",
    "flash_tiles", "layer_sharding_advice", "matmul_tile_candidates",
    "matmul_tiles",
    "simulate_fills",
]
