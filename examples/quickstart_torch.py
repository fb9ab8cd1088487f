"""Quickstart on the PyTorch/CUDA port: the paper's blocking optimizer in
five minutes.

Finds the optimal blocking for a VGG conv layer, prints the energy
breakdown, compares against the im2col+GEMM baseline, and shows the
H100 tiles the same model derives for a transformer projection and for
long-context attention.  Touches no device.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core import (Problem, direct_blocking_accesses,
                              flash_tiles, gemm_lowering_accesses,
                              make_objective, matmul_tiles,
                              optimize_exhaustive, xeon_hierarchy)


def main() -> None:
    # ---- 1. a conv layer (VGG-D conv3_2, the paper's Conv4) ------------
    p = Problem(X=56, Y=56, C=128, K=256, Fw=3, Fh=3)
    print(f"Conv4: {p.macs/1e9:.2f} GMACs, weights "
          f"{p.weight_elems*2/1e6:.1f} MB")

    # ---- 2. find the optimal 2-level blocking --------------------------
    best = optimize_exhaustive(p, make_objective("custom"), n_levels=2,
                               top=3, max_orders=8)
    print("\ntop-3 schedules (custom hardware, energy/MAC):")
    for r in best:
        print(f"  {r.string}   {r.report.pj_per_mac:.3f} pJ/MAC")

    print("\nbest schedule energy breakdown:")
    print(best[0].report.summary())

    # ---- 3. the paper's headline: direct blocking vs GEMM lowering -----
    levels = xeon_hierarchy()
    ours = direct_blocking_accesses(p, levels)
    mkl = gemm_lowering_accesses(p, levels, "mkl").cache_counts
    print(f"\nL2 accesses: blocked={ours['L2']:.3e} "
          f"im2col+GEMM={mkl['L2']:.3e} "
          f"({mkl['L2']/ours['L2']:.1f}x more)")

    # ---- 4. the same model on the H100: CUDA kernel tiles --------------
    print("\nH100 (SXM) tiles from the same blocking model:")
    print("  4096x4096x4096 GEMM  (bm,bk,bn) =",
          matmul_tiles(4096, 4096, 4096, 2))
    print("  32k-context attention (block_q, block_kv) =",
          flash_tiles(32768, 32768, 128, 2))


if __name__ == "__main__":
    main()
