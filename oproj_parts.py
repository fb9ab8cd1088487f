#!/usr/bin/env python3
"""Where kernel row 3's time goes, on one GPU.

    python3 oproj_parts.py [--page P] [--reps N]

``flash_decode_oproj`` (``src/repro_torch/csrc/flash_decode_oproj.cu``)
runs three parts one after the other in every block: the attention of
its batch rows (or row runs), the cluster's gather of the rows, and the
``wo`` slab (a ``cp.async`` stream and fp32 multiply-adds), then the
last block of each slice sums the heads.  This script builds copies of
the source with parts cut out (one ``nvcc`` each, all at once, under
``build/oproj_parts/``), calls each through the wrapper's C interface
at ``chip_smoke.py``'s phase-8 decode shape (granite-3-8b, 8 slots,
lengths from phase 5's prompts), and prints each copy's median ms
(``chip_smoke.time_ms``: L2 flushed, 50 launches), the copies in turns
``--reps`` times, forward and back.  The parts' times are differences
of these.  It then times the grid's choices through the real library:
the cluster (16, 8) and the slice width (256, 128), the wrapper's
constants set for the call.  The cut-down copies compute nothing
useful; only the full copy is held against the plain version.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# part -> (text in the source, its replacement) pairs that cut it out;
# a copy may cut several parts
CUTS = {
    "attention": [("attn::attn_rows<T, D>(", "skip_rows(")],
    "slab": [("const int steps = (n_rows + KR - 1) / KR;",
              "const int steps = 0;")],
    "fma": [("for (int r = 0; r < kr; ++r) {",
             "for (int r = 0; r < 0 * kr; ++r) {")],
    # both gathers: the merge of one row's runs and the copy of whole rows
    "gather": [("    if (one) {\n", "    if (one && e_dim < 0) {\n"),
               ("const int n = n_rows * RB;", "const int n = 0;")],
    "sum": [("if (__syncthreads_or(last)) {",
             "if (__syncthreads_or(last) && e_dim < 0) {")],
    "all": [("  if constexpr (kExact) mk.hd = D;",
             "  if (e_dim > 0) return;\n  if constexpr (kExact) mk.hd = D;")],
}
# copy -> the parts it cuts
COPIES = {
    "full": (),
    "no multiply-adds": ("fma",),
    "attention and gather only": ("slab", "sum"),
    "slab and gather only": ("attention", "sum"),
    "launch, syncs, gather": ("attention", "slab", "sum"),
    "launch, syncs": ("attention", "slab", "sum", "gather"),
    "launch": ("all",),
}
SKIP = ("template <class... A> __device__ __forceinline__ void "
        "skip_rows(A&&...) {}\n")


def build(name: str, cuts: tuple[str, ...]):
    """Compile a copy of the kernel with ``cuts`` applied; its C entry."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as FD
    src = (_build.CSRC / "flash_decode_oproj.cu").read_text()
    for cut in cuts:
        for old, new in CUTS[cut]:
            if old not in src:
                raise RuntimeError(f"the source no longer holds {old!r}")
            src = src.replace(old, new)
    src = src.replace("namespace {\n", "namespace {\n" + SKIP, 1)
    out = ROOT / "build" / "oproj_parts"
    out.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_").replace(",", "")
    cu, so = out / f"{tag}.cu", out / f"lib{tag}.so"
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(so)).flash_decode_oproj_fwd
    fn.argtypes = FD._OPROJ_ARGTYPES
    fn.restype = ctypes.c_int
    return name, fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--page", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("oproj_parts.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    print(C.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(COPIES)) as pool:
        fns = dict(pool.map(lambda kv: build(*kv), COPIES.items()))
    print(f"built {len(fns)} copies in {time.perf_counter() - t0:.1f}s",
          flush=True)

    cfg = get_config("granite-3-8b")
    rng = np.random.default_rng(args.seed)   # chip_smoke.full_model's draws
    for n in (20, 100):
        rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
    lens = rng.integers(16, 301, 16)
    dec_lens = [int(n) + 16 for n in lens[:8]]
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    q, kp, vp, bt, ln, wo = C.oproj_inputs(dev, bf16, dec_lens, seed=8,
                                           page=args.page)
    b, hkv, g, d = q.shape
    e = wo.shape[2]
    width, n_slices, cluster = FD.oproj_grid(hkv, e)
    ref = FD.paged_attention_oproj_ref(q, kp, vp, bt, ln, wo)
    print(f"decode B={b} Hkv={hkv} G={g} D={d} E={e} page={args.page} "
          f"lengths={dec_lens}; {n_slices} slices of {width} x {hkv} heads, "
          f"cluster {cluster}")

    ms: dict[str, list[float]] = {}
    order = list(fns)
    for rep in range(args.reps):
        for name in order if rep % 2 == 0 else order[::-1]:
            counters = torch.zeros(n_slices, dtype=torch.int32, device=dev)
            ws = torch.empty((hkv, b, e), dtype=torch.float32, device=dev)
            out = torch.zeros((b, e), dtype=bf16, device=dev)
            fn = fns[name]

            def call():
                err = fn(1, d, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         bt.data_ptr(), ln.data_ptr(), wo.data_ptr(),
                         out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                         b, hkv, g, args.page, bt.shape[1], e, width,
                         cluster, 0, 0.0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "full":
                C.compare("flash_decode_oproj (this copy)", out, ref,
                          "bfloat16", C.gemm_atol("bfloat16", 4096))
            ms.setdefault(name, []).append(C.time_ms(call))
    for name, t in ms.items():
        print(f"  {name:<28} {' '.join(f'{x:.4f}' for x in t)} ms")

    # the grid's choices, through the library the wrapper loads
    choices = [(16, FD.OPROJ_BLOCKS), (8, FD.OPROJ_BLOCKS),
               (16, 2 * FD.OPROJ_BLOCKS)]
    saved = FD.MAX_CLUSTER, FD.OPROJ_BLOCKS
    grid_ms: dict[tuple, list[float]] = {}
    try:
        for rep in range(args.reps):
            for mc, blocks in choices if rep % 2 == 0 else choices[::-1]:
                FD.MAX_CLUSTER, FD.OPROJ_BLOCKS = mc, blocks
                grid = FD.oproj_grid(hkv, e)
                C.compare(f"flash_decode_oproj grid {grid}",
                          FD.flash_decode_oproj(q, kp, vp, bt, ln, wo), ref,
                          "bfloat16", C.gemm_atol("bfloat16", 4096))
                grid_ms.setdefault(grid, []).append(C.time_ms(
                    lambda: FD.flash_decode_oproj(q, kp, vp, bt, ln, wo)))
    finally:
        FD.MAX_CLUSTER, FD.OPROJ_BLOCKS = saved
    for (w, n, c), t in grid_ms.items():
        print(f"  grid: {n} slices of {w} x {hkv} heads, cluster {c}: "
              f"{' '.join(f'{x:.4f}' for x in t)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
