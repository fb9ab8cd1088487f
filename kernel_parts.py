#!/usr/bin/env python3
"""Where the paged decode kernels' time goes, on one GPU.

    python3 kernel_parts.py [decode] [oproj] [--page P] [--reps N]

Each target builds copies of its kernel's source with parts cut out (one
``nvcc`` each, all at once, under ``build/kernel_parts/``), calls each
through the wrapper's C interface at ``chip_smoke.py``'s phase-8 decode
shape (granite-3-8b, 8 slots, lengths from phase 5's prompts), and
prints each copy's median ms (``chip_smoke.time_ms``: L2 flushed, 50
launches), the copies in turns ``--reps`` times, forward and back.  The
parts' times are differences of these.  Only the full copy is held
against the plain version; the cut-down copies compute nothing useful.
Then it times the target's grid choices through the library the wrapper
loads.  Imports nothing of JAX.

* ``decode``: rows 1 and 2's split core (``csrc/decode_mma.cuh``, built
  through copies of ``flash_decode.cu`` and ``flash_decode_fp8.cu``), row
  1 at ``--page`` and row 2 at the fp8 page 64: the launch and the
  block and cluster barriers, the prologue (lengths, page table, q
  tile), the runs' pages (the ring's copies), the tensor-core steps,
  and the warps' and cluster's merge loops; then the full copies (and
  one held to 3 blocks an SM, and one whose last cluster arrive is
  relaxed) at every split count from 1 to 8; then the wrapper's grid
  choice on the host, computed and cached.
* ``oproj``: row 3 (``csrc/flash_decode_oproj.cu``): the attention, the
  cluster's gather, the ``wo`` slab (its stream and its fp32
  multiply-adds), the head sum; then the cluster (16, 8) and the slice
  width (256, 128).
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

# target -> (the file the cuts edit, the sources built through it, part
# -> (text in the file, its replacement) pairs, copy -> the parts it
# cuts); a copy may cut several parts
OPROJ_CUTS = {
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
DECODE_CUTS = {
    "pages": [("const int n_steps = (run.end - run.first + spages - 1) / "
               "spages;", "const int n_steps = 0;")],
    "steps": [("for (int ch = warp; ch * kChunk < n_keys; ch += kWarps) {",
               "for (int ch = warp; ch * kChunk < 0 * n_keys; "
               "ch += kWarps) {")],
    # the block's and the cluster's merge loops (their barriers stay)
    "merge": [("for (int i = tid; i < nr * hd; i += kThreads) {",
               "for (int i = tid; i < 0 * nr * hd; i += kThreads) {"),
              ("for (int i = sp * kThreads + tid; i < nr * hd;",
               "for (int i = sp * kThreads + tid; i < 0 * nr * hd;")],
    # the prologue's loads: the q tile, the page table, the length
    "prologue": [("for (int i = tid; i < kRows * (D / 8); i += kThreads) {",
                  "for (int i = tid; i < 0 * kRows; i += kThreads) {"),
                 ("for (int i = tid; i < kTable; i += kThreads)\n    table",
                  "for (int i = tid; i < 0 * kTable; i += kThreads)\n"
                  "    table"),
                 ("const int len = a.lengths[b];", "const int len = 1;")],
    # not a cut: at most 168 registers a thread, so 3 blocks share an SM
    "occupancy": [("__launch_bounds__(kThreads)\ndecode_mma_kernel",
                   "__launch_bounds__(kThreads, 3)\ndecode_mma_kernel")],
    # not a cut: the last cluster barrier's arrive relaxed, so it does not
    # order the block's remote loads before the block exits (unsafe: for
    # timing the release arrive against it only)
    "relaxed": [("  if (n_split > 1) cluster.sync();\n}",
                 "  if (n_split > 1) {\n    asm volatile(\"barrier.cluster."
                 "arrive.relaxed.aligned;\\n\" ::: \"memory\");\n"
                 "    asm volatile(\"barrier.cluster.wait.aligned;\\n\" "
                 "::: \"memory\");\n  }\n}")],
    "all": [("  constexpr bool kFp8 = sizeof(TK) == 1;\n",
             "  if (a.hd > 0) return;\n  constexpr bool kFp8 = "
             "sizeof(TK) == 1;\n")],
}
TARGETS = {
    "oproj": ("flash_decode_oproj.cu", ("flash_decode_oproj.cu",),
              OPROJ_CUTS, {
                  "full": (),
                  "no multiply-adds": ("fma",),
                  "attention and gather only": ("slab", "sum"),
                  "slab and gather only": ("attention", "sum"),
                  "launch, syncs, gather": ("attention", "slab", "sum"),
                  "launch, syncs": ("attention", "slab", "sum", "gather"),
                  "launch": ("all",),
              }),
    "decode": ("decode_mma.cuh", ("flash_decode.cu", "flash_decode_fp8.cu"),
               DECODE_CUTS, {
                   "full": (),
                   "full, 3 blocks an SM": ("occupancy",),
                   "full, relaxed last arrive": ("relaxed",),
                   "no merge": ("merge",),
                   "pages, no steps, no merge": ("steps", "merge"),
                   "prologue and merge": ("pages",),
                   "prologue, syncs": ("pages", "merge"),
                   "launch, syncs": ("pages", "merge", "prologue"),
                   "launch": ("all",),
               }),
}
SKIP = ("template <class... A> __device__ __forceinline__ void "
        "skip_rows(A&&...) {}\n")


def build(target: str, name: str, cuts: tuple[str, ...]):
    """Compile a copy of the target's sources with ``cuts`` applied in
    its edited file; the copy's C entries by source."""
    from repro_torch.kernels import _build
    edited, sources, table, _ = TARGETS[target]
    src = (_build.CSRC / edited).read_text()
    for cut in cuts:
        for old, new in table[cut]:
            if old not in src:
                raise RuntimeError(f"{edited} no longer holds {old!r}")
            src = src.replace(old, new)
    if target == "oproj":
        src = src.replace("namespace {\n", "namespace {\n" + SKIP, 1)
    out = (ROOT / "build" / "kernel_parts" / target
           / name.replace(" ", "_").replace(",", ""))
    out.mkdir(parents=True, exist_ok=True)
    (out / edited).write_text(src)   # found before csrc's own copy
    fns = {}
    for cu in sources:
        if cu != edited:
            (out / cu).write_text((_build.CSRC / cu).read_text())
        so = out / f"lib{Path(cu).stem}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                              str(_build.CSRC), "-o", str(so),
                              str(out / cu)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({cu}):\n"
                               f"{res.stdout}{res.stderr}")
        fns[Path(cu).stem] = ctypes.CDLL(str(so))
    return name, fns


def in_turns(calls: dict, reps: int) -> dict[str, list[float]]:
    """Each copy's call timed ``reps`` times, the copies in turns, forward
    then back."""
    import chip_smoke as C
    ms: dict[str, list[float]] = {}
    order = list(calls)
    for rep in range(reps):
        for name in order if rep % 2 == 0 else order[::-1]:
            ms.setdefault(name, []).append(C.time_ms(calls[name]))
    return ms


def decode_call(libs, row: str, a, out, splits: int):
    """A call of a copy's row-1 or row-2 C entry on inputs ``a`` (the
    wrapper's arguments) into ``out``, bf16 q rows, at ``splits``."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    entry = getattr(libs[row], f"{row}_fwd")
    entry.argtypes = FD._ARGTYPES if row == "flash_decode" \
        else FD._FP8_ARGTYPES
    entry.restype = ctypes.c_int
    q, kp, bt = a[0], a[1], a[-2]
    b, hkv, gtot, d = q.shape
    ptrs = [t.data_ptr() for t in a]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = entry(1, d, *ptrs, out.data_ptr(), b, hkv, gtot, 1,
                    kp.shape[1], bt.shape[1], 0, 0.0, splits, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return call


def decode_target(fns: dict, args, reps: int) -> None:
    """Rows 1 and 2's copies at phase 8's decode shapes, at the grid's
    split count; then the full copies at every split count from 1 to
    8."""
    import chip_smoke as C
    import torch
    from repro_torch.kernels import flash_decode as FD
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    page, fp8_page = args.page, 64
    lens = phase5_lens(args.seed)
    a1 = C.paged_inputs(dev, bf16, lens, 1, seed=5, page=page,
                        n_blocks=-(-512 // page))
    a2 = C.fp8_paged(C.paged_inputs(dev, torch.float32, lens, 1, seed=9,
                                    page=fp8_page,
                                    n_blocks=-(-512 // fp8_page)), seed=9)
    a2 = (a2[0].to(bf16),) + a2[1:]
    rows = {}
    for row, a, ref in (("flash_decode", a1, FD.paged_attention_ref(*a1)),
                        ("flash_decode_fp8", a2,
                         FD.paged_attention_fp8_ref(*a2))):
        q, kp = a[0], a[1]
        b, hkv, gtot, d = q.shape
        grid = FD.decode_grid(b, hkv, gtot, kp.shape[1], a[-2].shape[1], d,
                              kp.element_size())
        print(f"{row}: decode B={b} Hkv={hkv} G={gtot} D={d} page="
              f"{kp.shape[1]} lengths={lens}; grid (splits, cluster, "
              f"blocks) {grid}", flush=True)
        calls = {}
        for name, libs in fns.items():
            out = torch.zeros_like(q)
            call = decode_call(libs, row, a, out, grid[0])
            try:
                call()
            except RuntimeError as e:
                if name == "full":
                    raise
                print(f"  {row} {name}: not timed ({e})", flush=True)
                continue
            torch.cuda.synchronize()
            if name.startswith("full"):
                C.compare(f"{row} ({name})", out, ref, "bfloat16")
            calls[name] = call
        rows[row] = in_turns(calls, reps)
        # the full copies at every split count, in turns
        sweep = {}
        for name, libs in fns.items():
            if not name.startswith("full"):
                continue
            for sp in range(1, 9):
                out = torch.zeros_like(q)
                call = decode_call(libs, row, a, out, sp)
                call()
                torch.cuda.synchronize()
                C.compare(f"{row} ({name}) splits={sp}", out, ref,
                          "bfloat16", quiet=True)
                sweep[f"{name}; splits {sp}"] = call
        rows[row].update(in_turns(sweep, reps))
    for row, ms in rows.items():
        for name, t in ms.items():
            print(f"  {row:<17} {name:<34} "
                  f"{' '.join(f'{x:.4f}' for x in t)} ms")
    # the wrapper's grid choice on the host, once a launch: as computed,
    # and as the wrapper finds it (cached by shape)
    q, kp = a1[0], a1[1]
    shape = (*q.shape[:3], kp.shape[1], a1[-2].shape[1], q.shape[3], 2)
    for name, fn in (("computed", FD.decode_grid.__wrapped__),
                     ("cached", FD.decode_grid)):
        n, t0 = 100_000, time.perf_counter()
        for _ in range(n):
            fn(*shape)
        print(f"  decode_grid on the host, {name}: "
              f"{(time.perf_counter() - t0) / n * 1e6:.3f} us a call")


def oproj_target(fns: dict, args, reps: int) -> None:
    """Row 3's copies at phase 8's decode shape, then its grid choices:
    the cluster (16, 8) and the slice width (256, 128), the wrapper's
    constants set for the call."""
    import chip_smoke as C
    import torch
    from repro_torch.kernels import flash_decode as FD
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    dec_lens = phase5_lens(args.seed)
    q, kp, vp, bt, ln, wo = C.oproj_inputs(dev, bf16, dec_lens, seed=8,
                                           page=args.page)
    b, hkv, g, d = q.shape
    e = wo.shape[2]
    chunks = FD.oproj_chunks(g, d, b)
    width, n_slices, cluster = FD.oproj_grid(hkv, e, chunks)
    ref = FD.paged_attention_oproj_ref(q, kp, vp, bt, ln, wo)
    print(f"flash_decode_oproj: decode B={b} Hkv={hkv} G={g} D={d} E={e} "
          f"page={args.page} lengths={dec_lens}; {n_slices} slices of "
          f"{width} x {hkv} heads, cluster {cluster}", flush=True)
    calls = {}
    for name, libs in fns.items():
        entry = libs["flash_decode_oproj"].flash_decode_oproj_fwd
        entry.argtypes = FD._OPROJ_ARGTYPES
        entry.restype = ctypes.c_int
        counters = torch.zeros(n_slices, dtype=torch.int32, device=dev)
        ws = torch.empty((hkv * chunks, b, e), dtype=torch.float32,
                         device=dev)
        out = torch.zeros((b, e), dtype=bf16, device=dev)

        def call(entry=entry, counters=counters, ws=ws, out=out,
                 name=name):
            err = entry(1, d, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        bt.data_ptr(), ln.data_ptr(), wo.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                        b, hkv, g, args.page, bt.shape[1], e, width,
                        cluster, FD.oproj_head_chunk(g, d, b), 0, 0.0,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        if name == "full":
            C.compare("flash_decode_oproj (this copy)", out, ref,
                      "bfloat16", C.gemm_atol("bfloat16", 4096))
        calls[name] = call
    for name, t in in_turns(calls, reps).items():
        print(f"  {name:<28} {' '.join(f'{x:.4f}' for x in t)} ms")
    choices = [(16, FD.OPROJ_BLOCKS), (8, FD.OPROJ_BLOCKS),
               (16, 2 * FD.OPROJ_BLOCKS)]
    saved = FD.MAX_CLUSTER, FD.OPROJ_BLOCKS
    grid_ms: dict[tuple, list[float]] = {}
    try:
        for rep in range(reps):
            for mc, blocks in choices if rep % 2 == 0 else choices[::-1]:
                FD.MAX_CLUSTER, FD.OPROJ_BLOCKS = mc, blocks
                grid = FD.oproj_grid(hkv, e, chunks)
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


def phase5_lens(seed: int) -> list[int]:
    """Phase 8's decode lengths: the first 8 of phase 5's prompt lengths
    (``chip_smoke.full_model``'s draws from ``seed``) plus 16 tokens."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-8b")
    rng = np.random.default_rng(seed)
    for n in (20, 100):
        rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
    return [int(n) + 16 for n in rng.integers(16, 301, 16)[:8]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("targets", nargs="*", choices=sorted(TARGETS),
                    default=["decode", "oproj"])
    ap.add_argument("--page", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_parts.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    print(C.card_line(), flush=True)
    jobs = [(t, name, cuts) for t in args.targets
            for name, cuts in TARGETS[t][3].items()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: (j[0], *build(*j)), jobs))
    print(f"built {len(built)} copies in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for target in args.targets:
        fns = {name: libs for t, name, libs in built if t == target}
        (decode_target if target == "decode" else oproj_target)(
            fns, args, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
