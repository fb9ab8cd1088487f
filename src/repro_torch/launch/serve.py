"""Serving launcher of the port: the paged continuous-batching engine.

    python -m repro_torch.launch.serve --arch granite-3-8b --engine paged \
        --batch 8 --requests 16 --prompt-len 300 --mixed-lens --gen 32 \
        --max-seq 512

Weights are random, drawn from ``--seed``.  ``--device cpu`` runs the
plain PyTorch versions of the kernels (use ``--reduced`` there).  The
page size and the prefill chunk come from the blocking model unless
given (``--page-size 0`` and ``--prefill-chunk -1``, the defaults).
``REPRO_BLOCKED_LINEAR=1`` runs every projection through the blocked
GEMM kernel (``kernels.ops.blocked_linear``).  ``--fuse`` runs the fused
path: one-pass QKV, epilogue-fused MLP GEMMs and oproj-fused decode, the
page sized under ``"flash_decode_oproj"``.  ``--quantize`` runs the
quantized path, as JAX's launcher does: ``w8`` int8 projection weights
(``quant.quantize_params``, the ``matmul_w8`` kernel), ``fp8kv`` an fp8
page pool (``flash_decode_fp8``, the page sized under
``"flash_decode_fp8"``), ``w8fp8`` both; it composes with ``--fuse``.
The static-batch engine is a later slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.obs import format_metrics
from repro_torch.quant import quantize_params, quantized_bytes
from repro_torch.serve.engine import PagedEngine, PagedServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("paged",), default="paged",
                    help="the static-batch engine is not ported yet")
    ap.add_argument("--batch", type=int, default=8,
                    help="decode batch slots")
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests to stream (default: batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--mixed-lens", action="store_true",
                    help="draw prompt lengths in [prompt_len/2, prompt_len]")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size, the flash-decode kernel's KV tile "
                         "(0 -> tuned via the flash_decode schedule key, "
                         "or its fused or fp8 key)")
    ap.add_argument("--prefill-chunk", type=int, default=-1,
                    help="prefill chunk in tokens (-1 -> auto-sized from "
                         "the blocking model, 0 -> whole-prompt joins)")
    ap.add_argument("--fuse", action="store_true",
                    help="cross-op fused kernels on the hot path: "
                         "epilogue-fused MLP GEMMs, one-pass QKV and "
                         "oproj-fused flash decode")
    ap.add_argument("--quantize", choices=("none", "w8", "fp8kv", "w8fp8"),
                    default="none",
                    help="w8: int8 projection weights (matmul_w8 kernel); "
                         "fp8kv: fp8 KV page pool (flash_decode_fp8 and "
                         "its page key); w8fp8: both")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    if args.quantize in ("fp8kv", "w8fp8"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    params = T.init_params(cfg, seed=args.seed, device=args.device)
    if args.quantize in ("w8", "w8fp8"):
        params = quantize_params(params)
        qb, db = quantized_bytes(params)
        print(f"quantized projection weights: {qb / 1e6:.1f} MB "
              f"(same projections at bf16: {db / 1e6:.1f} MB)")
    engine = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=args.max_seq, max_batch=args.batch,
        page_size=args.page_size or None,
        prefill_chunk=None if args.prefill_chunk < 0 else args.prefill_chunk,
        temperature=args.temperature, seed=args.seed, device=args.device,
        fuse=args.fuse))
    rng = np.random.default_rng(args.seed)
    n_req = args.requests or args.batch
    lo = max(1, args.prompt_len // 2) if args.mixed_lens else args.prompt_len
    lens = rng.integers(lo, args.prompt_len + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab, (int(n),), dtype=np.int32)
               for n in lens]
    t0 = time.perf_counter()
    reqs = engine.generate(prompts, args.gen, return_requests=True)
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    emitted = sum(len(r.output) for r in reqs)
    kv = str(cfg.kv_cache_dtype or cfg.dtype).removeprefix("torch.")
    print(f"paged engine ({args.device}): page={engine.page_size} "
          f"chunk={engine.prefill_chunk} kv={kv} slots={args.batch} "
          f"requests={n_req} blocked_linear="
          f"{ops.blocked_linear_enabled()} fused={args.fuse} "
          f"quantize={args.quantize}")
    print(format_metrics(engine.metrics.snapshot(), sections=("engine",)))
    statuses = sorted({r.status.value for r in reqs})
    print(f"generated {emitted} tokens over {n_req} requests in {dt:.2f}s "
          f"({emitted / dt:.1f} tok/s), statuses: {'/'.join(statuses)}")
    print("sample:", reqs[0].output[:16].tolist())


if __name__ == "__main__":
    main()
