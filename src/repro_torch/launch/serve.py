"""Serving launcher of the port: paged continuous batching or the static
batch.

    # paged continuous batching (the port's default engine)
    python -m repro_torch.launch.serve --arch granite-3-8b --engine paged \
        --batch 8 --requests 16 --prompt-len 300 --mixed-lens --gen 32 \
        --max-seq 512

    # the static batch: one prefill of --batch prompts of --prompt-len
    # tokens, then --gen lock-step decode steps over the dense caches
    python -m repro_torch.launch.serve --arch gemma2-9b --engine static \
        --batch 4 --prompt-len 16 --gen 32

``--arch`` takes every arch of ``repro_torch.configs``.  The
encoder-decoder (seamless-m4t-medium) and vision-prefix (phi-3-vision)
families serve through the static engine only, as in JAX (the paged
engine covers decoder-only token models), so ``--engine`` defaults to
``static`` for them and to ``paged`` for the rest; their frontend stubs'
inputs (``enc_embeds``, ``prefix_embeds``: normal draws times 0.1 in the
model dtype) are drawn after the prompts, as JAX's launcher draws them.
Stacks with RG-LRU or SSD mixers serve through both engines; the paged
one prefills them at exact lengths and turns chunked prefill,
speculative decode and the prefix cache off, as JAX's does.

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
Both compose with ``--engine static`` too (its fp8 cache is the dense
one).  JAX's launcher defaults to the static engine; this one to the
paged engine.  ``--metrics-out PATH`` writes the metrics snapshot (the
registry and the modeled-vs-resolved DRAM report) as JSON, ``--trace
PATH`` a Chrome-trace timeline of every engine step (it fences the
device after each dispatch, so a traced run is not for throughput
numbers) and ``--miss-log PATH`` the schedule-cache misses as JSONL
tuning targets for ``python -m repro_torch.tune --from-telemetry``, as
JAX's launcher does.

The paged engine's serving features take JAX's flags: ``--spec K``
(n-gram speculative decode, K drafts a verify step, greedy only),
``--prefix-cache`` (radix-tree prefix sharing; ``--reuse-hint`` prices
the page), ``--deadline S`` (a wall deadline a request), ``--preempt``
(preempt-with-restore under page pressure, greedy only),
``--nan-guard`` (a poisoned request fails alone) and ``--degrade`` (the
degradation ladder); their counters print as the ``spec``,
``prefix_cache`` and ``lifecycle`` sections.  Ctrl-C during a paged run
cancels every request, drains the engine to terminal statuses and
reports the page pool drained.

    # the paged engine with speculative decode and the prefix cache
    python -m repro_torch.launch.serve --arch granite-3-8b --reduced \
        --device cpu --dtype float32 --spec 2 --prefix-cache --nan-guard
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
from repro_torch.obs import Obs, format_metrics
from repro_torch.quant import quantize_params, quantized_bytes
from repro_torch.serve.engine import (DecodeEngine, PagedEngine,
                                      PagedServeConfig, ServeConfig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("static", "paged"),
                    default=None,
                    help="paged: continuous batching over the paged cache; "
                         "static: one batch, dense caches, lock-step decode "
                         "(default: paged, static for the encoder-decoder "
                         "and vision-prefix families)")
    ap.add_argument("--batch", type=int, default=8,
                    help="paged: decode batch slots; static: batch size")
    ap.add_argument("--requests", type=int, default=0,
                    help="paged: total requests to stream (default: batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--mixed-lens", action="store_true",
                    help="paged: draw prompt lengths in [prompt_len/2, "
                         "prompt_len]")
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
    ap.add_argument("--spec", type=int, default=0,
                    help="paged: draft tokens per speculative draft-verify "
                         "decode step (0 -> off; greedy only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged: radix-tree prefix sharing -- repeated "
                         "prompt prefixes reuse cached KV pages (copy on "
                         "write)")
    ap.add_argument("--reuse-hint", type=float, default=0.5,
                    help="expected prompt-reuse rate for the "
                         "share-against-stream page-size pricing (only "
                         "with --prefix-cache)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="paged: per-request wall deadline in seconds; "
                         "requests past it finish DEADLINE_EXCEEDED with "
                         "whatever they emitted")
    ap.add_argument("--preempt", action="store_true",
                    help="paged: allow preempt-with-restore when the "
                         "waiting head starves (greedy only; restored "
                         "requests replay only their unshared tail with "
                         "--prefix-cache)")
    ap.add_argument("--nan-guard", action="store_true",
                    help="paged: per-slot NaN/Inf logit guard -- a "
                         "poisoned request FAILs alone instead of wedging "
                         "the batch")
    ap.add_argument("--degrade", action="store_true",
                    help="paged: graceful-degradation ladder driven by the "
                         "metrics registry (no_spec -> small_chunk -> "
                         "preempt)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the metrics snapshot (registry + "
                         "modeled-vs-resolved DRAM report) as JSON")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace (chrome://tracing / "
                         "Perfetto) span timeline of every engine step; "
                         "fences the device after each dispatch, so "
                         "traced runs are NOT for throughput numbers")
    ap.add_argument("--miss-log", metavar="PATH", default=None,
                    help="append schedule-cache misses as JSONL tuning "
                         "targets for python -m repro_torch.tune "
                         "--from-telemetry")
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
    rng = np.random.default_rng(args.seed)
    kv = str(cfg.kv_cache_dtype or cfg.dtype).removeprefix("torch.")
    # closed on any exit, so a crash or Ctrl-C keeps the trace so far
    with Obs(trace=args.trace, miss_log=args.miss_log) as obs:
        _serve(args, cfg, params, rng, kv, obs)


def _serve(args, cfg, params, rng, kv: str, obs: Obs) -> None:
    """Run the chosen engine over random prompts and print its report."""
    engine_kind = args.engine or ("static" if cfg.is_encdec
                                  or cfg.prefix_tokens else "paged")
    if engine_kind == "static":
        engine = DecodeEngine(cfg, params, ServeConfig(
            max_seq=args.max_seq, temperature=args.temperature,
            seed=args.seed, fuse=args.fuse, device=args.device), obs=obs)
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                               dtype=np.int32)
        extras = {}
        for key, n in (("enc_embeds",
                        cfg.encoder_seq if cfg.is_encdec else 0),
                       ("prefix_embeds", cfg.prefix_tokens)):
            if n:
                extras[key] = rng.standard_normal(
                    (args.batch, n, cfg.d_model)).astype(np.float32) * 0.1
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.gen, **extras)
        dt = time.perf_counter() - t0
        print(f"static engine ({args.device}): arch={cfg.name} "
              f"batch={args.batch} prompt={args.prompt_len} "
              f"max_seq={args.max_seq} kv={kv} "
              f"blocked_linear={ops.blocked_linear_enabled()} "
              f"fused={args.fuse} quantize={args.quantize}")
        print(format_metrics(engine.metrics.snapshot(), sections=("engine",)))
        print(f"generated {out.shape} in {dt:.2f}s "
              f"({out.size / dt:.1f} tok/s)")
        print("sample:", out[0, :16].tolist())
        finish_obs(obs, args)
        return
    engine = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=args.max_seq, max_batch=args.batch,
        page_size=args.page_size or None,
        prefill_chunk=None if args.prefill_chunk < 0 else args.prefill_chunk,
        temperature=args.temperature, seed=args.seed, device=args.device,
        fuse=args.fuse, spec_decode=args.spec,
        prefix_cache=args.prefix_cache, reuse_hint=args.reuse_hint,
        preempt=args.preempt, nan_guard=args.nan_guard,
        degrade=args.degrade), obs=obs)
    n_req = args.requests or args.batch
    lo = max(1, args.prompt_len // 2) if args.mixed_lens else args.prompt_len
    lens = rng.integers(lo, args.prompt_len + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab, (int(n),), dtype=np.int32)
               for n in lens]
    t0 = time.perf_counter()
    try:
        reqs = engine.generate(prompts, args.gen,
                               deadline_s=args.deadline or None,
                               return_requests=True)
    except KeyboardInterrupt:
        # Ctrl-C mid-generate: cancel everything, drain to terminal
        # statuses (freeing every page), and still report what ran
        print("\ninterrupted: draining in-flight requests ...")
        engine.shutdown()
        held = engine.scheduler.allocator.in_use()
        print(format_metrics({"lifecycle": engine.lifecycle_stats()}))
        print(f"page pool drained ({held} pages still held)")
        finish_obs(obs, args)
        return
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    emitted = sum(r.emitted_total for r in reqs)
    print(f"paged engine ({args.device}): arch={cfg.name} "
          f"page={engine.page_size} "
          f"chunk={engine.prefill_chunk} kv={kv} slots={args.batch} "
          f"requests={n_req} blocked_linear="
          f"{ops.blocked_linear_enabled()} fused={args.fuse} "
          f"quantize={args.quantize} spec={engine.spec} ")
    print(format_metrics(engine.metrics.snapshot(), sections=("engine",)))
    sections = {}
    if engine.spec:
        sections["spec"] = engine.spec_stats()
    if engine.prefix_caching:
        sections["prefix_cache"] = engine.prefix_stats()
    if args.deadline or args.preempt or args.nan_guard or args.degrade:
        sections["lifecycle"] = engine.lifecycle_stats()
    if sections:
        print(format_metrics(sections))
    statuses = sorted({r.status.value for r in reqs})
    print(f"generated {emitted} tokens over {n_req} requests in {dt:.2f}s "
          f"({emitted / dt:.1f} tok/s), statuses: {'/'.join(statuses)}")
    print("sample:", reqs[0].output[:16].tolist())
    finish_obs(obs, args)


def finish_obs(obs: Obs, args) -> None:
    """Shared tail: the metrics snapshot and the DRAM bytes per op key
    (``--metrics-out``), and where the trace and the miss log went."""
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
        dram = obs.snapshot()["dram"]
        lines = format_metrics({"dram": {
            k: {kk: v[kk] for kk in ("modeled_bytes", "used_bytes", "ratio")
                if v[kk] is not None}
            for k, v in dram["per_op"].items()}})
        if lines:
            print("modeled-vs-resolved DRAM bytes per op key:")
            print(lines)
    if args.trace:
        print(f"chrome trace -> {args.trace}")
    if args.miss_log:
        print(f"schedule-cache miss log -> {args.miss_log} (replay: "
              "python -m repro_torch.tune --from-telemetry)")


if __name__ == "__main__":
    main()
