#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (``nvidia-smi``); TF32 off;
2. build both CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version, fp32 and bf16;
4. engine parity at granite-3-8b width, 2 layers, fp32: the kernel path
   and the plain path give identical greedy token streams, through both
   whole-prompt joins and chunked prefill;
5. the full run: granite-3-8b at full width and depth in bf16, weights
   from ``--seed``, serving 16 requests (prompts of 16..300 tokens, 32
   new tokens each) through ``PagedEngine`` with page 64, prefill chunk
   64, max_seq 512 and 8 slots; a short torch.profiler window of the
   same engine (device busy share, device time by kernel kind); then
   each kernel timed at the shapes of that run beside its bound, its
   plain version and a library call.

The last two lines are a JSON ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no
result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
TOL = {"float32": (1e-5, 1e-4),    # summation order only
       "bfloat16": (2e-2, 1e-2)}   # one bf16 rounding of an O(1) output


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def compare(name: str, out, ref, dtype_name: str) -> float:
    """Max abs error of ``out`` vs ``ref``; raises past the tolerance."""
    import torch
    atol, rtol = TOL[dtype_name]
    out, ref = out.float(), ref.float()
    err = float((out - ref).abs().max())
    ok = bool(torch.all((out - ref).abs() <= atol + rtol * ref.abs()))
    print(f"  {name:<46} max_abs_err {err:.3e}  (tol {atol:g} abs + "
          f"{rtol:g} rel)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def paged_inputs(dev, dtype, lengths, q_span, seed, hkv=8, g=4, d=128,
                 page=64, n_blocks=8):
    """Ragged requests over a shuffled pool; block-table entries past
    each request's span point at the scratch page 0."""
    import torch
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = b * n_blocks + 1
    bt = (1 + rng.permutation(b * n_blocks)).reshape(b, n_blocks)
    for i, n in enumerate(lengths):
        bt[i, -(-(n + q_span - 1) // page):] = 0
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype,  # noqa
                                device=dev)
    return (t(b, hkv, q_span * g, d), t(n_pages, page, hkv, d),
            t(n_pages, page, hkv, d),
            torch.tensor(bt, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def dense_inputs(dev, dtype, b, sq, skv, seed, hq=32, hkv=8, d=128):
    import torch
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype,  # noqa
                                device=dev)
    return t(b, sq, hq, d), t(b, skv, hkv, d), t(b, skv, hkv, d)


def phase3_kernels(dev) -> None:
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for q_span, lengths in ((1, [1, 17, 64, 130, 300, 512]),
                                (64, [1, 17, 64, 130, 300, 470])):
            for window, cap in ((None, None), (37, 30.0)):
                args = paged_inputs(dev, dtype, lengths, q_span, seed=q_span)
                kw = dict(window=window, logit_cap=cap, q_span=q_span)
                compare(f"flash_decode {dn} q_span={q_span} window={window}"
                        f" cap={cap}", FD.flash_decode(*args, **kw),
                        FD.paged_attention_ref(*args, **kw), dn)
        for sq, skv, window, cap in ((8, 8, None, None), (16, 16, None, None),
                                     (32, 32, None, None),
                                     (64, 64, None, None),
                                     (128, 128, None, None),
                                     (256, 256, None, None),
                                     (512, 512, None, None),
                                     (24, 100, None, None),
                                     (64, 64, 16, None), (40, 40, None, 30.0)):
            q, k, v = dense_inputs(dev, dtype, 2, sq, skv, seed=sq + skv)
            kw = dict(window=window, logit_cap=cap)
            compare(f"flash_attention {dn} Sq={sq} Skv={skv} window={window}"
                    f" cap={cap}", FA.flash_attention(q, k, v, **kw),
                    FA.flash_attention_ref(q, k, v, **kw), dn)
    torch.cuda.synchronize()


def engine_for(cfg, params, **kw):
    """The main path's engine: page 64, prefill chunk 64, max_seq 512."""
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    return PagedEngine(cfg, params, PagedServeConfig(
        max_seq=512, page_size=64, prefill_chunk=64, device="cuda", **kw))


def serve(cfg, params, prompts, n_tokens, **kw):
    return engine_for(cfg, params, **kw).generate(prompts, n_tokens,
                                                  return_requests=True)


def phase4_parity(seed: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype=torch.float32)
    params = T.init_params(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in (5, 37, 64, 65, 130, 300)]    # joins and chunks
    FA.flash_attention.launches = FD.flash_decode.launches = 0
    kern = serve(cfg, params, prompts, 8, max_batch=4)
    launched = (FA.flash_attention.launches, FD.flash_decode.launches)
    plain = serve(cfg, params, prompts, 8, max_batch=4, use_kernel=False)
    assert (FA.flash_attention.launches, FD.flash_decode.launches) == \
        launched, "the plain path launched a kernel"
    assert min(launched) > 0, launched
    for a, b in zip(kern, plain):
        if not np.array_equal(a.output, b.output):
            raise AssertionError(f"request {a.rid}: kernel path "
                                 f"{a.output.tolist()} != plain path "
                                 f"{b.output.tolist()}")
    print(f"  6 requests x 8 tokens identical (kernel launches: "
          f"flash_attention {launched[0]}, flash_decode {launched[1]}); "
          f"first tokens {[int(r.output[0]) for r in kern]}")
    del params
    torch.cuda.empty_cache()


def time_ms(fn, flush, reps: int = 50) -> float:
    """Median device ms of ``fn`` over ``reps`` launches, each after a
    write of a buffer larger than L2 (the main path reads every layer's
    pools and weights between two calls, so L2 is cold).  A spin of
    about a millisecond keeps the device busy while the host enqueues
    the start event and ``fn``, so the events time device work, not the
    host's launch overhead."""
    import torch
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase5_full(seed: int) -> tuple[list[dict], dict]:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models import transformer as T

    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.param_count() * 2 / 1e9:.2f} GB of bf16 weights "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}) in "
          f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    warm = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
            for n in (20, 100)]
    serve(cfg, params, warm, 4, max_batch=8)        # cuBLAS handles etc.
    lens = rng.integers(16, 301, 16)
    prompts = [rng.integers(0, cfg.vocab, (int(n),), dtype=np.int32)
               for n in lens]

    engine = engine_for(cfg, params, max_batch=8)
    torch.cuda.synchronize()
    FA.flash_attention.launches = FD.flash_decode.launches = 0
    t0 = time.perf_counter()
    reqs = engine.generate(prompts, 32, return_requests=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.flash_attention.launches,
                "flash_decode": FD.flash_decode.launches}

    snap = engine.metrics.snapshot()["engine"]
    for r in reqs:
        assert r.status.value == "ok" and len(r.output) == 32, r.rid
        assert 0 <= r.output.min() and r.output.max() < cfg.vocab
    assert engine.scheduler.allocator.in_use() == 0, "pages leaked"
    n_layers = cfg.n_layers
    assert launches["flash_attention"] == n_layers * snap["joins"] > 0
    assert launches["flash_decode"] == n_layers * (
        snap["decode_steps"] + snap["prefill_chunks"])
    assert launches["flash_decode"] >= n_layers * snap["decode_steps"] > 0
    tokens = sum(len(r.output) for r in reqs)
    summary = {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
               "tok_per_s": tokens / wall, "joins": snap["joins"],
               "prefill_chunks": snap["prefill_chunks"],
               "decode_steps": snap["decode_steps"],
               "engine_steps": snap["steps"], "launches": launches,
               "prompt_lens": [int(n) for n in lens]}
    print(f"  {len(reqs)} requests OK, {tokens} tokens in {wall:.3f}s = "
          f"{tokens / wall:.1f} tok/s; joins {snap['joins']}, prefill "
          f"chunks {snap['prefill_chunks']}, decode steps "
          f"{snap['decode_steps']}, engine steps {snap['steps']}; "
          f"launches {launches}")

    # what comes out is right: the full-width prefill logits of one
    # prompt through the kernels agree with the plain versions
    tok = torch.from_numpy(prompts[0][None, :64].copy()).cuda()
    lk, _ = T.prefill(cfg, params, tok, max_seq=64)
    lp, _ = T.prefill(cfg, params, tok, max_seq=64, use_kernel=False)
    dev_ = float((lk.float() - lp.float()).abs().max())
    scale = float(lp.float().abs().max())
    assert torch.isfinite(lk).all() and dev_ <= 0.05 * scale, (dev_, scale)
    print(f"  full-width prefill logits, kernel vs plain: max |diff| "
          f"{dev_:.3e} of max |logit| {scale:.3e}; argmax "
          f"{'agrees' if int(lk.argmax()) == int(lp.argmax()) else 'differs'}")
    summary["profile"] = profile_window(engine_for(cfg, params, max_batch=8),
                                        prompts[:8], 8)
    del params, engine
    torch.cuda.empty_cache()
    return time_kernels(cfg, lens, launches), summary


def kernel_kind(name: str) -> str:
    if "attn_rows_kernel" in name:
        return ("flash_decode" if "PagedLayout" in name
                else "flash_attention")
    if any(w in name.lower()
           for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    if "elementwise" in name or "reduce_kernel" in name or "copy" in name:
        return "elementwise/copy/reduce"
    return "other"


def profile_window(engine, prompts, n_tokens: int) -> dict:
    """Device busy share and device time by kernel kind over a short run
    traced by torch.profiler (whose overhead inflates the host time, so
    the busy share is a lower bound of the untraced one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        engine.submit(p, n_tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        kinds[kernel_kind(e.key)] = kinds.get(kernel_kind(e.key), 0.0) + us
        top.append((us, e.count, e.key[:90]))
    busy = sum(kinds.values()) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy,
           "busy_share": busy / wall,
           "device_ms_by_kind": {k: v / 1e3 for k, v in sorted(kinds.items())}}
    print(f"  profiled window ({len(prompts)} requests x {n_tokens} tokens): "
          f"wall {wall:.3f}s, device busy {busy:.3f}s "
          f"({100 * busy / wall:.1f}%), by kind (ms) "
          f"{ {k: round(v, 3) for k, v in out['device_ms_by_kind'].items()} }")
    for us, count, name in sorted(top, reverse=True)[:8]:
        print(f"    {us / 1e3:9.3f} ms  x{count:<6} {name}")
    return out


def time_kernels(cfg, lens, launches) -> list[dict]:
    """Each kernel at the shapes of the full run, beside its plain
    version, its bound and (where one exists) one library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = []

    # decode: 8 slots, each mid-generation (prompt + 16 tokens)
    dec_lens = [int(n) + 16 for n in lens[:8]]
    args = paged_inputs(dev, bf16, dec_lens, 1, seed=5)
    k_out = FD.flash_decode(*args)
    err = float((k_out.float() - FD.paged_attention_ref(*args).float())
                .abs().max())
    n_keys = sum(dec_lens)
    kv_bytes = 2 * n_keys * hkv * d * 2
    io_bytes = 2 * args[0].numel() * 2 + args[3].numel() * 4 + 4 * 8
    b_ms, b_by = bound(kv_bytes + io_bytes, 4 * n_keys * hq * d)
    out.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:233",
        "launches": launches["flash_decode"], "max_abs_err": err,
        "ms": time_ms(lambda: FD.flash_decode(*args), flush),
        "plain_ms": time_ms(lambda: FD.paged_attention_ref(*args), flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"decode B=8 Hkv={hkv} G={hq // hkv} D={d} page=64 "
                 f"lengths={dec_lens} bf16"})

    # chunked prefill: the third 64-token chunk of a 300-token prompt
    cargs = paged_inputs(dev, bf16, [129], 64, seed=6)
    n_pairs = sum(129 + t for t in range(64))     # causal (row, key) pairs
    c_bytes = 2 * (129 + 63) * hkv * d * 2 + 2 * cargs[0].numel() * 2
    cb_ms, cb_by = bound(c_bytes, 4 * n_pairs * hq * d)
    c_ms = time_ms(lambda: FD.flash_decode(*cargs, q_span=64), flush)
    cp_ms = time_ms(lambda: FD.paged_attention_ref(*cargs, q_span=64), flush)
    print(f"  flash_decode chunk (q_span=64, cache 129..192): {c_ms:.4f} ms, "
          f"plain {cp_ms:.4f} ms, bound {cb_ms:.4f} ms ({cb_by})")

    # join: one prompt in the 64 bucket
    q, k, v = dense_inputs(dev, bf16, 1, 64, 64, seed=7, hq=hq, hkv=hkv, d=d)
    fa_out = FA.flash_attention(q, k, v)
    err = float((fa_out.float() - FA.flash_attention_ref(q, k, v).float())
                .abs().max())
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - fa_out.float())
                    .abs().max())
    fa_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    fb_ms, fb_by = bound(fa_bytes, 4 * (64 * 65 // 2) * hq * d)
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:234",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": time_ms(lambda: FA.flash_attention(q, k, v), flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_ref(q, k, v), flush),
        "bound_ms": fb_ms, "bound_by": fb_by,
        "library_ms": time_ms(lib, flush),
        "shape": f"join B=1 Sq=Skv=64 Hq={hq} Hkv={hkv} D={d} causal bf16"})
    print(f"  scaled_dot_product_attention vs flash_attention: max |diff| "
          f"{lib_err:.3e}")
    for r in out:
        print(f"  {r['name']:<16} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"library {r['library_ms']}  [{r['shape']}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print("phase 1: card")
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    print("phase 2: build")
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"  built {sorted(reports) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("phase 3: kernels vs plain versions")
    phase3_kernels(torch.device("cuda"))
    print("phase 4: engine parity, granite-3-8b width, 2 layers, fp32")
    phase4_parity(args.seed)
    print("phase 5: granite-3-8b, full width and depth, bf16")
    kernels, summary = phase5_full(args.seed)
    print("serve " + json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
