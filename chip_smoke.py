#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (``nvidia-smi``), its opt-in shared
   memory per block beside the Hopper target's constant; TF32 off;
2. build the sixteen CUDA libraries from ``src/repro_torch/csrc`` with
   ``nvcc``, all at once;
3. each kernel against its plain PyTorch version, fp32 and bf16:
   attention cases, ``flash_decode`` at pages 16, 32, 64, 128 (or the
   largest that fits: 111 keys in fp32) and the model's page,
   ``matmul_blocked`` at ragged shapes and under every tile the Hopper
   adapter emits for granite's projection shapes at M = 1, 8, 16, 17,
   64, 512 (bf16: the transposed ``mma_t`` instance up to 16 rows,
   ``mma`` above), repeats bit-equal; ``matmul_fused`` under
   every epilogue combination, at ragged shapes and under every adapter
   tile of granite's gate, up and down projections at M = 8, 64, 512;
   ``qkv_fused`` under every adapter tile at M = 1, 8, 16 (bf16: the
   transposed ``mma_t`` instance) and 24, 37, 64, 512 (``mma``), at
   ragged Nkv and K, G = 1 and the reduced granite's (Nkv 32, G 2, K 64),
   repeats bit-equal; and
   ``flash_decode_oproj`` at pages 16, 32, 64 and the fused engine's
   page and at 20 batch rows, window and logit cap on and off, repeats
   bit-equal, its slice counters left zero; the quantized kernels:
   ``matmul_w8`` under every adapter tile of granite's projections at
   M = 1, 8, 16, 24, 64, 512 (and a per-tensor scale, ragged M, N and K),
   repeats bit-equal, bf16 on ``mma_t`` / ``mma``, the int8
   ``matmul_fused`` under every epilogue combination and granite's MLP,
   ``flash_decode_fp8`` at pages 16, 32, 64 and the model's fp8 page,
   q_span 1 and 64, window, cap and unit or drawn scales; the training
   kernels: ``matmul_dgrad_a``/``_b`` at ragged shapes and under every
   ``"matmul_dgrad"`` adapter tile of granite's projections at 2048
   tokens (bf16 on the tensor-core ``mma`` instance, at 2 and 3
   stages; fp32 on the CUDA-core one), the forward's lse and
   ``flash_attention_bwd`` (GQA 32/8,
   D = 128 and 64; ragged S, Sq < Skv, window, cap), repeats bit-equal;
   rows 4 and 5 at the tensor-core instances' edges (Sq, Skv of 16k +- 1,
   Sq < Skv and Sq > Skv, a window across tiles, a cap, D 64, G 1 and 8,
   non-causal, the join), in bf16 on the ``mma`` instance at
   ``flash_tiles``' tiles, in fp32 on the CUDA-core one;
   the conv kernels: ``conv2d_block`` (row 12) and
   ``conv2d_wgrad_block`` (row 13) at ragged C, K and spatial tiles,
   strides 1, 2, 4, 1 x 1, 3 x 3 and 11 x 11 filters, C = 3, the
   branches of both tensor-core instances, and under every tile the
   adapter emits for the Table-4 layers and AlexNet conv1 under the
   three conv keys, repeats bit-equal, every bf16 wgrad on its ``mma``
   instance;
4. engine parity at granite-3-8b width, 2 layers, fp32, unfused and
   fused, with wide weights and under w8fp8 (int8 projections, fp8
   pages): the kernel path and the plain path give identical greedy
   token streams, through both whole-prompt joins and chunked prefill,
   and the plain path launches nothing;
5. the full run on the cuBLAS path: granite-3-8b at full width and depth
   in bf16, weights from ``--seed``, serving 16 requests (prompts of
   16..300 tokens, 32 new tokens each) through ``PagedEngine`` with page
   64, prefill chunk 64, max_seq 512 and 8 slots, and a short
   torch.profiler window of the same engine;
6. the blocked path: the same model and requests with the page size and
   prefill chunk left to the blocking model and every projection through
   ``matmul_blocked`` (``ops.blocked_linear``), with its own profiler
   window (every bf16 launch of it on the tensor-core instances) and
   the prefill logits held against the cuBLAS path;
6b. the fused path: phase 6 with ``fuse=True`` (``qkv_fused``,
   ``matmul_fused`` and ``flash_decode_oproj``; the page under the fused
   key), with the same checks and its own profiler window;
9. the quantized path (run after 6b, while the bf16 model is in memory):
   ``quantize_params`` on the card, an fp8 page pool, the model's page
   and chunk, every projection through ``matmul_w8`` and decode through
   ``flash_decode_fp8``; the prefill logits held against the cuBLAS path
   over the fake-quant tree, and reported against the bf16 model's;
9b. the same with ``fuse=True`` (the MLP through the int8
   ``matmul_fused``; q, k, v and wo through ``matmul_w8``); 6b, 9 and 9b
   hold every bf16 launch of rows 9, 10 and 11 in their profiled
   windows to the tensor-core instances;
10. training parity (after 9b, the serving model freed): granite-3-8b
   width, 2 layers, fp32, one train step on the kernel path (blocked
   linears: kernel rows 4-8) and on the plain path; loss, grad norm and
   every gradient leaf agree, the plain path launches nothing;
11. training granite-3-8b at full width, depth cut to 4 of 40 layers,
   bf16, remat "block", 4 x 512 tokens for 8 steps, on the default path
   and with blocked kernels: finite losses, step 0 held against the
   plain path, step times, tokens/s and a profiled step whose attention
   kernels (and, blocked, dgrad kernels) are the tensor-core ones;
12. the paper's conv path at full Table-4 size: Conv1..Conv5 and AlexNet
   conv1 (stride 4) at batch 2 in bf16 through ``ops.conv2d`` forward and
   ``torch.autograd.grad`` (dX through row 12, dW through row 13), tiles
   from the model under the three conv keys, held against the fp32
   oracles, launch counts asserted, every wgrad on row 13's tensor-core
   instance, the plain path launching nothing;
7. ``tune_op`` on the decode GEMM shape, the decode QKV pass and Conv4
   into a temporary cache;
8. each kernel timed at the shapes of phases 6, 6b, 9, 9b, 11 and 12
   beside its bound, its plain version and a library call (rows 4 and 5
   with their tiles, TFLOP/s, share of the bound and ratio to SDPA, and
   at S 2048 and 8192 beside SDPA, each pass's kernel time; rows 7 and 8
   at all four projection shapes with the model's tiles, TFLOP/s, share
   of the bound, ratio to ``torch.matmul``, two and three stages);
   rows 12 and 13 at Conv1 and Conv4 with TFLOP/s and share of the bound
   (row 13 with its instance and ratio to ``conv2d_weight``); row 12's
   forward and dgrad and row 13 at all six conv layers.

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

TOL = {"float32": (1e-5, 1e-4),    # summation order only
       "bfloat16": (2e-2, 1e-2)}   # one bf16 rounding of an O(1) output


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def gemm_atol(dtype_name: str, k: int) -> float | None:
    """A K-term fp32 sum rounds at each step, in another order in the
    plain version: allow 2e-6 * sqrt(K) (a random walk of fp32 roundings
    of O(1) partial sums, with margin).  bf16 keeps its output-rounding
    tolerance."""
    if dtype_name != "float32":
        return None
    return max(TOL["float32"][0], 2e-6 * k ** 0.5)


def compare(name: str, out, ref, dtype_name: str,
            atol: float | None = None) -> float:
    """Max abs error of ``out`` vs ``ref``; raises past the tolerance."""
    import torch
    atol, rtol = atol or TOL[dtype_name][0], TOL[dtype_name][1]
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


GRANITE_NK = ((4096, 4096), (1024, 4096), (12800, 4096), (4096, 12800))


def gemm_inputs(dev, dtype, m, n, k, seed):
    """Drawn on the card from ``seed``; B is scaled by K ** -0.5 so every
    output is O(1)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=dev)
         * k ** -0.5).to(dtype)
    return a, b


# the tensor-core instances' edges (b, sq, skv, hq, hkv, d, causal, window,
# cap): Sq and Skv of 16k +- 1, Sq < Skv and Sq > Skv, a window crossing a
# tile boundary, a cap, D 64, G 1 and G 8, non-causal, the join (B 1, S 64).
# Sq > Skv is non-causal: a causal row that sees no key gets 0 from the
# kernels (as from JAX's kernel) and the mean of V from the plain
# version (as from JAX's oracle), so no case holds such a row.
ATTN_EDGES = ((1, 63, 65, 32, 8, 128, True, None, None),
              (2, 129, 127, 32, 8, 128, False, None, None),
              (2, 33, 97, 32, 8, 128, True, None, None),
              (2, 128, 128, 32, 8, 128, True, 40, None),
              (2, 96, 96, 32, 8, 128, True, 70, 30.0),
              (2, 128, 128, 8, 2, 64, True, None, None),
              (2, 100, 100, 8, 8, 128, True, None, None),
              (1, 80, 80, 64, 8, 128, True, None, None),
              (2, 96, 96, 32, 8, 128, False, None, None),
              (1, 64, 64, 32, 8, 128, True, None, None))


def check_attention_edge(dev, dtype, b, sq, skv, hq, hkv, d, causal, window,
                         cap, with_bwd: bool = False) -> None:
    """Row 4 (and with ``with_bwd`` its lse and row 5, repeats bit-equal)
    against the plain versions at one edge shape; the instance that ran is
    the tensor-core one in bf16, at flash_tiles' tiles."""
    import torch
    from repro_torch.core.hopper_adapter import flash_tiles
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    dn = str(dtype).split(".")[1]
    q, k, v = dense_inputs(dev, dtype, b, sq, skv, seed=sq + skv + hq,
                           hq=hq, hkv=hkv, d=d)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    tiles = flash_tiles(sq, skv, d, dtype.itemsize)
    kind = "mma" if dtype == torch.bfloat16 else "cuda_core"
    tag = (f"{dn} B={b} Sq={sq} Skv={skv} Hq/Hkv={hq}/{hkv} D={d} "
           f"causal={causal} window={window} cap={cap} tiles={tiles}")
    if not with_bwd:
        compare(f"flash_attention {tag}", FA.flash_attention(q, k, v, **kw),
                FA.flash_attention_ref(q, k, v, **kw), dn)
        assert FA.flash_attention.instance == (kind, *tiles), tag
        return
    g = dense_inputs(dev, dtype, b, sq, sq, seed=sq, hq=hq, hkv=hq, d=d)[0]
    o, lse = FA._forward(q, k, v, causal, window, cap, with_lse=True)
    assert FA.flash_attention.instance == (kind, *tiles), tag
    compare(f"flash_attention lse {tag}", lse,
            FA.flash_attention_lse_ref(q, k, **kw), "float32", atol=1e-4)
    got = FB.flash_attention_bwd(q, k, v, o, lse, g, **kw)
    assert FB.flash_attention_bwd.instance == (kind, *tiles), tag
    want = FB.flash_attention_bwd_ref(q, k, v, o, lse, g, **kw)
    for name, x, y, n_red in (("dq", got[0], want[0], skv),
                              ("dk", got[1], want[1], sq * hq // hkv),
                              ("dv", got[2], want[2], sq * hq // hkv)):
        atol, _ = grad_tol(dn, n_red, y)
        compare(f"flash_attention_bwd {name} {tag}", x, y, dn, atol=atol)
    again = FB.flash_attention_bwd(q, k, v, o, lse, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again)), tag


# head dims off the 64 and 128 instances: 16 (every reduced config) runs
# at 32, 80 and 96 (phi-3-vision) at 128, 256 (gemma2-9b) at 256
HEAD_DIMS = (16, 80, 96, 256)


def phase3_head_dims(dev) -> None:
    """Rows 1-5 at head dims 16, 80, 96 and 256 against their plain
    versions, fp32 and bf16: paged decode and chunked prefill (rows 1 and
    2, windowed and capped), the oproj-fused decode (row 3, repeats
    bit-equal), the forward with its lse and the backward (rows 4 and 5;
    causal, windowed and non-causal, GQA 8/2, ragged S; repeats
    bit-equal), each at the instance ``flash_tiles`` picks."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for d in HEAD_DIMS:
            page = 32
            for q_span, lengths in ((1, [1, 17, 64, 130]),
                                    (16, [1, 17, 64, 100])):
                for window, cap in ((None, None), (37, 30.0)):
                    args = paged_inputs(dev, dtype, lengths, q_span,
                                        seed=d + q_span, hkv=2, g=4, d=d,
                                        page=page, n_blocks=5)
                    kw = dict(window=window, logit_cap=cap, q_span=q_span)
                    compare(f"flash_decode {dn} D={d} q_span={q_span} "
                            f"window={window} cap={cap}",
                            FD.flash_decode(*args, **kw),
                            FD.paged_attention_ref(*args, **kw), dn)
                    f8 = fp8_paged(paged_inputs(
                        dev, torch.float32, lengths, q_span, seed=d + 1,
                        hkv=2, g=4, d=d, page=page, n_blocks=5),
                        seed=d, unit=window is None)
                    f8 = (f8[0].to(dtype),) + f8[1:]
                    compare(f"flash_decode_fp8 {dn} D={d} q_span={q_span} "
                            f"window={window} cap={cap}",
                            FD.flash_decode_fp8(*f8, **kw),
                            FD.paged_attention_fp8_ref(*f8, **kw), dn)
            args = oproj_inputs(dev, dtype, [1, 17, 64, 130], seed=d,
                                page=page, hkv=2, g=4, d=d, e=512)
            out = FD.flash_decode_oproj(*args, window=37)
            assert torch.equal(out, FD.flash_decode_oproj(*args, window=37))
            compare(f"flash_decode_oproj {dn} D={d} window=37", out,
                    FD.paged_attention_oproj_ref(*args, window=37), dn,
                    gemm_atol(dn, 2 * 4 * d))
            for causal, window in ((True, None), (True, 40), (False, None)):
                check_attention_edge(dev, dtype, 2, 100, 100, 8, 2, d,
                                     causal, window, None, with_bwd=True)
            check_attention_edge(dev, dtype, 1, 33, 97, 8, 2, d, True, None,
                                 30.0, with_bwd=True)
    torch.cuda.synchronize()


def phase3_oproj_wide(dev) -> None:
    """Row 3 at more kv heads: (B 2, Hkv 16, G 1, D 64, E 1024;
    seamless-m4t-medium's attention: 8 slices of 128, cluster 8) and (B
    2, Hkv 32, G 1, D 96, E 3072; phi-3-vision's: 12 slices of 256,
    cluster 12), the last block of each slice summing 16 and 32 heads in
    order, fp32 and bf16, window on and off, repeats bit-equal."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for hkv, d, e in ((16, 64, 1024), (32, 96, 3072)):
            for window in (None, 37):
                args = oproj_inputs(dev, dtype, [45, 300], seed=hkv + d,
                                    page=32, hkv=hkv, g=1, d=d, e=e)
                out = FD.flash_decode_oproj(*args, window=window)
                assert torch.equal(out, FD.flash_decode_oproj(
                    *args, window=window)), (hkv, d, window)
                compare(f"flash_decode_oproj {dn} B=2 Hkv={hkv} G=1 D={d} "
                        f"E={e} window={window} (grid "
                        f"{FD.oproj_grid(hkv, e)})", out,
                        FD.paged_attention_oproj_ref(*args, window=window),
                        dn, gemm_atol(dn, hkv * d))
    torch.cuda.synchronize()


def phase3_kernels(dev) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.hopper_adapter import matmul_tile_candidates
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import matmul_blocked as MB
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.serve.kv_cache import choose_page_size
    cfg = get_config("granite-3-8b")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        model_page = choose_page_size(dataclasses.replace(cfg, dtype=dtype),
                                      512)
        for q_span, lengths in ((1, [1, 17, 64, 130, 300, 512]),
                                (64, [1, 17, 64, 130, 300, 470])):
            for window, cap in ((None, None), (37, 30.0)):
                args = paged_inputs(dev, dtype, lengths, q_span, seed=q_span)
                kw = dict(window=window, logit_cap=cap, q_span=q_span)
                compare(f"flash_decode {dn} q_span={q_span} window={window}"
                        f" cap={cap}", FD.flash_decode(*args, **kw),
                        FD.paged_attention_ref(*args, **kw), dn)
            top = FD.largest_page(cfg.head_dim, dtype.itemsize, torch.cuda
                                  .get_device_properties(dev)
                                  .shared_memory_per_block_optin)
            for page in sorted({16, 32, 64, min(128, top), model_page}):
                args = paged_inputs(dev, dtype, lengths, q_span, seed=page,
                                    page=page, n_blocks=-(-512 // page))
                tag = " (the model's page)" if page == model_page else ""
                compare(f"flash_decode {dn} q_span={q_span} page={page}{tag}",
                        FD.flash_decode(*args, q_span=q_span),
                        FD.paged_attention_ref(*args, q_span=q_span), dn)
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
        for case in ATTN_EDGES:
            check_attention_edge(dev, dtype, *case)
        # ragged M, N and K (scalar and 16-byte staging paths; in bf16
        # both tensor-core instances: 3, 5 and 13 rows on "mma_t", one
        # and two token tiles), repeats bit-equal, the instance asserted
        for m, n, k, tiles in ((37, 1000, 300, (16, 64, 64)),
                               (50, 100, 70, (32, 128, 64)),
                               (3, 5, 7, (3, 64, 64)),
                               (13, 1008, 300, (13, 64, 32)),
                               (5, 20, 48, (5, 48, 16)),
                               (17, 40, 72, (16, 32, 24)),
                               (520, 4104, 4100, (128, 64, 128))):
            a, b = gemm_inputs(dev, dtype, m, n, k, seed=m + n)
            bm, bk, bn = tiles
            out = MB.matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)
            kind = MB.matmul_blocked.instance
            assert kind[0] == MF.instance_kind(dtype, m), (tiles, kind)
            compare(f"matmul_blocked {dn} M={m} N={n} K={k} tiles={tiles} "
                    f"{kind}", out, MB.matmul_ref(a, b), dn,
                    gemm_atol(dn, k))
            assert torch.equal(out, MB.matmul_blocked(a, b, bm=bm, bk=bk,
                                                      bn=bn))
        # every tile the adapter emits for granite's projections under
        # the "matmul" key (bf16: the instance's, at M <= 16 the decode
        # tile), repeats bit-equal
        n_tiles = 0
        for m in (1, 8, 16, 17, 64, 512):
            for n, k in GRANITE_NK:
                a, b = gemm_inputs(dev, dtype, m, n, k, seed=m + n + k)
                ref = MB.matmul_ref(a, b)
                for bm, bk, bn in matmul_tile_candidates(
                        m, n, k, a.element_size(), fused=True):
                    out = MB.matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)
                    kind = MB.matmul_blocked.instance
                    assert kind[0] == MF.instance_kind(dtype, m), kind
                    compare(f"matmul_blocked {dn} M={m} N={n} K={k} "
                            f"tiles={(bm, bk, bn)} {kind}", out, ref, dn,
                            gemm_atol(dn, k))
                    assert torch.equal(out, MB.matmul_blocked(
                        a, b, bm=bm, bk=bk, bn=bn))
                    n_tiles += 1
        print(f"  {n_tiles} adapter tiles checked in {dn}; the largest page "
              f"that fits is {top} keys")
    torch.cuda.synchronize()


GRANITE_MLP = (("gate", 12800, 4096, dict(act="silu")),
               ("up", 12800, 4096, dict(mul=True)),
               ("down", 4096, 12800, dict(residual=True)))


def epilogue(dev, dtype, m, n, seed, act="none", scale=False, bias=False,
             mul=False, residual=False) -> dict:
    """matmul_fused keyword arguments: fp32 scale and bias rows, (m, n)
    mul and residual blocks in ``dtype``, all O(1), from ``seed``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    return dict(act=act,
                scale=r(n).abs() + 0.5 if scale else None,
                bias=r(n) if bias else None,
                mul=r(m, n, dt=dtype) if mul else None,
                residual=r(m, n, dt=dtype) if residual else None)


def qkv_inputs(dev, dtype, m, nkv, k, g, seed):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)
    return (r(m, k), r(k, g * nkv, scale=k ** -0.5),
            r(k, nkv, scale=k ** -0.5), r(k, nkv, scale=k ** -0.5))


def oproj_inputs(dev, dtype, lengths, seed, page, hkv=8, g=4, d=128,
                 e=4096):
    """``paged_inputs`` at q_span 1 plus a (Hkv, G*D, E) wo scaled so
    every output is O(1)."""
    import torch
    args = paged_inputs(dev, dtype, lengths, 1, seed, hkv=hkv, g=g, d=d,
                        page=page, n_blocks=-(-512 // page))
    gen = torch.Generator(device=dev).manual_seed(seed)
    wo = (torch.randn((hkv, g * d, e), generator=gen, device=dev)
          * (hkv * g * d) ** -0.5).to(dtype)
    return (*args, wo)


# row 9 at decode (1, 8, 16 tokens: the transposed instance), a join of
# 24 and a 512-token prefill (the mma instance)
ROW9_M = (1, 8, 16, 24, 512)


def check_row9(dev, dtype, w8: bool) -> int:
    """Row 9 (wide, or with ``w8`` an int8 weight and its per-channel
    scale in the epilogue) against its plain version: every activation
    and epilogue operand on and off at M = 64 and 8; ragged M, N and K
    (3 and 13 tokens: one and two n8 token tiles; the scalar staging
    path of a wide W); granite's gate, up and down projections with the
    model's epilogues at ``ROW9_M`` under every tile the adapter emits
    for the ``"matmul_fused"`` (``"matmul_fused_w8"``) key, repeats
    bit-equal.  bf16 asserts the instance: ``"mma_t"`` at M <= 16,
    ``"mma"`` above.  Returns the adapter tiles checked."""
    import itertools

    import torch
    from repro_torch.core.hopper_adapter import matmul_tile_candidates
    from repro_torch.kernels import matmul_fused as MF
    dn = str(dtype).split(".")[1]
    tag = "matmul_fused int8" if w8 else "matmul_fused"

    def operands(m, n, k, seed):
        if not w8:
            return (*gemm_inputs(dev, dtype, m, n, k, seed), None)
        a, qw = w8_inputs(dev, dtype, m, n, k, seed)
        return a, qw.q, qw.scale.reshape(-1)

    def epi(m, n, seed, **k):
        """(scale, the other epilogue keywords) of ``epilogue``."""
        kw = epilogue(dev, dtype, m, n, seed, **k)
        return kw.pop("scale"), kw

    def run(a, w, sc, kw, tiles):
        bm, bk, bn = tiles
        out = MF.matmul_fused(a, w, sc, **kw, bm=bm, bk=bk, bn=bn)
        kind = MF.matmul_fused.instance
        assert kind[0] == MF.instance_kind(dtype, a.shape[0]), (tiles, kind)
        return out, kind

    # every epilogue combination at an "mma" and an "mma_t" shape; an
    # int8 product without its scale is O(127 sqrt(K)), so A then carries
    # the mean scale and every output stays O(1)
    for m, tiles in ((64, (64, 64, 128)), (8, (8, 128, 32))):
        n, k = 1024, 512
        a, w, scale = operands(m, n, k, seed=11 + m)
        for act, sc, bi, mu, re in itertools.product(
                MF.ACTIVATIONS, *[(False, True)] * 4):
            s_in, kw = epi(m, n, 12, act=act, scale=sc and not w8, bias=bi,
                           mul=mu, residual=re)
            a_in = a
            if w8 and sc:
                s_in = scale
            elif w8:
                a_in = (a.float() * scale.mean()).to(dtype)
            out, kind = run(a_in, w, s_in, kw, tiles)
            compare(f"{tag} {dn} M={m} act={act} scale={int(sc)} "
                    f"bias={int(bi)} mul={int(mu)} res={int(re)} {kind}",
                    out, MF.matmul_fused_ref(a_in, w, s_in, **kw), dn,
                    gemm_atol(dn, k))
    # ragged shapes: N a multiple of 16 (an int8 W's rule), and for a
    # wide W also N not a multiple of 8 (the scalar staging path and the
    # masked partial chunk of both instances)
    ragged = [(37, 1008, 300, (16, 64, 64)), (50, 112, 70, (32, 128, 64)),
              (3, 16, 7, (3, 64, 64)), (13, 1008, 300, (13, 64, 32)),
              (520, 4112, 4100, (128, 64, 128))]
    if not w8:
        ragged += [(37, 1000, 300, (16, 64, 64)), (50, 100, 70, (32, 128, 64)),
                   (3, 5, 7, (3, 64, 64)), (13, 20, 33, (13, 32, 16)),
                   (520, 4104, 4100, (128, 64, 128))]
    for m, n, k, tiles in ragged:
        a, w, scale = operands(m, n, k, seed=m + n)
        _, kw = epi(m, n, 13, act="gelu", bias=True, mul=True,
                    residual=True)
        out, kind = run(a, w, scale, kw, tiles)
        compare(f"{tag} {dn} M={m} N={n} K={k} tiles={tiles} {kind}", out,
                MF.matmul_fused_ref(a, w, scale, **kw), dn, gemm_atol(dn, k))
    if not w8:
        a, w = gemm_inputs(dev, dtype, 5, 1000, 301, seed=5)
        _, kw = epi(5, 1000, 14, act="silu", residual=True)
        out, kind = run(a, w, None, kw, (5, 64, 64))
        compare(f"{tag} {dn} M=5 N=1000 K=301 (scalar staging) {kind}",
                out, MF.matmul_fused_ref(a, w, **kw), dn, gemm_atol(dn, 301))
    # every tile the adapter emits for granite's MLP, with the epilogue
    # the model gives each projection
    n_tiles = 0
    for m in ROW9_M:
        for name, n, k, epi_kw in GRANITE_MLP:
            a, w, scale = operands(m, n, k, seed=m + n + k)
            _, kw = epi(m, n, m, **epi_kw)
            ref = MF.matmul_fused_ref(a, w, scale, **kw)
            for tiles in matmul_tile_candidates(
                    m, n, k, a.element_size(), w_bytes=1 if w8 else None,
                    fused=True):
                out, kind = run(a, w, scale, kw, tiles)
                compare(f"{tag} {dn} {name} M={m} N={n} K={k} "
                        f"tiles={tiles} {kind}", out, ref, dn,
                        gemm_atol(dn, k))
                assert torch.equal(out, run(a, w, scale, kw, tiles)[0])
                n_tiles += 1
    return n_tiles


# rows 10 and 11 at decode (1, 8, 16 tokens: the transposed instance),
# joins of 24 and 37, a chunk of 64 and a 512-token prefill (mma)
QKV_M = (1, 8, 16, 24, 37, 64, 512)


def check_qkv(dev, dtype, m, nkv, k, g) -> int:
    """``qkv_fused`` at (M, Nkv, K, G) under every adapter tile of the
    ``"qkv_fused"`` key, against its plain version, repeats bit-equal;
    bf16 asserts the instance.  Returns the tiles checked."""
    import torch
    from repro_torch.core.hopper_adapter import qkv_fused_tile_candidates
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import qkv_fused as QF
    dn = str(dtype).split(".")[1]
    x, wq, wk, wv = qkv_inputs(dev, dtype, m, nkv, k, g, seed=m + nkv)
    refs = QF.qkv_fused_ref(x, wq, wk, wv)
    tiles = qkv_fused_tile_candidates(m, nkv, k, g, x.element_size())
    for bm, bk, bn in tiles:
        got = QF.qkv_fused(x, wq, wk, wv, bm=bm, bk=bk, bn=bn)
        kind = QF.qkv_fused.instance
        assert kind[0] == MF.instance_kind(dtype, m), kind
        for part, o, r, a in zip("qkv", got, refs, QF.qkv_fused(
                x, wq, wk, wv, bm=bm, bk=bk, bn=bn)):
            compare(f"qkv_fused {dn} {part} M={m} Nkv={nkv} K={k} G={g} "
                    f"tiles={(bm, bk, bn)} {kind}", o, r, dn,
                    gemm_atol(dn, k))
            assert torch.equal(o, a)
    return len(tiles)


def phase3_fused(dev) -> None:
    """The three fused kernels against their plain versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve.kv_cache import choose_page_size
    cfg = get_config("granite-3-8b")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        n_tiles = check_row9(dev, dtype, w8=False)
        # qkv_fused: every adapter tile at granite's (Nkv, K, G) and the
        # reduced granite's, ragged Nkv and K with G = 1 and 3
        for m, nkv, k, g in [(m, 1024, 4096, 4) for m in QKV_M] + [
                (8, 32, 64, 2), (24, 32, 64, 2), (13, 96, 136, 1),
                (24, 96, 136, 1), (5, 40, 70, 3), (40, 40, 70, 3)]:
            n_tiles += check_qkv(dev, dtype, m, nkv, k, g)
        # flash_decode_oproj: granite's decode, B = 8, at pages 16, 32,
        # 64 and the fused engine's page, and B = 20 (two groups of
        # batch rows, wo read twice); two launches agree bit for bit and
        # leave the slice counters zero
        fused_page = choose_page_size(dataclasses.replace(cfg, dtype=dtype),
                                      512, fused=True)
        lengths = [1, 17, 64, 130, 300, 512, 33, 250]
        wide = [(37 * i) % 512 + 1 for i in range(20)]
        for page, lens in [(p, lengths) for p in sorted(
                {16, 32, 64, fused_page})] + [(32, wide)]:
            for window, cap in ((None, None), (37, 30.0)):
                args = oproj_inputs(dev, dtype, lens, seed=page,
                                    page=page)
                kw = dict(window=window, logit_cap=cap)
                out = FD.flash_decode_oproj(*args, **kw)
                assert torch.equal(out, FD.flash_decode_oproj(*args, **kw))
                assert not FD._COUNTERS[out.device].any()
                tag = " (the fused page)" if page == fused_page else ""
                compare(f"flash_decode_oproj {dn} B={len(lens)} "
                        f"page={page} window={window} cap={cap}{tag} grid "
                        f"{FD.oproj_grid(8, 4096)}", out,
                        FD.paged_attention_oproj_ref(*args, **kw), dn,
                        gemm_atol(dn, 8 * 4 * 128))
        print(f"  {n_tiles} adapter tiles of the fused GEMMs checked in "
              f"{dn}; the fused engine's page is {fused_page}")
    torch.cuda.synchronize()


def w8_inputs(dev, dtype, m, n, k, seed):
    """``gemm_inputs`` with the weight quantized to int8 per output
    channel (``quant.quantize``): A in ``dtype`` and the QuantizedTensor."""
    import torch
    from repro_torch.quant import quantize
    a, w = gemm_inputs(dev, torch.float32, m, n, k, seed)
    return a.to(dtype), quantize(w)


def fp8_paged(args, seed, unit=True):
    """``paged_inputs`` with the pools cast to float8_e4m3fn and the
    per-kv-head fp32 scales (ones, or drawn in [0.5, 2] from ``seed``)."""
    import torch
    q, kp, vp, bt, ln = args
    hkv = kp.shape[2]
    rng = np.random.default_rng(seed)
    ks, vs = (torch.ones(hkv, device=q.device) if unit else
              torch.tensor(rng.uniform(0.5, 2.0, hkv), dtype=torch.float32,
                           device=q.device) for _ in range(2))
    fp8 = torch.float8_e4m3fn
    return q, kp.to(fp8), vp.to(fp8), ks, vs, bt, ln


GRANITE_PROJ = ("wq, wo", "wk, wv", "w_gate, w_up", "w_down")   # GRANITE_NK
W8_M = (1, 8, 16, 24, 64, 512)


def check_w8(a, w_q, scale, tiles, ref, what: str) -> None:
    """``matmul_w8`` at these tiles against ``ref``, repeats bit-equal;
    bf16 asserts the instance (``"mma_t"`` at M <= 16, ``"mma"``
    above)."""
    import torch
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import matmul_q as MQ
    dn = str(a.dtype).split(".")[1]
    bm, bk, bn = tiles
    out = MQ.matmul_w8(a, w_q, scale, bm=bm, bk=bk, bn=bn)
    kind = MQ.matmul_w8.instance
    assert kind[0] == MF.instance_kind(a.dtype, a.shape[0]), kind
    compare(f"matmul_w8 {dn} {what} tiles={tiles} {kind}", out, ref, dn,
            gemm_atol(dn, a.shape[1]))
    assert torch.equal(out, MQ.matmul_w8(a, w_q, scale, bm=bm, bk=bk,
                                         bn=bn))


def phase3_quant(dev) -> None:
    """The three quantized kernels against their plain versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.hopper_adapter import matmul_tile_candidates
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import matmul_q as MQ
    from repro_torch.serve.kv_cache import choose_page_size
    from repro_torch.tune import best_schedule
    cfg = get_config("granite-3-8b")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        n_tiles = 0
        # matmul_w8: every adapter tile of granite's projections (four
        # shapes cover the seven), per-channel scales, repeats bit-equal;
        # the model's tile also with a per-tensor scale.  The key's tiles
        # are row 9's int8 ones (its bf16 kernels are row 9's instances)
        for m in W8_M:
            for (n, k), names in zip(GRANITE_NK, GRANITE_PROJ):
                a, qw = w8_inputs(dev, dtype, m, n, k, seed=m + n + k)
                ref = MQ.matmul_w8_ref(a, qw.q, qw.scale)
                for tiles in matmul_tile_candidates(
                        m, n, k, a.element_size(), w_bytes=1, fused=True):
                    check_w8(a, qw.q, qw.scale, tiles, ref,
                             f"{names} M={m} N={n} K={k}")
                    n_tiles += 1
                tiles = best_schedule("matmul_w8", (m, n, k), dn).tiles
                s = qw.scale.max()
                check_w8(a, qw.q, s, tiles, MQ.matmul_w8_ref(a, qw.q, s),
                         f"{names} M={m} per-tensor scale")
        # ragged M, N and K (scalar A staging when K is no multiple of
        # 16 B; a last column block past N), on both bf16 instances
        for m, n, k, tiles in ((37, 1008, 300, (16, 64, 64)),
                               (520, 4112, 4100, (128, 64, 128)),
                               (13, 1008, 300, (13, 64, 32)),
                               (3, 16, 7, (3, 64, 16)),
                               (1, 4112, 4100, (1, 512, 32))):
            a, qw = w8_inputs(dev, dtype, m, n, k, seed=m + n)
            check_w8(a, qw.q, qw.scale, tiles,
                     MQ.matmul_w8_ref(a, qw.q, qw.scale),
                     f"M={m} N={n} K={k} ragged")
        # the int8 matmul_fused: every epilogue, ragged shapes and every
        # adapter tile of granite's MLP under "matmul_fused_w8"
        n_tiles += check_row9(dev, dtype, w8=True)
        # flash_decode_fp8 at pages 16, 32, 64 and the model's fp8 page
        fp8_page = choose_page_size(dataclasses.replace(
            cfg, dtype=dtype, kv_cache_dtype=torch.float8_e4m3fn), 512)
        for q_span, lengths in ((1, [1, 17, 64, 130, 300, 512]),
                                (64, [1, 17, 64, 130, 300, 470])):
            for page in sorted({16, 32, 64, fp8_page}):
                for window, cap, unit in ((None, None, True),
                                          (37, 30.0, False)):
                    args = fp8_paged(paged_inputs(
                        dev, torch.float32, lengths, q_span, seed=page,
                        page=page, n_blocks=-(-512 // page)), seed=page,
                        unit=unit)
                    args = (args[0].to(dtype),) + args[1:]
                    kw = dict(window=window, logit_cap=cap, q_span=q_span)
                    out = FD.flash_decode_fp8(*args, **kw)
                    assert torch.equal(out, FD.flash_decode_fp8(*args, **kw))
                    tag = " (the model's fp8 page)" if page == fp8_page \
                        else ""
                    compare(f"flash_decode_fp8 {dn} q_span={q_span} "
                            f"page={page} window={window} cap={cap} "
                            f"scales={'unit' if unit else 'drawn'}{tag}",
                            out, FD.paged_attention_fp8_ref(*args, **kw), dn)
        print(f"  {n_tiles} adapter tiles of matmul_w8 and the int8 "
              f"matmul_fused checked in {dn}; the "
              f"model's fp8 page is {fp8_page}")
    torch.cuda.synchronize()


def engine_for(cfg, params, **kw):
    """The main path's engine: page 64, prefill chunk 64, max_seq 512."""
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    return PagedEngine(cfg, params, PagedServeConfig(
        max_seq=512, page_size=64, prefill_chunk=64, device="cuda", **kw))


def serve(cfg, params, prompts, n_tokens, **kw):
    return engine_for(cfg, params, **kw).generate(prompts, n_tokens,
                                                  return_requests=True)


def phase4_parity(seed: int, kernels: dict) -> None:
    """Unfused, then fused, with wide weights and then under w8fp8 (int8
    projections, fp8 pages): the kernel path and the plain path give
    identical greedy streams through joins and chunked prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.quant import quantize_params
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype=torch.float32)
    params = T.init_params(cfg, seed=seed, device="cuda")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    qparams = quantize_params(params)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in (5, 37, 64, 65, 130, 300)]    # joins and chunks
    runs = (
        ("wide", cfg, params, False, ("flash_attention", "flash_decode")),
        ("wide", cfg, params, True,
         ("flash_attention", "flash_decode", "flash_decode_oproj",
          "matmul_fused", "qkv_fused")),
        ("w8fp8", cfg8, qparams, False,
         ("flash_attention", "flash_decode_fp8", "matmul_w8")),
        ("w8fp8", cfg8, qparams, True,
         ("flash_attention", "flash_decode_fp8", "matmul_w8",
          "matmul_fused")))
    for mode, c, p, fuse, path in runs:
        reset(kernels)
        kern = serve(c, p, prompts, 8, max_batch=4, fuse=fuse)
        launched = counts(kernels)
        plain = serve(c, p, prompts, 8, max_batch=4, fuse=fuse,
                      use_kernel=False)
        assert counts(kernels) == launched, "the plain path launched a kernel"
        assert min(launched[k] for k in path) > 0, launched
        others = {k: n for k, n in launched.items() if k not in path}
        assert not any(others.values()), (mode, fuse, others)
        for a, b in zip(kern, plain):
            if not np.array_equal(a.output, b.output):
                raise AssertionError(f"{mode} fuse={fuse}, request {a.rid}: "
                                     f"kernel path {a.output.tolist()} != "
                                     f"plain path {b.output.tolist()}")
        print(f"  {mode} fuse={fuse}: 6 requests x 8 tokens identical "
              f"(kernel launches: { {k: launched[k] for k in path} }); "
              f"first tokens {[int(r.output[0]) for r in kern]}")
    del params, qparams
    torch.cuda.empty_cache()


def phase13_reduced(seed: int, kernels: dict) -> dict:
    """The reduced granite-3-8b (``configs.get_reduced``: d_model 64, 4
    heads of 16 over 2 kv heads, d_ff 128, 2 layers; head_dim 16 runs the
    attention kernels' 32-wide instance) on the card.  Serving, fp32: 6
    requests x 8 tokens through joins and chunked prefill, unfused and
    fused, the kernel path token-identical to the plain path; bf16 fused:
    the same requests, every row-9 and row-11 call on its transposed
    (decode) or mma instance.  Training, bf16: 3 steps on the default path (rows 4
    and 5 forward and backward), finite losses, step 0's loss within 2%
    of the plain path's.  Then the two launchers' own usage lines,
    ``launch.train --reduced --steps 2`` and ``launch.serve --reduced``,
    on their default device."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    base = get_reduced("granite-3-8b")
    print(f"  {base.name}: d_model {base.d_model}, {base.n_heads} heads / "
          f"{base.n_kv_heads} kv heads, head_dim {base.head_dim}, d_ff "
          f"{base.d_ff}, {base.n_layers} layers")
    assert base.head_dim == 16
    cfg = dataclasses.replace(base, dtype=torch.float32)
    params = T.init_params(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in (5, 37, 64, 65, 130, 300)]
    out = {"head_dim": base.head_dim}
    for fuse, path in ((False, ("flash_attention", "flash_decode")),
                       (True, ("flash_attention", "flash_decode",
                               "flash_decode_oproj", "matmul_fused",
                               "qkv_fused"))):
        reset(kernels)
        kern = serve(cfg, params, prompts, 8, max_batch=4, fuse=fuse)
        launched = counts(kernels)
        plain = serve(cfg, params, prompts, 8, max_batch=4, fuse=fuse,
                      use_kernel=False)
        assert counts(kernels) == launched, "the plain path launched a kernel"
        assert min(launched[k] for k in path) > 0, launched
        for a, b in zip(kern, plain):
            if not np.array_equal(a.output, b.output):
                raise AssertionError(f"reduced fuse={fuse}, request {a.rid}:"
                                     f" kernel path {a.output.tolist()} != "
                                     f"plain path {b.output.tolist()}")
        print(f"  fp32 fuse={fuse}: 6 requests x 8 tokens identical to the "
              f"plain path (kernel launches: "
              f"{ {k: launched[k] for k in path} })")
        out[f"serve_fuse_{int(fuse)}"] = {k: launched[k] for k in path}
    cfgb = dataclasses.replace(base, dtype=torch.bfloat16)
    paramsb = T.init_params(cfgb, seed=seed, device="cuda")
    kinds = {"matmul_fused": set(), "qkv_fused": set()}
    real = {name: getattr(ops, f"_{name}_kernel") for name in kinds}

    def spy(name):              # the op's launch, and what it ran
        def launch(a, *args, **kw):
            y = real[name](a, *args, **kw)
            kinds[name].add((a.shape[0] <= MF.MMA_T_ROWS,
                             real[name].instance[0]))
            return y
        return launch
    for name in kinds:
        setattr(ops, f"_{name}_kernel", spy(name))
    try:
        reqs = serve(cfgb, paramsb, prompts, 8, max_batch=4, fuse=True)
    finally:
        for name in kinds:
            setattr(ops, f"_{name}_kernel", real[name])
    assert all(len(r.output) == 8 and int(r.output.max()) < cfgb.vocab
               for r in reqs)
    for name, seen in kinds.items():
        assert seen == {(True, "mma_t"), (False, "mma")}, (name, seen)
    print(f"  bf16 fuse=True: 6 requests x 8 tokens; rows 9 and 11 on "
          f"{sorted(k for _, k in kinds['matmul_fused'])} and "
          f"{sorted(k for _, k in kinds['qkv_fused'])}; first tokens "
          f"{[int(r.output[0]) for r in reqs]}")
    del params, paramsb
    # training: 3 steps, bf16, the default path
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    params0 = T.init_params(cfgb, seed=seed, device="cuda")
    batches = [make_batch(cfgb, 128, 8, s, seed=seed, device="cuda")
               for s in range(3)]
    plain, _ = train_one_step(cfgb, params0, batches[0], blocked=False,
                              use_kernel=False, opt=opt)
    step_fn = loop.make_train_step(cfgb, loop.TrainConfig(opt=opt))
    params, state = params0, adamw.init_state(params0)
    reset(kernels)
    losses = []
    for batch in batches:
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    launched = counts(kernels)
    assert all(np.isfinite(losses)), losses
    assert launched["flash_attention"] > 0 and \
        launched["flash_attention_bwd"] > 0, launched
    assert FA.flash_attention.instance[0] == "mma" and \
        FB.flash_attention_bwd.instance[0] == "mma"
    ref = float(plain["loss"])
    print(f"  bf16 training, 3 steps: losses {losses}; step 0 vs plain "
          f"{ref:.5f} (rel {abs(losses[0] - ref) / abs(ref):.2e}, bound "
          f"2e-2); attention {FA.flash_attention.instance} forward, "
          f"{FB.flash_attention_bwd.instance} backward")
    assert abs(losses[0] - ref) <= 2e-2 * abs(ref), (losses[0], ref)
    out["train"] = {"losses": losses, "plain_step0": ref,
                    "launches": {k: launched[k] for k in
                                 ("flash_attention", "flash_attention_bwd")}}
    del params0, params, state
    torch.cuda.empty_cache()
    # the launchers' usage lines, on their default device (cuda)
    launch_train.main(["--arch", "granite-3-8b", "--reduced", "--steps",
                       "2"])
    launch_serve.main(["--arch", "granite-3-8b", "--reduced", "--requests",
                       "4", "--gen", "8"])
    return out


def time_ms(fn) -> float:
    """Median device ms of ``fn`` over 50 launches, each after an L2 flush
    and a device spin (``repro_torch.tune.measure.time_ms``)."""
    from repro_torch.tune.measure import time_ms as measure_ms
    return measure_ms(fn, reps=50)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over its memory rate or
    flops over its dense bf16 rate, the larger (the Hopper target's)."""
    from repro_torch.core.hopper_adapter import H100_SXM
    t_bytes = n_bytes / H100_SXM.hbm_bytes_per_s * 1e3
    t_ops = flops / H100_SXM.peak_bf16_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_line(row: dict, flops: float, tiles) -> None:
    """Rows 4 and 5 in phase 8: the tiles, the rate, the share of the
    bound and the ratio to the SDPA call."""
    print(f"  {row['name']} [{row['shape'].split(',')[0]}]: tiles {tiles}, "
          f"{row['ms']:.4f} ms, {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of the "
          f"{row['bound_ms']:.4f} ms bound ({row['bound_by']}), "
          f"{row['ms'] / row['library_ms']:.2f}x SDPA "
          f"({row['library_ms']:.4f} ms)")


def full_model(seed: int):
    """granite-3-8b at full width and depth in bf16, and phase 5's 16
    requests, all from ``seed``."""
    import torch
    from repro_torch.configs import get_config
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
    lens = rng.integers(16, 301, 16)
    prompts = [rng.integers(0, cfg.vocab, (int(n),), dtype=np.int32)
               for n in lens]
    return cfg, params, warm, lens, prompts


def counts(kernels) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def reset(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def run_engine(cfg, engine, prompts, kernels,
               fused: bool = False) -> tuple[dict, dict]:
    """Serve ``prompts`` (32 new tokens each) on a warm engine with every
    launch count at 0 just before; checks every request, the pool and
    the attention kernels' launches (under ``fused``, single-token
    decode runs flash_decode_oproj and only prefill chunks flash_decode;
    an fp8 pool runs flash_decode_fp8 for both, fused or not).
    """
    import torch
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    reqs = engine.generate(prompts, 32, return_requests=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    snap = engine.metrics.snapshot()["engine"]
    for r in reqs:
        assert r.status.value == "ok" and len(r.output) == 32, r.rid
        assert 0 <= r.output.min() and r.output.max() < cfg.vocab
    assert engine.scheduler.allocator.in_use() == 0, "pages leaked"
    n_layers = cfg.n_layers
    assert launches["flash_attention"] == n_layers * snap["joins"] > 0
    fp8 = (cfg.kv_cache_dtype or cfg.dtype).itemsize == 1
    decode = ("flash_decode_fp8" if fp8 else
              "flash_decode_oproj" if fused else "flash_decode")
    assert launches[decode] >= n_layers * snap["decode_steps"] > 0
    assert launches["flash_decode"] + launches["flash_decode_oproj"] + \
        launches["flash_decode_fp8"] == \
        n_layers * (snap["decode_steps"] + snap["prefill_chunks"])
    tokens = sum(len(r.output) for r in reqs)
    summary = {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
               "tok_per_s": tokens / wall, "page": engine.page_size,
               "prefill_chunk": engine.prefill_chunk,
               "joins": snap["joins"],
               "prefill_chunks": snap["prefill_chunks"],
               "decode_steps": snap["decode_steps"],
               "engine_steps": snap["steps"], "launches": launches}
    print(f"  {len(reqs)} requests OK, {tokens} tokens in {wall:.3f}s = "
          f"{tokens / wall:.1f} tok/s; page {engine.page_size}, chunk "
          f"{engine.prefill_chunk}; joins {snap['joins']}, prefill chunks "
          f"{snap['prefill_chunks']}, decode steps {snap['decode_steps']}, "
          f"engine steps {snap['steps']}; launches {launches}")
    return summary, snap


def prefill_logits(cfg, params, prompt, **kw):
    import torch
    from repro_torch.models import transformer as T
    tok = torch.from_numpy(prompt[None, :64].copy()).cuda()
    logits, _ = T.prefill(cfg, params, tok, max_seq=64, **kw)
    return logits.float()


def hold_logits(name: str, got, want) -> dict:
    """``got`` against ``want`` within 5% of the largest |logit|."""
    import torch
    dev_ = float((got - want).abs().max())
    scale = float(want.abs().max())
    same = int(got.argmax()) == int(want.argmax())
    print(f"  full-width prefill logits, {name}: max |diff| {dev_:.3e} of "
          f"max |logit| {scale:.3e} (bound 5%); argmax "
          f"{'agrees' if same else 'differs'}")
    assert torch.isfinite(got).all() and dev_ <= 0.05 * scale and same, \
        (name, dev_, scale, same)
    return {"max_abs_diff": dev_, "max_abs_logit": scale}


def phase5_full(cfg, params, warm, prompts, kernels) -> dict:
    """The cuBLAS path at page 64 and chunk 64, as in the first slice."""
    serve(cfg, params, warm, 4, max_batch=8)        # cuBLAS handles etc.
    summary, _ = run_engine(cfg, engine_for(cfg, params, max_batch=8),
                            prompts, kernels)
    assert summary["launches"]["matmul_blocked"] == 0
    # what comes out is right: the full-width prefill logits of one
    # prompt through the kernels agree with the plain versions
    summary["logits_vs_plain"] = hold_logits(
        "kernels vs plain", prefill_logits(cfg, params, prompts[0]),
        prefill_logits(cfg, params, prompts[0], use_kernel=False))
    summary["profile"] = profile_window(engine_for(cfg, params, max_batch=8),
                                        prompts[:8], 8)
    return summary


def phase6_blocked(cfg, params, warm, prompts, kernels) -> dict:
    """The blocking model's page and chunk, every projection through
    matmul_blocked, on phase 5's requests."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (PagedEngine, PagedServeConfig,
                                          default_buckets)
    from repro_torch.tune import best_schedule, set_schedule_observer

    def engine():
        return PagedEngine(cfg, params, PagedServeConfig(
            max_seq=512, max_batch=8, device="cuda"))

    resolved: dict[tuple, int] = {}

    def observe(spec, sched):
        key = (spec.op, spec.dims, spec.dtype, sched.tiles, sched.source)
        resolved[key] = resolved.get(key, 0) + 1

    with ops.blocked_linear():
        eng = engine()
        # derive the model's tiles for every M the run can give a
        # projection (decode slots, join buckets, chunk spans) before
        # the clock starts: a search is host work the cache removes
        t0 = time.perf_counter()
        ms = {8} | set(default_buckets(cfg, 512))
        ms |= {1 << i for i in range(eng.prefill_chunk.bit_length())}
        for m in sorted(ms):
            for n, k in GRANITE_NK:
                best_schedule("matmul", (m, n, k), "bfloat16")
        print(f"  tiles derived for M in {sorted(ms)} x 4 projection "
              f"shapes in {time.perf_counter() - t0:.1f}s")
        serve_warm = engine()
        serve_warm.generate(warm, 4)
        prev = set_schedule_observer(observe)
        try:
            summary, snap = run_engine(cfg, eng, prompts, kernels)
        finally:
            set_schedule_observer(prev)
        calls = snap["joins"] + snap["decode_steps"] + snap["prefill_chunks"]
        assert summary["launches"]["matmul_blocked"] == \
            7 * cfg.n_layers * calls, (summary["launches"], calls)
        print(f"  matmul_blocked launches "
              f"{summary['launches']['matmul_blocked']} = 7 projections x "
              f"{cfg.n_layers} layers x {calls} model calls")
        print("  schedule resolutions in the run (op, dims, dtype, tiles, "
              "source: calls):")
        for key, n in sorted(resolved.items()):
            print(f"    {key}: {n}")
        summary["resolutions"] = [
            {"op": op, "dims": list(d), "dtype": dt, "tiles": list(t),
             "source": src, "calls": n}
            for (op, d, dt, t, src), n in sorted(resolved.items())]
        summary["logits_vs_cublas"] = hold_logits(
            "blocked GEMM vs cuBLAS",
            prefill_logits(cfg, params, prompts[0]),
            _cublas_logits(cfg, params, prompts[0]))
        summary["profile"] = profile_window(engine(), prompts[:8], 8)
        hold_mma_kinds(summary["profile"], ("matmul_blocked",))
    return summary


def phase6_fused(cfg, params, warm, prompts, kernels) -> dict:
    """Phase 6 with fuse=True: the same model, requests, blocked linears
    and model-chosen page and chunk, so the only difference is fusion."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (PagedEngine, PagedServeConfig,
                                          default_buckets)
    from repro_torch.tune import best_schedule

    def engine():
        return PagedEngine(cfg, params, PagedServeConfig(
            max_seq=512, max_batch=8, device="cuda", fuse=True))

    g = cfg.n_heads // cfg.n_kv_heads
    nkv = cfg.n_kv_heads * cfg.head_dim
    with ops.blocked_linear():
        eng = engine()
        # the fused keys' tiles for every M the run can give them, and
        # wo's (the blocked GEMM at joins and spans), before the clock
        t0 = time.perf_counter()
        ms = {8} | set(default_buckets(cfg, 512))
        ms |= {1 << i for i in range(eng.prefill_chunk.bit_length())}
        for m in sorted(ms):
            best_schedule("qkv_fused", (m, nkv, cfg.d_model, g), "bfloat16")
            for _, n, k, _ in GRANITE_MLP:
                best_schedule("matmul_fused", (m, n, k), "bfloat16")
            best_schedule("matmul", (m, cfg.d_model, cfg.n_heads
                                     * cfg.head_dim), "bfloat16")
        print(f"  fused tiles derived for M in {sorted(ms)} in "
              f"{time.perf_counter() - t0:.1f}s; page {eng.page_size} and "
              f"chunk {eng.prefill_chunk} under flash_decode_oproj")
        engine().generate(warm, 4)
        summary, snap = run_engine(cfg, eng, prompts, kernels, fused=True)
        launches, n_layers = summary["launches"], cfg.n_layers
        calls = snap["joins"] + snap["decode_steps"] + snap["prefill_chunks"]
        spans = snap["joins"] + snap["prefill_chunks"]
        assert launches["qkv_fused"] == n_layers * calls, launches
        assert launches["matmul_fused"] == 3 * n_layers * calls, launches
        assert launches["flash_decode_oproj"] == \
            n_layers * snap["decode_steps"], launches
        assert launches["matmul_blocked"] == n_layers * spans, launches
        for name in ("qkv_fused", "matmul_fused", "flash_decode_oproj",
                     "flash_attention", "matmul_blocked"):
            assert launches[name] > 0, (name, launches)
        print(f"  launches: qkv_fused {launches['qkv_fused']} = {n_layers} "
              f"layers x {calls} model calls; matmul_fused "
              f"{launches['matmul_fused']} = 3 x that; flash_decode_oproj "
              f"{launches['flash_decode_oproj']} = {n_layers} x "
              f"{snap['decode_steps']} decode steps; matmul_blocked (wo) "
              f"{launches['matmul_blocked']} = {n_layers} x {spans} joins "
              f"and chunks")
        with ops.fused_ops(True):
            fused_logits = prefill_logits(cfg, params, prompts[0])
        summary["logits_vs_cublas"] = hold_logits(
            "fused path vs cuBLAS", fused_logits,
            _cublas_logits(cfg, params, prompts[0]))
        summary["profile"] = profile_window(engine(), prompts[:8], 8)
        hold_mma_kinds(summary["profile"], ("matmul_fused", "qkv_fused"))
    return summary


def hold_mma_kinds(profile: dict, rows: tuple[str, ...],
                   instances: tuple[str, ...] = ("mma", "mma_t")) -> None:
    """Every bf16 launch of these GEMM rows (``matmul_blocked``,
    ``matmul_fused``, ``qkv_fused``, ``matmul_w8``) in a profiled window
    ran on the tensor cores: each of ``instances`` ran (in serving the
    joins on the ``mma`` instance, decode on the transposed one; a
    training step's spans on ``mma`` alone), none on the CUDA-core tile
    core."""
    kinds = profile["device_ms_by_kind"]
    assert "other (mma)" not in kinds and "other (mma_t)" not in kinds, \
        kinds   # a tensor-core instance under no row's map
    for row in rows:
        for inst in instances:
            assert kinds.get(f"{row} ({inst})", 0) > 0, (row, inst, kinds)
        assert row not in kinds and f"{row} (int8)" not in kinds, kinds
        ran = ", ".join(f"{inst} {kinds[f'{row} ({inst})']:.3f} ms"
                        for inst in instances)
        print(f"  {row} in the profiled window: {ran}, no CUDA-core launch")


def phase9_quantized(cfg, qparams, warm, prompts, kernels, fuse: bool,
                     want_fq, want_bf16) -> dict:
    """granite-3-8b with int8 projections and an fp8 page pool (w8fp8),
    the model's page and chunk, unfused (phase 9) or fused (9b), on phase
    5's requests.  Every projection runs matmul_w8 (under fuse: q, k, v
    and wo; the MLP the int8 matmul_fused) and decode flash_decode_fp8.
    The prefill logits are held against the cuBLAS path over the
    fake-quant tree (the same int8 weights, dequantized to bf16), and
    reported against the bf16 model's."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (PagedEngine, PagedServeConfig,
                                          default_buckets)
    from repro_torch.tune import best_schedule

    def engine():
        return PagedEngine(cfg, qparams, PagedServeConfig(
            max_seq=512, max_batch=8, device="cuda", fuse=fuse))

    eng = engine()
    # the w8 tiles for every M the run can give a projection, before the
    # clock starts (a search is host work the cache removes)
    t0 = time.perf_counter()
    ms = {8} | set(default_buckets(cfg, 512))
    ms |= {1 << i for i in range(eng.prefill_chunk.bit_length())}
    for m in sorted(ms):
        for n, k in GRANITE_NK:
            best_schedule("matmul_w8", (m, n, k), "bfloat16")
        if fuse:
            for _, n, k, _ in GRANITE_MLP:
                best_schedule("matmul_fused_w8", (m, n, k), "bfloat16")
    print(f"  w8 tiles derived for M in {sorted(ms)} in "
          f"{time.perf_counter() - t0:.1f}s; page {eng.page_size} and chunk "
          f"{eng.prefill_chunk} under flash_decode_fp8, kv "
          f"{str(eng.cache['k_pages'].dtype).removeprefix('torch.')}")
    engine().generate(warm, 4)
    summary, snap = run_engine(cfg, eng, prompts, kernels, fused=fuse)
    launches, n_layers = summary["launches"], cfg.n_layers
    calls = snap["joins"] + snap["decode_steps"] + snap["prefill_chunks"]
    assert launches["flash_decode_fp8"] == \
        n_layers * (snap["decode_steps"] + snap["prefill_chunks"]), launches
    w8_per_call = 4 if fuse else 7
    assert launches["matmul_w8"] == w8_per_call * n_layers * calls, launches
    assert launches["matmul_fused"] == \
        (3 * n_layers * calls if fuse else 0), launches
    for name in ("qkv_fused", "flash_decode_oproj", "flash_decode",
                 "matmul_blocked"):
        assert launches[name] == 0, (name, launches)
    print(f"  launches: matmul_w8 {launches['matmul_w8']} = {w8_per_call} "
          f"projections x {n_layers} layers x {calls} model calls; "
          f"matmul_fused (int8) {launches['matmul_fused']}; "
          f"flash_decode_fp8 {launches['flash_decode_fp8']} = {n_layers} x "
          f"{snap['decode_steps'] + snap['prefill_chunks']} decode steps "
          f"and chunks")
    with ops.fused_ops(fuse):
        got = prefill_logits(cfg, qparams, prompts[0])
    summary["logits_vs_fake_quant_cublas"] = hold_logits(
        "w8 kernels vs cuBLAS over the fake-quant tree", got, want_fq)
    dev_ = float((got - want_bf16).abs().max())
    scale = float(want_bf16.abs().max())
    same = int(got.argmax()) == int(want_bf16.argmax())
    print(f"  quantization's own effect: w8 logits vs the bf16 model's "
          f"(cuBLAS): max |diff| {dev_:.3e} of max |logit| {scale:.3e} "
          f"({100 * dev_ / scale:.2f}%); argmax "
          f"{'agrees' if same else 'differs'} (reported, not a check)")
    assert bool(torch.isfinite(got).all())
    summary["logits_vs_bf16_model"] = {"max_abs_diff": dev_,
                                       "max_abs_logit": scale,
                                       "argmax_agrees": same}
    summary["profile"] = profile_window(engine(), prompts[:8], 8)
    hold_mma_kinds(summary["profile"],
                   ("matmul_fused", "matmul_w8") if fuse else ("matmul_w8",))
    return summary


def _cublas_logits(cfg, params, prompt):
    from repro_torch.kernels import ops
    with ops.blocked_linear(False):
        return prefill_logits(cfg, params, prompt)


def phase7_tune() -> dict:
    """tune_op on the decode projection shape, the decode QKV pass and
    the paper's Conv4 (one image), into a temporary cache."""
    import tempfile
    from repro_torch.tune import OpSpec, ScheduleCache, candidates, tune_op
    from repro_torch.tune.measure import measure_top
    out = {}
    for spec in (OpSpec("matmul", (8, 4096, 4096), "bfloat16"),
                 OpSpec("qkv_fused", (8, 1024, 4096, 4), "bfloat16"),
                 OpSpec("conv2d", (56, 56, 128, 256, 3, 3), "bfloat16")):
        with tempfile.TemporaryDirectory() as tmp:
            cache = ScheduleCache(str(Path(tmp) / "schedules.json"))
            winner = tune_op(spec.op, spec.dims, spec.dtype, top_n=3,
                             cache=cache, stride=spec.stride)
            stored = ScheduleCache(cache.path).lookup(spec)
            assert stored is not None and stored.tiles == winner.tiles
        timed = measure_top(candidates(spec), top_n=3)
        for s in timed[:3]:
            print(f"  {spec.op} tiles {s.tiles}: {s.measured_us / 1e3:.4f} "
                  f"ms measured, predicted DRAM accesses "
                  f"{s.predicted_dram_accesses}")
        print(f"  {spec.op} {spec.dims}: tune_op winner {winner.tiles} "
              f"({winner.measured_us / 1e3:.4f} ms), persisted and read "
              f"back")
        out[spec.op] = {"winner": list(winner.tiles),
                        "candidates": [{"tiles": list(s.tiles),
                                        "ms": s.measured_us / 1e3,
                                        "predicted_dram_accesses":
                                            s.predicted_dram_accesses}
                                       for s in timed[:3]]}
    return out


def kernel_kind(name: str) -> str:
    import re
    if "gemm_kernel" in name:       # the port's GEMM tile core
        if "QkvMap" in name:
            return "qkv_fused"
        if "W8Map" in name:
            return "matmul_w8"
        if "FusedMap" in name:
            return ("matmul_fused (int8)" if "signed char" in name
                    else "matmul_fused")
        return "matmul_blocked"
    inst = re.search(r"\bmma(_t)?_kernel<", name)   # gemm_mma_inst.cuh
    if inst:   # the bf16 instances of rows 6, 9, 10 and 11, by their map
        row = ("qkv_fused" if "QkvBlocks" in name else
               "matmul_w8" if "W8Map" in name else
               "matmul_blocked" if "BlockedMap" in name else
               "matmul_fused" if "FusedMap" in name else "other")
        return f"{row} ({'mma_t' if inst.group(1) else 'mma'})"
    if "decode_oproj_kernel" in name:
        return "flash_decode_oproj"
    if "fwd_mma_kernel" in name:
        return "flash_attention (mma)"
    if "attn_rows_kernel" in name:
        if "PagedLayout" not in name:
            return "flash_attention"
        return ("flash_decode_fp8" if "unsigned char" in name
                else "flash_decode")
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


def time_kernels(cfg, lens, launches, page: int) -> list[dict]:
    """Each kernel at the shapes of the blocked run (phase 6), beside its
    plain version, its bound and (where one exists) one library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import matmul_blocked as MB
    from repro_torch.tune import best_schedule
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = []

    # decode: 8 slots, each mid-generation (prompt + 16 tokens), at the
    # model's page; page 64 (the cuBLAS run's) for the first slice's row
    dec_lens = [int(n) + 16 for n in lens[:8]]
    n_keys = sum(dec_lens)
    kv_bytes = 2 * n_keys * hkv * d * 2
    for p in (page, 64) if page != 64 else (page,):
        args = paged_inputs(dev, bf16, dec_lens, 1, seed=5, page=p,
                            n_blocks=-(-512 // p))
        io_bytes = 2 * args[0].numel() * 2 + args[3].numel() * 4 + 4 * 8
        b_ms, b_by = bound(kv_bytes + io_bytes, 4 * n_keys * hq * d)
        row = {
            "name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:233",
            "launches": launches["flash_decode"],
            "max_abs_err": float((FD.flash_decode(*args).float()
                                  - FD.paged_attention_ref(*args).float())
                                 .abs().max()),
            "ms": time_ms(lambda: FD.flash_decode(*args)),
            "plain_ms": time_ms(lambda: FD.paged_attention_ref(*args)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"decode B=8 Hkv={hkv} G={hq // hkv} D={d} page={p} "
                     f"lengths={dec_lens} bf16"}
        if p == page:
            out.append(row)
        else:
            print(f"  flash_decode at page {p} (the cuBLAS run's): "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")

    # chunked prefill: the third 64-token chunk of a 300-token prompt
    cargs = paged_inputs(dev, bf16, [129], 64, seed=6, page=page,
                         n_blocks=-(-512 // page))
    n_pairs = sum(129 + t for t in range(64))     # causal (row, key) pairs
    c_bytes = 2 * (129 + 63) * hkv * d * 2 + 2 * cargs[0].numel() * 2
    cb_ms, cb_by = bound(c_bytes, 4 * n_pairs * hq * d)
    c_ms = time_ms(lambda: FD.flash_decode(*cargs, q_span=64))
    cp_ms = time_ms(lambda: FD.paged_attention_ref(*cargs, q_span=64))
    print(f"  flash_decode chunk (q_span=64, cache 129..192, page {page}): "
          f"{c_ms:.4f} ms, plain {cp_ms:.4f} ms, bound {cb_ms:.4f} ms "
          f"({cb_by})")

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
        "ms": time_ms(lambda: FA.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: FA.flash_attention_ref(q, k, v)),
        "bound_ms": fb_ms, "bound_by": fb_by,
        "library_ms": time_ms(lib),
        "shape": f"join B=1 Sq=Skv=64 Hq={hq} Hkv={hkv} D={d} causal bf16, "
                 f"instance {FA.flash_attention.instance}"})
    print(f"  scaled_dot_product_attention vs flash_attention: max |diff| "
          f"{lib_err:.3e}")
    attn_line(out[-1], 4 * (64 * 65 // 2) * hq * d,
              FA.flash_attention.instance[1:])

    # the projections: decode (M = 8 slots) at each of granite's four
    # shapes, and a 512-token join, with the model's tiles
    gemms = []
    for m, (n, k) in [(8, nk) for nk in GRANITE_NK] + [(512, (4096, 4096))]:
        a, b = gemm_inputs(dev, bf16, m, n, k, seed=m + n + k)
        bm, bk, bn = best_schedule("matmul", (m, n, k), "bfloat16").tiles
        b_ms, b_by = bound((m * k + k * n + m * n) * 2, 2 * m * n * k)
        gemms.append({
            "name": "matmul_blocked", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul_blocked.cu",
            "replaces": "src/repro/kernels/matmul_blocked.py:91",
            "launches": launches["matmul_blocked"],
            "max_abs_err": float((MB.matmul_blocked(a, b, bm=bm, bk=bk,
                                                    bn=bn).float()
                                  - MB.matmul_ref(a, b).float())
                                 .abs().max()),
            "ms": time_ms(lambda: MB.matmul_blocked(a, b, bm=bm, bk=bk,
                                                    bn=bn)),
            "plain_ms": time_ms(lambda: MB.matmul_ref(a, b)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.matmul(a, b)),
            "shape": f"M={m} N={n} K={k} tiles={(bm, bk, bn)} bf16"})
        gemm_instance(gemms[-1], MB.matmul_blocked, m, -(-n // bn), bm)
    out.append(gemms[0])
    for r in out + gemms[1:]:
        print(f"  {r['name']:<16} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"library {r['library_ms']}  [{r['shape']}]")
    return out


def gemm_instance(row: dict, fn, m: int, col_blocks: int, bm: int) -> None:
    """The instance a GEMM wrapper ran (``fn.instance``: the kind, its
    warp grid or fragment counts, its stages; rows 6, 9, 10 and 11) and its
    block count, on the timed row and its shape; a bf16 launch runs on
    the tensor cores."""
    kind, layout, stages = fn.instance
    assert kind in ("mma", "mma_t"), fn.instance
    blocks = col_blocks * (1 if kind == "mma_t" else -(-m // bm))
    row["instance"], row["blocks"] = [kind, layout, stages], blocks
    row["shape"] += f"; {kind} {layout} stages={stages}, {blocks} blocks"


def time_fused_kernels(cfg, lens, launches, page: int) -> list[dict]:
    """The three fused kernels at the fused run's decode shapes (8 slots,
    the model's tiles and page), beside bound, plain version and (where
    one exists) a library call; the join shape (M = 512) is printed."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import qkv_fused as QF
    from repro_torch.tune import best_schedule
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    hq, hkv, d, e = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    g, nkv = hq // hkv, cfg.n_kv_heads * cfg.head_dim
    rows = []

    # decode attention + output projection: 8 slots mid-generation
    dec_lens = [int(n) + 16 for n in lens[:8]]
    n_keys = sum(dec_lens)
    args = oproj_inputs(dev, bf16, dec_lens, seed=8, page=page)
    wo_bytes = args[5].numel() * 2
    io = (args[0].numel() + 8 * e) * 2 + args[3].numel() * 4 + 4 * 8
    b_ms, b_by = bound(2 * n_keys * hkv * d * 2 + wo_bytes + io,
                       4 * n_keys * hq * d + 2 * 8 * hq * d * e)
    # the yardstick: the unfused pair, row 1 then one library GEMM over
    # the flattened heads (not one call, so not library_ms)
    q, kp, vp, bt, ln, wo = args
    wo2 = wo.reshape(hq * d, e)
    pair_ms = time_ms(lambda: torch.matmul(
        FD.flash_decode(q, kp, vp, bt, ln).reshape(8, hq * d), wo2))
    width, n_slices, cluster = FD.oproj_grid(hkv, e)
    rows.append({
        "name": "flash_decode_oproj", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode_oproj.cu",
        "replaces": "src/repro/kernels/flash_decode.py:460",
        "launches": launches["flash_decode_oproj"],
        "max_abs_err": float((FD.flash_decode_oproj(*args).float()
                              - FD.paged_attention_oproj_ref(*args).float())
                             .abs().max()),
        "ms": time_ms(lambda: FD.flash_decode_oproj(*args)),
        "plain_ms": time_ms(lambda: FD.paged_attention_oproj_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"decode B=8 Hkv={hkv} G={g} D={d} E={e} page={page} "
                 f"lengths={dec_lens} bf16; {n_slices} slices of {width} x "
                 f"{hkv} heads = {n_slices * hkv} blocks, cluster "
                 f"{cluster}"})
    print(f"  flash_decode_oproj {rows[-1]['ms']:.4f} ms; the unfused pair "
          f"(flash_decode, then torch.matmul over the heads) {pair_ms:.4f} "
          f"ms; plain {rows[-1]['plain_ms']:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}); global bytes of the call "
          f"{FD.oproj_hbm_bytes(8, hkv, g, d, e, max(dec_lens), page)}")

    # the MLP's three fused GEMMs; the row is the down projection, whose
    # residual add torch.addmm computes in the same call
    for m in (8, 512):
        for name, n, k, epi in GRANITE_MLP:
            a, w = gemm_inputs(dev, bf16, m, n, k, seed=m + n + k)
            kw = epilogue(dev, bf16, m, n, seed=m, **epi)
            bm, bk, bn = best_schedule("matmul_fused", (m, n, k),
                                       "bfloat16").tiles
            extra = m * n * 2 * (kw["mul"] is not None
                                 or kw["residual"] is not None)
            b_ms, b_by = bound((m * k + k * n + m * n) * 2 + extra,
                               2 * m * n * k)
            if kw["residual"] is not None:
                res = kw["residual"]
                lib = lambda: torch.addmm(res, a, w)  # noqa: E731
            else:
                lib = lambda: torch.matmul(a, w)  # noqa: E731
            row = {
                "name": "matmul_fused", "route": "cuda",
                "source": "src/repro_torch/csrc/matmul_fused.cu",
                "replaces": "src/repro/kernels/matmul_fused.py:173",
                "launches": launches["matmul_fused"],
                "max_abs_err": float(
                    (MF.matmul_fused(a, w, **kw, bm=bm, bk=bk, bn=bn)
                     .float() - MF.matmul_fused_ref(a, w, **kw).float())
                    .abs().max()),
                "ms": time_ms(lambda: MF.matmul_fused(a, w, **kw, bm=bm,
                                                      bk=bk, bn=bn)),
                "plain_ms": time_ms(lambda: MF.matmul_fused_ref(a, w, **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib),
                "shape": f"{name} M={m} N={n} K={k} "
                         f"{ {x: y for x, y in epi.items()} } tiles="
                         f"{(bm, bk, bn)} bf16; library: "
                         f"{'addmm(residual, a, w)' if name == 'down' else 'matmul(a, w), no epilogue'}"}
            gemm_instance(row, MF.matmul_fused, m, -(-n // bn), bm)
            if m == 8 and name == "down":
                rows.append(row)
            else:
                print(f"  matmul_fused {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms "
                      f"({b_by})  library {row['library_ms']:.4f} ms  "
                      f"[{row['shape']}]")

    # the QKV pass; yardstick: one matmul against [wq | wk | wv]
    for m in (8, 512):
        x, wq, wk, wv = qkv_inputs(dev, bf16, m, nkv, e, g, seed=m)
        wqkv = torch.cat([wq, wk, wv], dim=1)
        bm, bk, bn = best_schedule("qkv_fused", (m, nkv, e, g),
                                   "bfloat16").tiles
        cols = (g + 2) * nkv
        b_ms, b_by = bound((m * e + e * cols + m * cols) * 2,
                           2 * m * e * cols)
        got = QF.qkv_fused(x, wq, wk, wv, bm=bm, bk=bk, bn=bn)
        row = {
            "name": "qkv_fused", "route": "cuda",
            "source": "src/repro_torch/csrc/qkv_fused.cu",
            "replaces": "src/repro/kernels/qkv_fused.py:103",
            "launches": launches["qkv_fused"],
            "max_abs_err": max(float((o.float() - r.float()).abs().max())
                               for o, r in zip(got, QF.qkv_fused_ref(
                                   x, wq, wk, wv))),
            "ms": time_ms(lambda: QF.qkv_fused(x, wq, wk, wv, bm=bm, bk=bk,
                                               bn=bn)),
            "plain_ms": time_ms(lambda: QF.qkv_fused_ref(x, wq, wk, wv)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.matmul(x, wqkv)),
            "shape": f"M={m} Nkv={nkv} K={e} G={g} tiles={(bm, bk, bn)} "
                     f"bf16; library: matmul(x, [wq|wk|wv])"}
        gemm_instance(row, QF.qkv_fused, m, QF.blocks(nkv, g, bn), bm)
        if m == 8:
            rows.append(row)
        else:
            print(f"  qkv_fused {row['ms']:.4f} ms  plain "
                  f"{row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                  f"library {row['library_ms']:.4f} ms  [{row['shape']}]")
    for r in rows:
        print(f"  {r['name']:<18} {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']}  "
              f"[{r['shape']}]")
    return rows


def time_quant_kernels(cfg, lens, launches9, launches9b,
                       page: int) -> list[dict]:
    """The three quantized kernels at the decode shapes of phases 9 and
    9b (8 slots, the model's w8 tiles and fp8 page), beside bound, plain
    version and a library call.  No single PyTorch call computes an
    int8-weight product, so the yardstick of the two GEMMs is
    ``torch.matmul`` (``addmm`` with the residual) against the bf16
    weight: the wide reference, which reads twice the weight bytes."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import matmul_q as MQ
    from repro_torch.tune import best_schedule
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = []

    # decode over the fp8 pool: 8 slots mid-generation, the fp8 page
    dec_lens = [int(n) + 16 for n in lens[:8]]
    n_keys = sum(dec_lens)
    args = fp8_paged(paged_inputs(dev, torch.float32, dec_lens, 1, seed=9,
                                  page=page, n_blocks=-(-512 // page)),
                     seed=9)
    args = (args[0].to(bf16),) + args[1:]
    kv_bytes = 2 * n_keys * hkv * d * 1
    io = 2 * args[0].numel() * 2 + args[5].numel() * 4 + 4 * 8 + 2 * 4 * hkv
    b_ms, b_by = bound(kv_bytes + io, 4 * n_keys * hq * d)
    rows.append({
        "name": "flash_decode_fp8", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode_fp8.cu",
        "replaces": "src/repro/kernels/flash_decode.py:295",
        "launches": launches9["flash_decode_fp8"],
        "max_abs_err": float((FD.flash_decode_fp8(*args).float()
                              - FD.paged_attention_fp8_ref(*args).float())
                             .abs().max()),
        "ms": time_ms(lambda: FD.flash_decode_fp8(*args)),
        "plain_ms": time_ms(lambda: FD.paged_attention_fp8_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"decode B=8 Hkv={hkv} G={hq // hkv} D={d} page={page} "
                 f"lengths={dec_lens} (sum {n_keys}) q bf16, pages "
                 f"float8_e4m3fn, unit scales; phase 9b launches "
                 f"{launches9b['flash_decode_fp8']}"})

    # matmul_w8: the decode projections (M = 8) at granite's four shapes
    # and a 512-token join, the model's w8 tiles
    gemms = []
    for m, (n, k) in [(8, nk) for nk in GRANITE_NK] + [(512, (4096, 4096))]:
        a, qw = w8_inputs(dev, bf16, m, n, k, seed=m + n + k)
        wide = qw.dequant(bf16)
        bm, bk, bn = best_schedule("matmul_w8", (m, n, k), "bfloat16").tiles
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                           2 * m * n * k)
        gemms.append({
            "name": "matmul_w8", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul_w8.cu",
            "replaces": "src/repro/kernels/matmul_q.py:90",
            "launches": launches9["matmul_w8"],
            "max_abs_err": float(
                (MQ.matmul_w8(a, qw.q, qw.scale, bm=bm, bk=bk, bn=bn)
                 .float() - MQ.matmul_w8_ref(a, qw.q, qw.scale).float())
                .abs().max()),
            "ms": time_ms(lambda: MQ.matmul_w8(a, qw.q, qw.scale, bm=bm,
                                               bk=bk, bn=bn)),
            "plain_ms": time_ms(lambda: MQ.matmul_w8_ref(a, qw.q,
                                                         qw.scale)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.matmul(a, wide)),
            "shape": f"M={m} N={n} K={k} tiles={(bm, bk, bn)} A bf16, W "
                     f"int8, per-channel scale; library: torch.matmul "
                     f"against the bf16 weight (the wide reference); "
                     f"phase 9b launches {launches9b['matmul_w8']}"})
        gemm_instance(gemms[-1], MQ.matmul_w8, m, -(-n // bn), bm)
    rows.append(gemms[0])
    for r in gemms[1:]:
        print(f"  matmul_w8 {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  library "
              f"{r['library_ms']:.4f} ms  [{r['shape']}]")

    # the int8 matmul_fused: granite's MLP at decode and a join; the row
    # is the down projection with its residual
    for m in (8, 512):
        for name, n, k, epi in GRANITE_MLP:
            a, qw = w8_inputs(dev, bf16, m, n, k, seed=m + n + k)
            wide = qw.dequant(bf16)
            kw = epilogue(dev, bf16, m, n, seed=m, **epi)
            kw["scale"] = qw.scale.reshape(-1)
            bm, bk, bn = best_schedule("matmul_fused_w8", (m, n, k),
                                       "bfloat16").tiles
            extra = m * n * 2 * (kw["mul"] is not None
                                 or kw["residual"] is not None)
            b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2 + extra,
                               2 * m * n * k)
            if kw["residual"] is not None:
                res = kw["residual"]
                lib = lambda: torch.addmm(res, a, wide)  # noqa: E731
            else:
                lib = lambda: torch.matmul(a, wide)  # noqa: E731
            row = {
                "name": "matmul_fused (int8)", "route": "cuda",
                "source": "src/repro_torch/csrc/matmul_fused.cu",
                "replaces": "src/repro/kernels/matmul_fused.py:173",
                "launches": launches9b["matmul_fused"],
                "max_abs_err": float(
                    (MF.matmul_fused(a, qw.q, **kw, bm=bm, bk=bk, bn=bn)
                     .float() - MF.matmul_fused_ref(a, qw.q, **kw).float())
                    .abs().max()),
                "ms": time_ms(lambda: MF.matmul_fused(a, qw.q, **kw, bm=bm,
                                                      bk=bk, bn=bn)),
                "plain_ms": time_ms(lambda: MF.matmul_fused_ref(a, qw.q,
                                                                **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib),
                "shape": f"{name} M={m} N={n} K={k} {epi} tiles="
                         f"{(bm, bk, bn)} A bf16, W int8; library: "
                         + ("addmm(residual, a, w_bf16)" if name == "down"
                            else "matmul(a, w_bf16), no epilogue")}
            gemm_instance(row, MF.matmul_fused, m, -(-n // bn), bm)
            if m == 8 and name == "down":
                rows.append(row)
            else:
                print(f"  matmul_fused (int8) {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms "
                      f"({b_by})  library {row['library_ms']:.4f} ms  "
                      f"[{row['shape']}]")
    for r in rows:
        print(f"  {r['name']:<20} {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']}  "
              f"[{r['shape']}]")
    return rows


# ------------------------------ training ------------------------------------


def grad_tol(dtype_name: str, reduce: int, ref) -> tuple[float, float]:
    """(abs, rel) tolerance of a gradient against its plain version: a
    ``reduce``-term sum in another order, on the scale of the largest
    |value| (the phase-3 fp32 GEMM rule, ``gemm_atol``, times that
    scale); bf16 keeps its output rounding, on the same scale."""
    scale = max(1.0, float(ref.float().abs().max()))
    if dtype_name == "float32":
        return gemm_atol("float32", reduce) * scale, TOL["float32"][1]
    return TOL["bfloat16"][0] * scale, TOL["bfloat16"][1]


def phase3_train(dev) -> None:
    """The training path's kernels against their plain versions: the
    dgrad GEMMs at ragged shapes and under every "matmul_dgrad" adapter
    tile of granite's projections at M = 2048 tokens, the forward's lse
    residual and the attention backward (GQA 32/8, D = 128 and a D = 64
    case; ragged S, Sq < Skv, window, cap), repeated launches bit for
    bit."""
    import torch
    from repro_torch.core.hopper_adapter import backward_tile_candidates
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import matmul_bwd as MW
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]

        def dgrad_pair(m, n, k, seed):
            """a (m, k), b (k, n) and the cotangents of C = a @ b scaled
            so dA = g @ b^T and dB = a^T @ g are O(1)."""
            gen = torch.Generator(device=dev).manual_seed(seed)
            r = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                       device=dev)
            a, b, g = r(m, k), r(k, n) * n ** -0.5, r(m, n)
            return (a.to(dtype), b.to(dtype), g.to(dtype),
                    (g * m ** -0.5).to(dtype))

        kind = MW.instance_kind(dtype)   # bf16: "mma", fp32: "fma"

        def check_dgrad(tag, m, n, k, tiles_a, tiles_b, seed):
            a, b, g, gb = dgrad_pair(m, n, k, seed)
            if tiles_a is not None:
                t0, t1, t2 = tiles_a
                da = MW.matmul_dgrad_a(g, b, bm=t0, br=t1, bo=t2)
                assert MW.matmul_dgrad_a.instance[0] == kind, \
                    MW.matmul_dgrad_a.instance
                compare(f"matmul_dgrad_a {dn} {tag} tiles={tiles_a}", da,
                        MW.matmul_dgrad_a_ref(g, b), dn, gemm_atol(dn, n))
                assert torch.equal(da, MW.matmul_dgrad_a(g, b, bm=t0, br=t1,
                                                         bo=t2))
            if tiles_b is not None:
                t0, t1, t2 = tiles_b
                db = MW.matmul_dgrad_b(a, gb, bk=t0, br=t1, bn=t2)
                assert MW.matmul_dgrad_b.instance[0] == kind, \
                    MW.matmul_dgrad_b.instance
                compare(f"matmul_dgrad_b {dn} {tag} tiles={tiles_b}", db,
                        MW.matmul_dgrad_b_ref(a, gb), dn, gemm_atol(dn, m))
                assert torch.equal(db, MW.matmul_dgrad_b(a, gb, bk=t0, br=t1,
                                                         bn=t2))
        # ragged M, N and K (scalar and 16-byte staging paths), a tile
        # off the default warp grid, and in bf16 both stage counts
        for m, n, k, tiles in ((37, 1000, 300, (16, 64, 64)),
                               (50, 100, 70, (32, 48, 64)),
                               (3, 5, 7, (3, 64, 64)),
                               (520, 4104, 4100, (128, 64, 128)),
                               (2048, 4096, 1024, (80, 64, 128))):
            check_dgrad(f"M={m} N={n} K={k}", m, n, k, tiles, tiles, m + n)
        if kind == "mma":
            a, b, g, gb = dgrad_pair(520, 4104, 4100, 7)
            for st in (2, 3):
                da = MW.matmul_dgrad_a(g, b, bm=128, br=64, bo=128,
                                       stages=st)
                db = MW.matmul_dgrad_b(a, gb, bk=128, br=64, bn=128,
                                       stages=st)
                assert MW.matmul_dgrad_a.instance[2] == st
                compare(f"matmul_dgrad_a {dn} M=520 stages={st}", da,
                        MW.matmul_dgrad_a_ref(g, b), dn)
                compare(f"matmul_dgrad_b {dn} M=520 stages={st}", db,
                        MW.matmul_dgrad_b_ref(a, gb), dn)
        # every "matmul_dgrad" adapter tile of granite's projections at
        # 2048 tokens: dA asks (M, K, N), dB (K, N, M)
        m, n_tiles = 2048, 0
        for n, k in GRANITE_NK:
            esz = dtype.itemsize
            cand_a = backward_tile_candidates("matmul_dgrad", (m, k, n), esz)
            cand_b = backward_tile_candidates("matmul_dgrad", (k, n, m), esz)
            for i in range(max(len(cand_a), len(cand_b))):
                check_dgrad(f"M={m} N={n} K={k}", m, n, k,
                            cand_a[i] if i < len(cand_a) else None,
                            cand_b[i] if i < len(cand_b) else None, n + k)
            n_tiles += len(cand_a) + len(cand_b)
        print(f"  {n_tiles} dgrad adapter tiles checked in {dn} on the "
              f"{kind!r} instance")

        # attention at the tensor-core instances' edges, forward lse and
        # backward
        for case in ATTN_EDGES:
            check_attention_edge(dev, dtype, *case, with_bwd=True)
        # attention: forward lse and the backward kernel on the same
        # (o, lse); the phase-11 shape (4, 512) and its neighbours
        for b, sq, skv, hq, hkv, d, window, cap in (
                (1, 64, 64, 32, 8, 128, None, None),
                (4, 512, 512, 32, 8, 128, None, None),
                (2, 100, 100, 32, 8, 128, None, None),
                (2, 40, 104, 32, 8, 128, None, None),
                (2, 128, 128, 32, 8, 128, 48, None),
                (2, 96, 96, 32, 8, 128, None, 30.0),
                (2, 128, 128, 8, 2, 64, None, None)):
            q, k, v = dense_inputs(dev, dtype, b, sq, skv, seed=sq + skv,
                                   hq=hq, hkv=hkv, d=d)
            g = dense_inputs(dev, dtype, b, sq, sq, seed=sq, hq=hq, hkv=hq,
                             d=d)[0]
            kw = dict(window=window, logit_cap=cap)
            tag = (f"{dn} B={b} Sq={sq} Skv={skv} Hq/Hkv={hq}/{hkv} D={d} "
                   f"window={window} cap={cap}")
            o, lse = FA._forward(q, k, v, True, window, cap, with_lse=True)
            compare(f"flash_attention lse {tag}", lse,
                    FA.flash_attention_lse_ref(q, k, **kw), "float32",
                    atol=1e-4)
            got = FB.flash_attention_bwd(q, k, v, o, lse, g, **kw)
            want = FB.flash_attention_bwd_ref(q, k, v, o, lse, g, **kw)
            for name, x, y, n_red in (("dq", got[0], want[0], skv),
                                      ("dk", got[1], want[1],
                                       sq * hq // hkv),
                                      ("dv", got[2], want[2],
                                       sq * hq // hkv)):
                atol, _ = grad_tol(dn, n_red, y)
                compare(f"flash_attention_bwd {name} {tag}", x, y, dn,
                        atol=atol)
            again = FB.flash_attention_bwd(q, k, v, o, lse, g, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), tag
    torch.cuda.synchronize()


def train_one_step(cfg, params, batch, *, blocked: bool, use_kernel: bool,
                   opt=None, want_grads: bool = False):
    """One ``make_train_step`` on a fresh AdamW state; returns (metrics,
    grads or None).  ``want_grads``: also the gradients, from the step's
    own loss function (``train.loop._value_and_grad``) on the same
    inputs."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    tc = loop.TrainConfig(opt=opt or adamw.AdamWConfig(),
                          blocked_linear=blocked, use_kernel=use_kernel)
    grads = None
    if want_grads:
        _, grads = loop._value_and_grad(loop.make_loss(cfg, tc), params,
                                        batch)
    _, _, metrics = loop.make_train_step(cfg, tc)(
        params, adamw.init_state(params), batch)
    return metrics, grads


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "matmul_blocked",
                 "matmul_dgrad_a", "matmul_dgrad_b")


def phase10_train_parity(seed: int, kernels: dict) -> dict:
    """granite-3-8b width, 2 layers, fp32, one --seed tree: one
    ``make_train_step`` on the kernel path (blocked linears, so kernel
    rows 4-8 all run) and on the plain path (``use_kernel=False``);
    loss, grad norm and every gradient leaf agree, the plain path
    launches nothing, the kernel path every training kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import leaves
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype=torch.float32)
    params = T.init_params(cfg, seed=seed, device="cuda")
    batch = make_batch(cfg, 128, 2, 0, seed=seed, device="cuda")
    reset(kernels)
    km, kg = train_one_step(cfg, params, batch, blocked=True,
                            use_kernel=True, want_grads=True)
    torch.cuda.synchronize()
    launched = counts(kernels)
    pm, pg = train_one_step(cfg, params, batch, blocked=True,
                            use_kernel=False, want_grads=True)
    torch.cuda.synchronize()
    assert counts(kernels) == launched, "the plain path launched a kernel"
    assert min(launched[k] for k in TRAIN_KERNELS) > 0, launched
    others = {k: n for k, n in launched.items() if k not in TRAIN_KERNELS}
    assert not any(others.values()), others
    n_tok = batch["tokens"].numel()
    for key in ("loss", "grad_norm"):
        compare(f"train step {key}", km[key].reshape(1), pm[key].reshape(1),
                "float32", atol=gemm_atol("float32", n_tok))
    worst = 0.0
    for i, (x, y) in enumerate(zip(leaves(kg), leaves(pg))):
        atol, rtol = grad_tol("float32", n_tok, y)
        err = float((x.float() - y.float()).abs().max())
        ok = bool(torch.all((x.float() - y.float()).abs()
                            <= atol + rtol * y.float().abs()))
        worst = max(worst, err / max(1.0, float(y.abs().max())))
        assert ok, f"gradient leaf {i} {tuple(x.shape)}: {err:.3e}"
    print(f"  {len(leaves(kg))} gradient leaves agree (worst max |diff|"
          f" {worst:.3e} of the leaf's scale); loss {float(km['loss']):.6f}"
          f" vs {float(pm['loss']):.6f}, grad norm "
          f"{float(km['grad_norm']):.6f} vs {float(pm['grad_norm']):.6f}; "
          f"kernel launches { {k: launched[k] for k in TRAIN_KERNELS} }")
    out = {"loss": [float(km["loss"]), float(pm["loss"])],
           "grad_norm": [float(km["grad_norm"]), float(pm["grad_norm"])],
           "worst_leaf_rel": worst, "launches": launched}
    del params, kg, pg
    torch.cuda.empty_cache()
    return out


def train_profile(step_fn, params, state, batch) -> dict:
    """Device busy share and top kernels of one traced train step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = step_fn(params, state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    kinds: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        kind = train_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, e.count, e.key[:90]))
    busy = sum(kinds.values()) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
           "device_ms_by_kind": {k: v / 1e3 for k, v in sorted(kinds.items())},
           "top": [{"ms": us / 1e3, "count": c, "name": n}
                   for us, c, n in sorted(top, reverse=True)[:8]]}
    print(f"  profiled step: wall {wall:.3f}s, device busy {busy:.3f}s "
          f"({100 * busy / wall:.1f}%), by kind (ms) "
          f"{ {k: round(v, 3) for k, v in out['device_ms_by_kind'].items()} }")
    for t in out["top"]:
        print(f"    {t['ms']:9.3f} ms  x{t['count']:<6} {t['name']}")
    return out


def train_kind(name: str) -> str:
    """``kernel_kind`` plus the training kernels (csrc/matmul_bwd.cu's
    nt/tn kernels, csrc/flash_attention_bwd.cu's dq/dkv kernels: the
    CUDA-core fp32 ones and the tensor-core bf16 ones, "(mma)")."""
    if "::nt_kernel<" in name:
        return "matmul_dgrad_a"
    if "::tn_kernel<" in name:
        return "matmul_dgrad_b"
    if "::nt_mma_kernel<" in name:
        return "matmul_dgrad_a (mma)"
    if "::tn_mma_kernel<" in name:
        return "matmul_dgrad_b (mma)"
    if "::dq_kernel<" in name or "::dkv_kernel<" in name:
        return "flash_attention_bwd"
    if "::dq_mma_kernel<" in name or "::dkv_mma_kernel<" in name:
        return "flash_attention_bwd (mma)"
    return kernel_kind(name)


def phase11_train(seed: int, kernels: dict) -> dict:
    """granite-3-8b at full width, depth cut to 4 of 40 layers, bf16,
    remat "block", batch 4 x seq 512 from ``make_batch``, 8 steps at
    lr 3e-3 with ``launch.train``'s warmup: on the default path (cuBLAS
    projections, flash-attention kernels forward and backward) and with
    blocked kernels; step 0 of each held against the plain path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import matmul_blocked as MB
    from repro_torch.kernels import matmul_bwd as MW
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    leaves = adamw.leaves
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4,
                              remat="block")
    steps, seq, bsz = 8, 512, 4
    t0 = time.perf_counter()
    params0 = T.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in leaves(params0))
    print(f"  init {n_par / 1e9:.3f} B params ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) in "
          f"{time.perf_counter() - t0:.1f}s")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=min(20, steps // 5),
                            total_steps=steps)
    batches = [make_batch(cfg, seq, bsz, s, seed=seed, device="cuda")
               for s in range(steps)]
    plain, _ = train_one_step(cfg, params0, batches[0], blocked=False,
                              use_kernel=False, opt=opt)
    print(f"  plain path step 0: loss {float(plain['loss']):.5f}, grad norm "
          f"{float(plain['grad_norm']):.5f}")
    out = {"params": n_par, "plain_step0": {k: float(plain[k]) for k in
                                            ("loss", "grad_norm")}}
    for name, blocked in (("default", False), ("blocked", True)):
        tc = loop.TrainConfig(opt=opt, blocked_linear=blocked)
        step_fn = loop.make_train_step(cfg, tc)
        params, state = params0, adamw.init_state(params0)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        hist = []
        for s, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            hist.append({"step": s, "loss": loss,
                         "grad_norm": float(m["grad_norm"]), "ms": dt * 1e3,
                         "tokens_per_s": bsz * seq / dt})
            print(f"  {name} step {s}: loss {loss:.5f} grad norm "
                  f"{hist[-1]['grad_norm']:.5f} {dt * 1e3:.1f} ms "
                  f"{bsz * seq / dt:.0f} tok/s")
            assert np.isfinite(loss), (name, s, loss)
        launched = counts(kernels)
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = ("flash_attention", "flash_attention_bwd") + (
            ("matmul_blocked", "matmul_dgrad_a", "matmul_dgrad_b")
            if blocked else ())
        assert min(launched[k] for k in want) > 0, (name, launched)
        assert not any(n for k, n in launched.items() if k not in want), \
            (name, launched)
        # bf16: a few roundings of 2^-8 compounded through 4 layers
        for key, dtol in (("loss", 2e-2), ("grad_norm", 5e-2)):
            got, ref = hist[0][key], float(plain[key])
            print(f"  {name} step 0 {key} {got:.5f} vs plain {ref:.5f} "
                  f"(rel {abs(got - ref) / abs(ref):.2e}, bound {dtol:g})")
            assert abs(got - ref) <= dtol * abs(ref), (name, key, got, ref)
        steady = hist[1:]
        out[name] = {
            "history": hist, "peak_gb": peak,
            "launches_per_step": {k: launched[k] / steps for k in want},
            "step_ms_median": statistics.median(h["ms"] for h in steady),
            "tokens_per_s_median": statistics.median(
                h["tokens_per_s"] for h in steady),
            "profile": train_profile(step_fn, params, state, batches[0])}
        # bf16 attention ran the tensor-core instances, and only those
        kinds = out[name]["profile"]["device_ms_by_kind"]
        assert kinds.get("flash_attention (mma)", 0) > 0 and kinds.get(
            "flash_attention_bwd (mma)", 0) > 0, (name, kinds)
        assert "flash_attention" not in kinds and \
            "flash_attention_bwd" not in kinds, (name, kinds)
        assert FA.flash_attention.instance[0] == "mma" and \
            FB.flash_attention_bwd.instance[0] == "mma", name
        print(f"  {name}: attention instances {FA.flash_attention.instance}"
              f" forward, {FB.flash_attention_bwd.instance} backward")
        if blocked:
            # bf16 dgrad ran the tensor-core instances, and only those
            assert kinds.get("matmul_dgrad_a (mma)", 0) > 0 and kinds.get(
                "matmul_dgrad_b (mma)", 0) > 0, (name, kinds)
            assert "matmul_dgrad_a" not in kinds and \
                "matmul_dgrad_b" not in kinds, (name, kinds)
            assert MW.matmul_dgrad_a.instance[0] == "mma" and \
                MW.matmul_dgrad_b.instance[0] == "mma", name
            print(f"  {name}: dgrad instances {MW.matmul_dgrad_a.instance} "
                  f"(dA), {MW.matmul_dgrad_b.instance} (dB)")
            # and the forward GEMM (row 6) its "mma" instance, only that
            hold_mma_kinds(out[name]["profile"], ("matmul_blocked",),
                           ("mma",))
            assert MB.matmul_blocked.instance[0] == "mma", name
        print(f"  {name}: median step {out[name]['step_ms_median']:.1f} ms, "
              f"{out[name]['tokens_per_s_median']:.0f} tok/s, peak "
              f"{peak:.2f} GB, launches per step "
              f"{out[name]['launches_per_step']}")
        del params, state
        torch.cuda.empty_cache()
    del params0
    torch.cuda.empty_cache()
    return out


def time_train_kernels(cfg, train: dict) -> list[dict]:
    """Kernel rows 4 (with lse), 5, 7 and 8 at phase 11's shapes (4 x 512
    tokens, 32/8 heads, D = 128, granite's projections at M = 2048), bf16,
    beside bound, plain version and a library call, with launches per
    step from phase 11's blocked run."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.hopper_adapter import flash_tiles
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import matmul_bwd as MW
    from repro_torch.tune import best_schedule
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_step = train["blocked"]["launches_per_step"]
    rows = []
    b, s = 4, 512
    q, k, v = dense_inputs(dev, bf16, b, s, s, seed=11, hq=hq, hkv=hkv, d=d)
    g = dense_inputs(dev, bf16, b, s, s, seed=12, hq=hq, hkv=hq, d=d)[0]
    pairs = b * hq * s * (s + 1) // 2                # causal (row, key)
    o, lse = FA._forward(q, k, v, True, None, None, with_lse=True)
    qkvo = 2 * (2 * q.numel() + k.numel() + v.numel())
    fb_ms, fb_by = bound(qkvo + lse.numel() * 4, 4 * pairs * d)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    rows.append({
        "name": "flash_attention (lse)", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:234",
        "launches": int(per_step["flash_attention"] * 8),
        "max_abs_err": float((lse - FA.flash_attention_lse_ref(q, k))
                             .abs().max()),
        "ms": time_ms(lambda: FA._forward(q, k, v, True, None, None,
                                          with_lse=True)),
        "plain_ms": time_ms(lambda: (FA.flash_attention_ref(q, k, v),
                                     FA.flash_attention_lse_ref(q, k))),
        "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": time_ms(sdpa),
        "shape": f"train B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal bf16, "
                 f"with lse, instance {FA.flash_attention.instance}; "
                 f"launches: phase 11 blocked run, 8 steps (forward and "
                 f"remat recompute); library: SDPA forward"})
    attn_line(rows[-1], 4 * pairs * d, FA.flash_attention.instance[1:])

    # row 5: the backward at the same shape; library: SDPA's backward
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             enable_gqa=True)
    lib_g = g.transpose(1, 2)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (qs, ks, vs), lib_g, retain_graph=True)
    got = FB.flash_attention_bwd(q, k, v, o, lse, g)
    want = FB.flash_attention_bwd_ref(q, k, v, o, lse, g)
    bb_ms, bb_by = bound(2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
                         + 2 * lse.numel() * 4, 10 * pairs * d)
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:134",
        "launches": int(per_step["flash_attention_bwd"] * 8),
        "max_abs_err": max(float((x.float() - y.float()).abs().max())
                           for x, y in zip(got, want)),
        "ms": time_ms(lambda: FB.flash_attention_bwd(q, k, v, o, lse, g)),
        "plain_ms": time_ms(lambda: FB.flash_attention_bwd_ref(
            q, k, v, o, lse, g)),
        "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": time_ms(lib),
        "shape": f"train B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal bf16, "
                 f"instance {FB.flash_attention_bwd.instance} "
                 f"(the pallas_calls at :134 and :148); launches: phase 11 "
                 f"blocked run, 8 steps; library: SDPA backward "
                 f"(torch.autograd.grad)"})
    attn_line(rows[-1], 10 * pairs * d, flash_tiles(s, s, d, 2))

    # rows 7 and 8: every projection of a step at M = 2048 tokens, the
    # model's tiles, each beside its bound and torch.matmul, the two- and
    # three-stage instances in turns (2, 3, 3, 2; the row takes the
    # instance that runs by default); the row is the up projection's,
    # the others printed
    m = b * s
    for n, kk in GRANITE_NK:
        gen = torch.Generator(device=dev).manual_seed(n + kk)
        a = torch.randn((m, kk), generator=gen, device=dev).to(bf16)
        w = (torch.randn((kk, n), generator=gen, device=dev)
             * n ** -0.5).to(bf16)
        gg = torch.randn((m, n), generator=gen, device=dev).to(bf16)
        ta = best_schedule("matmul_dgrad", (m, kk, n), "bfloat16").tiles
        tb = best_schedule("matmul_dgrad", (kk, n, m), "bfloat16").tiles
        print(f"  the model's dgrad tiles at M={m} N={n} K={kk}: dA {ta}, "
              f"dB {tb}")
        flops = 2 * m * n * kk
        for name, fn, plain, lib, tiles, io in (
                ("matmul_dgrad_a",
                 lambda st: MW.matmul_dgrad_a(gg, w, bm=ta[0], br=ta[1],
                                              bo=ta[2], stages=st),
                 lambda: MW.matmul_dgrad_a_ref(gg, w),
                 lambda: torch.matmul(gg, w.T), ta,
                 (gg.numel() + w.numel() + m * kk) * 2),
                ("matmul_dgrad_b",
                 lambda st: MW.matmul_dgrad_b(a, gg, bk=tb[0], br=tb[1],
                                              bn=tb[2], stages=st),
                 lambda: MW.matmul_dgrad_b_ref(a, gg),
                 lambda: torch.matmul(a.T, gg), tb,
                 (a.numel() + gg.numel() + kk * n) * 2)):
            b_ms, b_by = bound(io, flops)
            by_stages = {2: [], 3: []}
            for st in (2, 3, 3, 2):
                by_stages[st].append(time_ms(lambda: fn(st)))
            st_ms = {st: statistics.mean(t) for st, t in by_stages.items()}
            fn(None)
            instance = getattr(MW, name).instance
            row = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/matmul_bwd.cu",
                "replaces": ("src/repro/kernels/matmul_bwd.py:66"
                             if name.endswith("_a") else
                             "src/repro/kernels/matmul_bwd.py:104"),
                "launches": int(per_step[name] * 8),
                "max_abs_err": float((fn(None).float() - plain().float())
                                     .abs().max()),
                "ms": st_ms[instance[2]], "plain_ms": time_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib),
                "shape": f"M={m} N={n} K={kk} tiles={tiles} bf16, "
                         f"instance {instance}; stages 2 / 3: "
                         f"{st_ms[2]:.4f} / {st_ms[3]:.4f} ms; "
                         f"launches: phase 11 blocked run, 8 steps; "
                         f"library: torch.matmul of the transposed view"}
            print(f"  {name} N={n} K={kk} tiles {tiles}: {row['ms']:.4f} ms,"
                  f" {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
                  f"{100 * b_ms / row['ms']:.1f}% of the {b_ms:.4f} ms bound "
                  f"({b_by}), {row['ms'] / row['library_ms']:.2f}x "
                  f"torch.matmul ({row['library_ms']:.4f} ms); stages 2 / 3 "
                  f"{st_ms[2]:.4f} / {st_ms[3]:.4f} ms; plain "
                  f"{row['plain_ms']:.4f} ms")
            if n == 12800 and kk == 4096:
                rows.append(row)
    for r in rows:
        print(f"  {r['name']:<22} {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']:.4f} ms  "
              f"[{r['shape']}]")
    return rows


def time_attention_passes() -> dict:
    """Rows 4 and 5 beyond phase 11's shape, bf16, GQA 32/8, D 128,
    causal: the forward with lse and the backward at (B, S) = (4, 2048)
    and (1, 8192) beside SDPA's forward and backward (median device ms,
    L2 flushed), and each launched kernel's device time at the train
    shape (4, 512) from torch.profiler: the forward and the backward's
    dq and dk/dv passes."""
    import re

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.tune.measure import time_ms as measure_ms
    dev = torch.device("cuda")
    out = {}
    for b, s in ((4, 2048), (1, 8192), (4, 512)):
        q, k, v = dense_inputs(dev, torch.bfloat16, b, s, s, seed=s)
        g = dense_inputs(dev, torch.bfloat16, b, s, s, seed=s + 1,
                         hkv=32)[0]
        o, lse = FA._forward(q, k, v, True, None, None, with_lse=True)
        if s == 512:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    FA._forward(q, k, v, True, None, None, with_lse=True)
                    FB.flash_attention_bwd(q, k, v, o, lse, g)
                torch.cuda.synchronize()
            passes = {re.search(r"\w+_mma_kernel", e.key).group():
                      float(e.self_device_time_total) / e.count / 1e3
                      for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")
                      and "_mma_kernel" in e.key}
            # late in this long process the trace has held no kernel
            # events (the same call alone records them): say so
            out["passes_ms_at_4x512"] = passes or None
            print(f"  rows 4 and 5 at B=4 S=512, ms per launch by kernel "
                  f"(torch.profiler): "
                  + (f"{ {n: round(t, 4) for n, t in passes.items()} }"
                     if passes else "not measured (no kernel events in "
                     "the trace)"))
            continue
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                               enable_gqa=True)
        pairs = b * 32 * s * (s + 1) // 2
        row = {
            "fwd_ms": measure_ms(lambda: FA._forward(
                q, k, v, True, None, None, with_lse=True), reps=10),
            "bwd_ms": measure_ms(lambda: FB.flash_attention_bwd(
                q, k, v, o, lse, g), reps=10),
            "sdpa_fwd_ms": measure_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), reps=10),
            "sdpa_bwd_ms": measure_ms(lambda: torch.autograd.grad(
                lib_o, (qs, ks, vs), g.transpose(1, 2), retain_graph=True),
                reps=10)}
        out[f"B{b}xS{s}"] = row
        print(f"  rows 4 and 5 at B={b} S={s}: forward "
              f"{row['fwd_ms']:.4f} ms "
              f"({4 * pairs * 128 / row['fwd_ms'] / 1e9:.1f} TFLOP/s; SDPA "
              f"{row['sdpa_fwd_ms']:.4f}), backward {row['bwd_ms']:.4f} ms "
              f"({10 * pairs * 128 / row['bwd_ms'] / 1e9:.1f} TFLOP/s; "
              f"SDPA {row['sdpa_bwd_ms']:.4f})")
        del q, k, v, g, o, lse, qs, ks, vs, lib_o
        torch.cuda.empty_cache()
    return out


# ------------------------------ the conv path --------------------------------

# the paper's Table-4 conv layers (PAPER_LAYERS, output-space X, Y) and
# AlexNet conv1 at its real shape (227 x 227 x 3 in, 11 x 11 stride 4, 96
# out): (name, X, Y, C, K, Fw, Fh, stride)
def conv_layers():
    from repro_torch.configs import PAPER_LAYERS
    out = [(n, p.X, p.Y, p.C, p.K, p.Fw, p.Fh, 1)
           for n, p in PAPER_LAYERS.items() if n.startswith("Conv")]
    return out + [("AlexNet conv1", 55, 55, 3, 96, 11, 11, 4)]


def conv_inputs(dev, dtype, n, h, w, c, k, fh, fw, stride, seed):
    """x (n, h, w, c), weights scaled by (c * fh * fw) ** -0.5 so every
    output is O(1), and a cotangent of the output's shape; drawn on the
    card from ``seed``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    oh, ow = (h - fh) // stride + 1, (w - fw) // stride + 1
    return (r(n, h, w, c).to(dtype),
            (r(fh, fw, c, k) * (c * fh * fw) ** -0.5).to(dtype),
            r(n, oh, ow, k).to(dtype))


def conv_key_tiles(op, dims, itemsize, stride):
    """Every tile the Hopper adapter emits for one conv key, asked the way
    ``tune.lowering.candidates`` asks (so the searches are shared with the
    tuner's)."""
    from repro_torch.core.hopper_adapter import (H100_SXM,
                                                 backward_tile_candidates,
                                                 conv_tile_candidates,
                                                 default_smem_budget)
    budget = default_smem_budget()
    if op == "conv2d":
        return conv_tile_candidates(*dims, itemsize, budget, H100_SXM,
                                    top=8, stride=stride)
    return backward_tile_candidates(op, dims, itemsize, budget, H100_SXM,
                                    top=8, stride=stride)


def phase3_conv(dev) -> None:
    """Rows 12 and 13 against their plain versions, fp32 and bf16,
    repeated launches bit-equal: ragged C, K and spatial tiles, strides
    1, 2 and 4, 1 x 1, 3 x 3 and 11 x 11 filters, C = 3; in bf16 the
    branches of rows 12 and 13's tensor-core instances (see below), every
    bf16 wgrad asserted to run its ``mma`` instance; then every tile
    the adapter emits for the Table-4 layers and AlexNet conv1 under the
    three conv keys, each at the layer's channels, filter and stride over
    two whole tiles and a ragged one per spatial axis (at most the
    layer's extent), one image (the forward, the dgrad's transposed conv
    at stride 1) or two (the wgrad)."""
    import torch
    from repro_torch.kernels import conv2d_blocked as CB
    from repro_torch.kernels import conv2d_bwd as CW

    def check(tag, dn, dtype, n, oy, ox, c, k, fh, fw, s, tiles, wgrad,
              seed):
        bx, by, bc, bk = tiles
        h, w = (oy - 1) * s + fh, (ox - 1) * s + fw
        x, wt, g = conv_inputs(dev, dtype, n, h, w, c, k, fh, fw, s, seed)
        if wgrad:
            run = lambda: CW.conv2d_wgrad_block(  # noqa: E731
                x, g, fh, fw, bx=bx, by=by, bc=bc, bk=bk, stride=s)
            want = CW.conv2d_wgrad_block_ref(x, g, fh, fw, s)
            atol, _ = grad_tol("float32", n * oy * ox, want)
            got = run()
            kind = CW.conv2d_wgrad_block.instance
            assert kind[0] == ("mma" if dtype == torch.bfloat16 else "fma"), \
                (tag, tiles, kind)
            compare(f"conv2d_wgrad_block {dn} {tag} tiles={tiles} {kind}",
                    got, want, "float32", atol=atol)
        else:
            run = lambda: CB.conv2d_block(  # noqa: E731
                x, wt, bc=bc, bk=bk, stride=s, bx=bx, by=by)
            got = run()
            compare(f"conv2d_block {dn} {tag} tiles={tiles}", got,
                    CB.conv2d_blocked_ref(x, wt, s), dn,
                    gemm_atol(dn, c * fh * fw))
        assert torch.equal(got, run()), f"{tag} {tiles}: repeat differs"

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # n, out y, out x, c, k, fh, fw, stride, (bx, by, bc, bk)
        for n, oy, ox, c, k, fh, fw, s, tiles in (
                (2, 8, 8, 4, 8, 3, 3, 1, (4, 4, 4, 8)),
                (2, 12, 10, 3, 5, 2, 2, 1, (5, 3, 3, 4)),
                (1, 6, 6, 4, 8, 3, 3, 2, (3, 3, 2, 4)),
                (1, 5, 5, 4, 8, 3, 3, 2, (2, 2, 4, 8)),
                (2, 8, 8, 16, 24, 1, 1, 1, (8, 8, 8, 16)),
                (2, 8, 8, 3, 96, 11, 11, 4, (4, 4, 3, 16)),
                (2, 20, 20, 37, 70, 11, 11, 1, (8, 8, 8, 16)),
                (2, 17, 17, 108, 200, 4, 4, 1, (8, 8, 16, 64))):
            tag = (f"N={n} out={oy}x{ox} C={c} K={k} {fh}x{fw} "
                   f"stride={s}")
            check(tag, dn, dtype, n, oy, ox, c, k, fh, fw, s, tiles, False,
                  oy + c)
            check(tag, dn, dtype, n, oy, ox, c, k, fh, fw, s,
                  (tiles[0], tiles[1], min(tiles[2], 8),
                   min(tiles[3], 16)), True, oy + k)
        if dtype == torch.bfloat16:
            # the tensor-core instance's branches: bc = 8 at 11 x 11 (a
            # k-step straddles two taps), C = 3 at stride 4, bx * by not
            # a multiple of 16 (7 x 19), bk not a multiple of the warp's
            # N (24: a clamped n8 pair; 40 and 72: odd n8 counts, 72 over
            # two warps across N; 3: one clamped n8 tile), wide bk (256:
            # four warps across N), 16 m16 tiles a warp (64 x 32 at bk =
            # 8) and an odd chunk count (3 x 3 taps of 8 channels)
            for n, oy, ox, c, k, fh, fw, s, tiles in (
                    (1, 16, 16, 64, 32, 11, 11, 1, (16, 16, 8, 16)),
                    (2, 11, 11, 3, 96, 11, 11, 4, (11, 11, 3, 8)),
                    (1, 19, 14, 16, 16, 3, 3, 1, (7, 19, 16, 16)),
                    (2, 12, 12, 16, 48, 3, 3, 1, (12, 12, 16, 24)),
                    (1, 10, 13, 24, 80, 2, 2, 1, (13, 10, 16, 40)),
                    (1, 9, 9, 16, 72, 3, 3, 1, (9, 9, 16, 72)),
                    (1, 20, 20, 40, 3, 3, 3, 1, (16, 8, 8, 3)),
                    (1, 8, 8, 16, 256, 3, 3, 1, (8, 8, 16, 256)),
                    (1, 32, 64, 8, 8, 1, 1, 1, (64, 32, 8, 8)),
                    (2, 14, 14, 8, 16, 3, 3, 1, (14, 8, 8, 16))):
                check(f"N={n} out={oy}x{ox} C={c} K={k} {fh}x{fw} "
                      f"stride={s} (tensor cores)", dn, dtype, n, oy, ox, c,
                      k, fh, fw, s, tiles, False, oy * k)
            # row 13's tensor-core instance: bc = 8 at 11 x 11 (an m16
            # fragment spans two taps), C = 3 at stride 4 (one chunk, 5
            # channels computed and not stored), bx * by not a multiple of
            # 16 (7 x 19: 11 zero cotangent rows against the last pixel),
            # ragged image edges (5 x 5 tiles of 12 x 12), bk of 3 (one
            # clamped n8 tile), 24 (over two warps across N) and 40 (five
            # n8 tiles), a ragged C tile (20 in 16s), stride 2, wide bk
            # (128: eight warps across N), Conv1's tile; a few (C, K)
            # tiles, so every case runs several splits
            for n, oy, ox, c, k, fh, fw, s, tiles in (
                    (2, 16, 16, 64, 32, 11, 11, 1, (16, 16, 8, 16)),
                    (2, 11, 11, 3, 96, 11, 11, 4, (11, 11, 3, 16)),
                    (1, 19, 14, 16, 16, 3, 3, 1, (7, 19, 16, 16)),
                    (2, 12, 12, 16, 48, 3, 3, 1, (5, 5, 16, 24)),
                    (1, 20, 20, 40, 3, 3, 3, 1, (16, 8, 8, 3)),
                    (1, 10, 13, 24, 80, 2, 2, 1, (13, 10, 16, 40)),
                    (2, 9, 7, 20, 40, 3, 3, 2, (4, 3, 16, 40)),
                    (1, 9, 9, 8, 128, 3, 3, 1, (9, 9, 8, 128)),
                    (2, 40, 40, 16, 32, 11, 11, 1, (32, 16, 8, 16))):
                check(f"N={n} out={oy}x{ox} C={c} K={k} {fh}x{fw} "
                      f"stride={s} (tensor cores)", dn, dtype, n, oy, ox, c,
                      k, fh, fw, s, tiles, True, oy * k + 1)
        # non-finite input: +Inf in the last real pixel of a tile whose
        # pixel count pads to whole k-steps (7 x 19), and in the input row
        # past the last window of a ragged image edge (12 x 12 outputs in
        # 5 x 5 tiles): dW is +-Inf exactly where the fp32 oracle is, and
        # within the gate elsewhere
        for n, oy, ox, c, k, tiles, pixel in (
                (1, 19, 14, 16, 16, (7, 19, 16, 16), (0, 20, 8, 0)),
                (2, 12, 12, 16, 48, (5, 5, 16, 24), (1, 13, 7, 3))):
            h, w = oy + 2, ox + 2
            x, _, g = conv_inputs(dev, dtype, n, h, w, c, k, 3, 3, 1, oy)
            x[pixel] = float("inf")
            bx, by, bc, bk = tiles
            got = CW.conv2d_wgrad_block(x, g, 3, 3, bx=bx, by=by, bc=bc,
                                        bk=bk)
            want = CW.conv2d_wgrad_block_ref(x, g, 3, 3, 1)
            hold_nonfinite(f"conv2d_wgrad_block {dn} N={n} out={oy}x{ox} "
                           f"C={c} K={k} tiles={tiles} +Inf at {pixel}",
                           got, want, grad_tol("float32", n * oy * ox,
                                               want.nan_to_num(0, 0, 0))[0])
        n_tiles = 0
        for name, X, Y, C, K, Fw, Fh, s in conv_layers():
            keys = (("conv2d", (X, Y, C, K, Fw, Fh), s),
                    ("conv2d_dgrad", ((X - 1) * s + Fw, (Y - 1) * s + Fh,
                                      K, C, Fw, Fh), 1),
                    ("conv2d_wgrad", (X, Y, C, K, Fw, Fh), s))
            for op, dims, ks in keys:
                x_, y_, c_, k_, fw_, fh_ = dims
                for tiles in conv_key_tiles(op, dims, dtype.itemsize, ks):
                    oy = min(y_, 2 * tiles[1] + 1)
                    ox = min(x_, 2 * tiles[0] + 1)
                    check(f"{name} {op} out={oy}x{ox} C={c_} K={k_} "
                          f"{fh_}x{fw_} stride={ks}", dn, dtype,
                          2 if op == "conv2d_wgrad" else 1, oy, ox, c_, k_,
                          fh_, fw_, ks, tiles, op == "conv2d_wgrad",
                          n_tiles)
                    n_tiles += 1
        print(f"  {n_tiles} conv adapter tiles checked in {dn}")
    torch.cuda.synchronize()


def hold_nonfinite(name: str, got, want, atol: float) -> None:
    """``got`` is non-finite exactly where ``want`` is, with the same
    values there (+-Inf, NaN), and within ``atol`` plus the fp32 rule
    elsewhere."""
    import torch
    bad = ~torch.isfinite(want)
    assert bool(bad.any()), f"{name}: the case holds no non-finite value"
    same = torch.equal(bad, ~torch.isfinite(got)) and torch.equal(
        got[bad].nan_to_num(), want[bad].nan_to_num())
    print(f"  {name}: {int(bad.sum())} non-finite values "
          f"{'as in the oracle' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{name}: non-finite values differ")
    compare(name, got[~bad], want[~bad], "float32", atol=atol)


CONV_KERNELS = ("conv2d_block", "conv2d_wgrad_block")


def phase12_conv(kernels: dict) -> dict:
    """The paper's conv path at full Table-4 size: Conv1..Conv5 at batch 2
    and AlexNet conv1 (227 x 227 x 3, stride 4) at batch 2, bf16, each
    through ``ops.conv2d`` forward and ``torch.autograd.grad`` for dX and
    dW, tiles from the model under the three keys; held against the fp32
    oracles on the card; launch counts asserted per layer (one row-12
    launch forward, one for the dgrad, row 13's two passes for the
    wgrad, on its tensor-core instance), and ``use_kernel=False``
    launching nothing; each layer's
    forward and backward timed on the host clock at the first call and
    at a second one."""
    import torch
    from repro_torch import tune
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    out = {}
    resolved = []
    prev = tune.set_schedule_observer(
        lambda spec, sch: resolved.append((spec.op, sch.tiles, sch.source)))
    try:
        for i, (name, X, Y, C, K, Fw, Fh, s) in enumerate(conv_layers()):
            n = 2
            h, w = (Y - 1) * s + Fh, (X - 1) * s + Fw
            x, wt, g = conv_inputs(dev, bf16, n, h, w, C, K, Fh, Fw, s,
                                   seed=100 + i)
            # the model's tile search for each key is host work, done once
            t0 = time.perf_counter()
            for op, dims, ks in (
                    ("conv2d", (X, Y, C, K, Fw, Fh), s),
                    ("conv2d_dgrad", (w, h, K, C, Fw, Fh), 1),
                    ("conv2d_wgrad", (X, Y, C, K, Fw, Fh), s)):
                tune.best_schedule(op, dims, "bfloat16", stride=ks)
            search_s = time.perf_counter() - t0
            resolved.clear()
            reset(kernels)
            xg = x.clone().requires_grad_()
            wg = wt.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = ops.conv2d(xg, wg, stride=s)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd = counts(kernels)
            dx, dw = torch.autograd.grad(y, (xg, wg), g)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launched = counts(kernels)
            assert fwd["conv2d_block"] == 1 and \
                fwd["conv2d_wgrad_block"] == 0, fwd
            assert launched["conv2d_block"] == 2 and \
                launched["conv2d_wgrad_block"] == 2, launched
            # no silent CUDA-core path: the bf16 wgrad ran the tensor cores
            wgrad_instance = kernels["conv2d_wgrad_block"].instance
            assert wgrad_instance[0] == "mma", wgrad_instance
            assert all(v == 0 for k_, v in launched.items()
                       if k_ not in CONV_KERNELS), launched
            tiles = {op: list(t) for op, t, _ in resolved}
            for op, t, src in resolved:
                print(f"  {name}: {op} tiles {t} ({src})")
            # the same call again: what a layer costs once its kernels
            # are loaded and its tiles resolved
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            y2 = ops.conv2d(xg, wg, stride=s)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            torch.autograd.grad(y2, (xg, wg), g)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            del y2
            # the fp32 oracles on the same bf16 values, TF32 off
            xf, wf, gf = x.float(), wt.float(), g.float()
            errs = {}
            for what, got, want, red in (
                    ("y", y, ref.conv2d_ref(xf, wf, s), C * Fh * Fw),
                    ("dX", dx, ref.conv2d_dgrad_ref(gf, wf, tuple(x.shape),
                                                    s), K * Fh * Fw),
                    ("dW", dw, ref.conv2d_wgrad_ref(xf, gf, tuple(wt.shape),
                                                    s), n * X * Y)):
                assert got.dtype == bf16 and got.shape == want.shape
                assert bool(torch.isfinite(got.float()).all()), what
                errs[what] = hold_conv(f"{name} {what}", got, want, red)
            # the plain versions by name launch nothing
            reset(kernels)
            with torch.no_grad():
                yp = ops.conv2d(x, wt, stride=s, use_kernel=False)
            xp = x.clone().requires_grad_()
            wp = wt.clone().requires_grad_()
            dxp, dwp = torch.autograd.grad(
                ops.conv2d(xp, wp, stride=s, use_kernel=False), (xp, wp), g)
            torch.cuda.synchronize()
            assert all(v == 0 for v in counts(kernels).values()), \
                counts(kernels)
            hold_conv(f"{name} y (plain path)", yp, ref.conv2d_ref(xf, wf, s),
                      C * Fh * Fw)
            gmacs = n * Y * X * K * C * Fh * Fw / 1e9
            print(f"  {name} N={n} {h}x{w}x{C} -> {Y}x{X}x{K}, {Fh}x{Fw} "
                  f"stride {s}: {gmacs:.1f} GMAC; forward "
                  f"{(t1 - t0) * 1e3:.1f} ms, backward "
                  f"{(t2 - t1) * 1e3:.1f} ms (host clock, first call; "
                  f"again: {(t4 - t3) * 1e3:.2f} and {(t5 - t4) * 1e3:.2f} "
                  f"ms); tile search {search_s:.2f} s; launches {launched}; "
                  f"wgrad instance {wgrad_instance}")
            out[name] = {"shape": [n, h, w, C, K, Fh, Fw, s], "tiles": tiles,
                         "wgrad_instance": [wgrad_instance[0],
                                            list(wgrad_instance[1])],
                         "gmac": gmacs, "fwd_ms": (t1 - t0) * 1e3,
                         "bwd_ms": (t2 - t1) * 1e3,
                         "fwd_again_ms": (t4 - t3) * 1e3,
                         "bwd_again_ms": (t5 - t4) * 1e3,
                         "search_s": search_s,
                         "launches": {k_: launched[k_]
                                      for k_ in CONV_KERNELS},
                         "max_abs_err": errs}
            del x, wt, g, xg, wg, y, dx, dw, xp, wp, dxp, dwp, yp
            torch.cuda.empty_cache()
    finally:
        tune.set_schedule_observer(prev)
    return out


def hold_conv(name: str, got, want, reduce: int) -> float:
    """A bf16 result against the fp32 oracle on the same bf16 inputs: one
    bf16 rounding of the output (1e-2 rel) plus a ``reduce``-term fp32 sum
    in another order on the scale of the largest |value| (2e-6 *
    sqrt(reduce) of it, the phase-3 GEMM rule)."""
    import torch
    scale = float(want.abs().max())
    atol = 2e-6 * reduce ** 0.5 * scale
    diff = (got.detach().float() - want.float()).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= atol + 1e-2 * want.abs()))
    print(f"  {name:<34} max_abs_err {err:.3e} of max |ref| {scale:.3e} "
          f"(tol {atol:.3g} abs + 0.01 rel)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the conv path disagrees with the "
                             "fp32 oracle")
    return err


def time_conv_kernels(conv: dict) -> list[dict]:
    """Rows 12 and 13 at Conv4 and Conv1, batch 2, bf16, with the model's
    tiles, beside bound, plain version and one library call (``F.conv2d``
    on channels_last bf16 with TF32 off; ``torch.nn.grad.conv2d_input`` and
    ``conv2d_weight``), cuDNN's algorithm chosen by timing
    (``cudnn.benchmark``: on an H100 80GB HBM3 its default heuristic took
    87-111 ms for Conv1's 11 x 11 in bf16); the dgrad through row 12
    beside them.
    Conv1's rows go into the kernels line, Conv4's are printed.  Conv1
    times over 10 launches, Conv4 over 50.  Then row 12 at AlexNet
    conv1's tile, at stride 4 and at stride 1 on the same products."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_blocked as CB
    from repro_torch.kernels import conv2d_bwd as CW
    from repro_torch.tune import best_schedule
    from repro_torch.tune.measure import time_ms as measure_ms
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    rows = []
    layers = {n: v for n, *v in conv_layers()}
    for name, reps in (("Conv4", 50), ("Conv1", 10)):
        X, Y, C, K, Fw, Fh, s = layers[name]
        n = 2
        h, w = (Y - 1) * s + Fh, (X - 1) * s + Fw
        x, wt, g = conv_inputs(dev, bf16, n, h, w, C, K, Fh, Fw, s, seed=7)
        tf = best_schedule("conv2d", (X, Y, C, K, Fw, Fh), "bfloat16",
                           stride=s).tiles
        tw = best_schedule("conv2d_wgrad", (X, Y, C, K, Fw, Fh), "bfloat16",
                           stride=s).tiles
        flops = 2 * n * Y * X * K * C * Fh * Fw
        # library operands: NCHW views of the NHWC tensors (channels_last)
        # and the weight in channels_last
        x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        launches = {k: sum(v["launches"][k] for v in conv.values())
                    for k in CONV_KERNELS}
        tm = lambda fn: measure_ms(fn, reps=reps)  # noqa: E731

        y = CB.conv2d_tiled(x, wt, bx=tf[0], by=tf[1], bc=tf[2], bk=tf[3],
                            stride=s)
        fb_ms, fb_by = bound(2 * (x.numel() + wt.numel() + y.numel()),
                             flops)
        fwd = {
            "name": "conv2d_block", "route": "cuda",
            "source": "src/repro_torch/csrc/conv2d_blocked.cu",
            "replaces": "src/repro/kernels/conv2d_blocked.py:141",
            "launches": launches["conv2d_block"],
            "max_abs_err": float((y.float() - CB.conv2d_blocked_ref(
                x, wt, s).float()).abs().max()),
            "ms": tm(lambda: CB.conv2d_tiled(x, wt, bx=tf[0], by=tf[1],
                                             bc=tf[2], bk=tf[3], stride=s)),
            "plain_ms": tm(lambda: CB.conv2d_blocked_ref(x, wt, s)),
            "bound_ms": fb_ms, "bound_by": fb_by,
            "library_ms": tm(lambda: F.conv2d(x_cl, w_cl, stride=s)),
            "shape": f"{name} N={n} {h}x{w}x{C} -> {Y}x{X}x{K} {Fh}x{Fw} "
                     f"stride {s} bf16, tiles {tuple(tf)}; launches: phase "
                     f"12, all six layers (forward and dgrad); library: "
                     f"F.conv2d channels_last, TF32 off, cudnn.benchmark"}
        # the dgrad through row 12: the transposed conv on the host-dilated
        # cotangent (what ops.conv2d's backward runs)
        dx = CW.conv2d_dgrad(g, wt, tuple(x.shape), s)
        db_ms, db_by = bound(2 * (g.numel() + wt.numel() + x.numel()), flops)
        # row 12 alone on the dgrad's operands: the padded cotangent and
        # the flipped weights, under the "conv2d_dgrad" key's tiles
        gp, w_t = CW.dgrad_operands(g, wt, s)
        td = best_schedule("conv2d_dgrad", (gp.shape[2] - Fw + 1,
                                            gp.shape[1] - Fh + 1, K, C, Fw,
                                            Fh), "bfloat16").tiles
        dflops = 2 * n * (gp.shape[1] - Fh + 1) * (gp.shape[2] - Fw + 1) \
            * C * K * Fh * Fw
        dgrad = {
            "kernel_ms": tm(lambda: CB.conv2d_tiled(
                gp, w_t, bx=td[0], by=td[1], bc=td[2], bk=td[3])),
            "kernel_flops": dflops, "tiles": list(td),
            "ms": tm(lambda: CW.conv2d_dgrad(g, wt, tuple(x.shape), s)),
            "plain_ms": tm(lambda: CW.conv2d_dgrad(g, wt, tuple(x.shape), s,
                                                   use_kernel=False)),
            "library_ms": tm(lambda: torch.nn.grad.conv2d_input(
                x_cl.shape, w_cl, g_cl, stride=s)),
            "bound_ms": db_ms, "bound_by": db_by,
            "max_abs_err": float((dx.float() - CW.conv2d_dgrad(
                g, wt, tuple(x.shape), s, use_kernel=False).float())
                .abs().max())}
        dw = CW.conv2d_wgrad_block(x, g, Fh, Fw, bx=tw[0], by=tw[1],
                                   bc=tw[2], bk=tw[3], stride=s)
        w_instance = CW.conv2d_wgrad_block.instance
        assert w_instance[0] == "mma", w_instance
        wb_ms, wb_by = bound(2 * (x.numel() + g.numel()) + 4 * dw.numel(),
                             flops)
        wgrad = {
            "name": "conv2d_wgrad_block", "route": "cuda",
            "source": "src/repro_torch/csrc/conv2d_wgrad.cu",
            "replaces": "src/repro/kernels/conv2d_bwd.py:107",
            "launches": launches["conv2d_wgrad_block"],
            "max_abs_err": float((dw - CW.conv2d_wgrad_block_ref(
                x, g, Fh, Fw, s)).abs().max()),
            "ms": tm(lambda: CW.conv2d_wgrad_block(
                x, g, Fh, Fw, bx=tw[0], by=tw[1], bc=tw[2], bk=tw[3],
                stride=s)),
            "plain_ms": tm(lambda: CW.conv2d_wgrad_block_ref(x, g, Fh, Fw,
                                                             s)),
            "bound_ms": wb_ms, "bound_by": wb_by,
            "library_ms": tm(lambda: torch.nn.grad.conv2d_weight(
                x_cl, w_cl.shape, g_cl, stride=s)),
            "shape": f"{name} N={n} {h}x{w}x{C}, cotangent {Y}x{X}x{K}, "
                     f"{Fh}x{Fw} stride {s} bf16 in, fp32 dW, tiles "
                     f"{tuple(tw)}, instance {w_instance}, both passes; "
                     f"launches: phase 12, all "
                     f"six layers (two passes each); library: "
                     f"torch.nn.grad.conv2d_weight channels_last bf16, "
                     f"cudnn.benchmark"}
        print(f"  {name} conv2d_block {fwd['ms']:.4f} ms  plain "
              f"{fwd['plain_ms']:.4f} ms  bound {fb_ms:.4f} ms ({fb_by})  "
              f"library {fwd['library_ms']:.4f} ms  "
              f"({flops / fwd['ms'] / 1e9:.1f} TFLOP/s, "
              f"{fb_ms / fwd['ms']:.1%} of bound)  [{fwd['shape']}]")
        print(f"  {name} dgrad via conv2d_block {dgrad['ms']:.4f} ms  plain "
              f"{dgrad['plain_ms']:.4f} ms  bound {db_ms:.4f} ms ({db_by})  "
              f"library {dgrad['library_ms']:.4f} ms  max_abs_err "
              f"{dgrad['max_abs_err']:.3e}  (host dilation and padding "
              f"included; library: torch.nn.grad.conv2d_input); row 12 "
              f"alone {dgrad['kernel_ms']:.4f} ms at tiles {tuple(td)} "
              f"({dflops / dgrad['kernel_ms'] / 1e9:.1f} TFLOP/s over the "
              f"padded cotangent's products, {db_ms / dgrad['kernel_ms']:.1%}"
              f" of the dgrad's bound)")
        print(f"  {name} conv2d_wgrad_block {wgrad['ms']:.4f} ms  plain "
              f"{wgrad['plain_ms']:.4f} ms  bound {wb_ms:.4f} ms ({wb_by})  "
              f"library {wgrad['library_ms']:.4f} ms  "
              f"({flops / wgrad['ms'] / 1e9:.1f} TFLOP/s, "
              f"{wb_ms / wgrad['ms']:.1%} of bound, "
              f"{wgrad['ms'] / wgrad['library_ms']:.2f}x the library, "
              f"instance {w_instance})  [{wgrad['shape']}]")
        conv[name]["timing"] = {"forward": {k: v for k, v in fwd.items()
                                            if k.endswith(("ms", "err"))},
                                "dgrad": dgrad,
                                "wgrad": {k: v for k, v in wgrad.items()
                                          if k.endswith(("ms", "err"))}}
        if name == "Conv1":
            rows += [fwd, wgrad]
        del x, wt, g, y, dx, dw, gp, w_t
        torch.cuda.empty_cache()
    # AlexNet conv1's stride 4 puts neighbouring output pixels 4 staged
    # pixels apart, so the 8 rows of an A fragment share bank groups;
    # the same products at stride 1 (a 65 x 65 input) show what that and
    # the stride's 6x larger staged input cost
    X, Y, C, K, Fw, Fh, s = layers["AlexNet conv1"]
    ta = best_schedule("conv2d", (X, Y, C, K, Fw, Fh), "bfloat16",
                       stride=s).tiles
    flops = 2 * 2 * Y * X * K * C * Fh * Fw
    alex = {}
    for st in (s, 1):
        h, w = (Y - 1) * st + Fh, (X - 1) * st + Fw
        x, wt, _ = conv_inputs(dev, bf16, 2, h, w, C, K, Fh, Fw, st, seed=7)
        alex[st] = measure_ms(lambda: CB.conv2d_tiled(
            x, wt, bx=ta[0], by=ta[1], bc=ta[2], bk=ta[3], stride=st),
            reps=50)
        print(f"  AlexNet conv1 conv2d_block at stride {st} (N=2 {h}x{w}x"
              f"{C} -> {Y}x{X}x{K}, tiles {tuple(ta)}): {alex[st]:.4f} ms "
              f"({flops / alex[st] / 1e9:.1f} TFLOP/s)")
    conv["AlexNet conv1"]["timing"] = {"forward_ms_by_stride": alex}
    torch.backends.cudnn.benchmark = False
    return rows


def time_conv_layers() -> dict:
    """Rows 12 and 13 at every Table-4 layer and AlexNet conv1, batch 2,
    bf16, with the model's tiles: the forward (``conv2d_tiled``), the
    dgrad (``conv2d_dgrad``, the host's dilation and padding included)
    and the wgrad (``conv2d_wgrad_block``, both passes, with its TFLOP/s
    and share of the bound), median device ms over 20 launches (10 at
    Conv1), L2 flushed."""
    import torch
    from repro_torch.kernels import conv2d_blocked as CB
    from repro_torch.kernels import conv2d_bwd as CW
    from repro_torch.tune import best_schedule
    from repro_torch.tune.measure import time_ms as measure_ms
    dev = torch.device("cuda")
    out = {}
    for name, X, Y, C, K, Fw, Fh, s in conv_layers():
        h, w = (Y - 1) * s + Fh, (X - 1) * s + Fw
        x, wt, g = conv_inputs(dev, torch.bfloat16, 2, h, w, C, K, Fh, Fw, s,
                               seed=7)
        tf = best_schedule("conv2d", (X, Y, C, K, Fw, Fh), "bfloat16",
                           stride=s).tiles
        tw = best_schedule("conv2d_wgrad", (X, Y, C, K, Fw, Fh), "bfloat16",
                           stride=s).tiles
        reps = 10 if name == "Conv1" else 20
        fwd = measure_ms(lambda: CB.conv2d_tiled(
            x, wt, bx=tf[0], by=tf[1], bc=tf[2], bk=tf[3], stride=s),
            reps=reps)
        dgrad = measure_ms(lambda: CW.conv2d_dgrad(g, wt, tuple(x.shape), s),
                           reps=reps)
        wgrad = measure_ms(lambda: CW.conv2d_wgrad_block(
            x, g, Fh, Fw, bx=tw[0], by=tw[1], bc=tw[2], bk=tw[3], stride=s),
            reps=reps)
        flops = 2 * 2 * Y * X * K * C * Fh * Fw
        w_bound, _ = bound(2 * (x.numel() + g.numel()) + 4 * Fh * Fw * C * K,
                           flops)
        out[name] = {"forward_ms": fwd, "dgrad_ms": dgrad, "wgrad_ms": wgrad,
                     "forward_tiles": list(tf), "wgrad_tiles": list(tw),
                     "wgrad_bound_ms": w_bound}
        print(f"  rows 12 and 13 at {name}: forward {fwd:.4f} ms (tiles "
              f"{tuple(tf)}), dgrad {dgrad:.4f} ms, wgrad {wgrad:.4f} ms "
              f"(tiles {tuple(tw)}, {CW.conv2d_wgrad_block.instance}, "
              f"{flops / wgrad / 1e9:.1f} TFLOP/s, {w_bound / wgrad:.1%} "
              f"of bound)")
        del x, wt, g
        torch.cuda.empty_cache()
    return out


def ptxas_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) of each entry function in
    an ``nvcc -Xptxas -v`` log; the kernel named by its identifier and
    its integer template arguments (``fwd_mma_kernel<128,64,64>``,
    ``wgrad_mma<8,2>``)."""
    import re

    def label(mangled: str) -> str:
        # the length-prefixed names of the (nested) name, in order
        i = 3 if mangled.startswith("_ZN") else 2
        while (m := re.match(r"\d+", mangled[i:])) is not None:
            j = i + len(m.group())
            i = j + int(m.group())
            if mangled[j:i].endswith("kernel") or mangled[i:i + 1] == "I":
                ints = re.findall(r"Li(\d+)E", mangled[i:])[:3]
                return f"{mangled[j:i]}<{','.join(ints)}>"
        return mangled[:40]

    out, name, spill = [], "?", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = label(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), spill))
    return out


T0 = time.perf_counter()


def phase(title: str) -> None:
    """A phase's title, with the seconds the run has taken before it."""
    print(f"{title}  [{time.perf_counter() - T0:.0f}s into the run]",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.hopper_adapter import H100_SXM
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d_blocked as CB
    from repro_torch.kernels import conv2d_bwd as CW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import matmul_blocked as MB
    from repro_torch.kernels import matmul_bwd as MW
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import matmul_q as MQ
    from repro_torch.kernels import qkv_fused as QF
    kernels = {"conv2d_block": CB.conv2d_block,
               "conv2d_wgrad_block": CW.conv2d_wgrad_block,
               "flash_attention": FA.flash_attention,
               "flash_attention_bwd": FB.flash_attention_bwd,
               "flash_decode": FD.flash_decode,
               "flash_decode_fp8": FD.flash_decode_fp8,
               "flash_decode_oproj": FD.flash_decode_oproj,
               "matmul_blocked": MB.matmul_blocked,
               "matmul_dgrad_a": MW.matmul_dgrad_a,
               "matmul_dgrad_b": MW.matmul_dgrad_b,
               "matmul_fused": MF.matmul_fused,
               "matmul_w8": MQ.matmul_w8,
               "qkv_fused": QF.qkv_fused}

    phase("phase 1: card")
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    optin = torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    print(f"  opt-in shared memory per block: {optin} B on the card, "
          f"{H100_SXM.smem_optin_bytes} B in the Hopper target")
    assert optin == H100_SXM.smem_optin_bytes, "the target does not match"

    phase("phase 2: build")
    t0 = time.perf_counter()

    def build_one(name):     # one nvcc each, all at once, each timed
        reports = _build.build([name])
        return name, reports, time.perf_counter() - t0
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        built = list(pool.map(build_one, _build.SOURCES))
    reports = {n: log for _, r, _ in built for n, log in r.items()}
    print(f"  built {sorted(reports) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f}s; done after (s): "
          f"{ {n: round(t, 1) for n, _, t in built} }")
    for name, log in reports.items():
        for label, regs, spill in ptxas_report(log):
            print(f"  {name}: {label}: {regs} registers, {spill} B spilled")
    dgrad_mma = [(regs, spill) for label, regs, spill in
                 ptxas_report(reports.get("matmul_bwd", ""))
                 if "_mma_kernel" in label]
    if dgrad_mma:
        print(f"  matmul_bwd: {len(dgrad_mma)} nt_mma_kernel/tn_mma_kernel "
              f"instances, {min(r for r, _ in dgrad_mma)}-"
              f"{max(r for r, _ in dgrad_mma)} registers, "
              f"{sum(sp for _, sp in dgrad_mma)} B spilled in all")
    gemm_inst = [(regs, spill) for name in ("matmul_blocked",
                                            "matmul_blocked_mma",
                                            "matmul_fused",
                                            "matmul_fused_mma", "matmul_w8",
                                            "matmul_w8_mma", "qkv_fused",
                                            "qkv_fused_mma")
                 for label, regs, spill in ptxas_report(reports.get(name, ""))
                 if label.startswith(("mma_kernel<", "mma_t_kernel<"))]
    if gemm_inst:
        print(f"  rows 6, 9-11: {len(gemm_inst)} mma_kernel/mma_t_kernel "
              f"instances, {min(r for r, _ in gemm_inst)}-"
              f"{max(r for r, _ in gemm_inst)} registers, "
              f"{sum(sp for _, sp in gemm_inst)} B spilled in all")
    oproj = ptxas_report(reports.get("flash_decode_oproj", ""))
    if oproj:
        print(f"  flash_decode_oproj: {len(oproj)} instances, "
              f"{min(r for _, r, _ in oproj)}-{max(r for _, r, _ in oproj)} "
              f"registers, {sum(sp for _, _, sp in oproj)} B spilled in all")
    wgrad_mma = [(regs, spill) for label, regs, spill in
                 ptxas_report(reports.get("conv2d_wgrad", ""))
                 if label.startswith("wgrad_mma<")]
    if wgrad_mma:
        print(f"  conv2d_wgrad: {len(wgrad_mma)} wgrad_mma instances, "
              f"{min(r for r, _ in wgrad_mma)}-"
              f"{max(r for r, _ in wgrad_mma)} registers, "
              f"{sum(sp for _, sp in wgrad_mma)} B spilled in all")

    phase("phase 3: kernels vs plain versions")
    for check in (phase3_kernels, phase3_head_dims, phase3_oproj_wide,
                  phase3_fused, phase3_quant, phase3_train, phase3_conv):
        t0 = time.perf_counter()
        check(torch.device("cuda"))
        print(f"  {check.__name__}: {time.perf_counter() - t0:.1f}s")
    phase("phase 4: engine parity, granite-3-8b width, 2 layers, fp32, "
          "unfused and fused, wide and w8fp8")
    phase4_parity(args.seed, kernels)
    phase("phase 13: the reduced granite-3-8b (head_dim 16) on the card: "
          "serving parity, the fused path, 3 training steps, the "
          "launchers' usage lines")
    reduced = phase13_reduced(args.seed, kernels)
    phase("phase 5: granite-3-8b, full width and depth, bf16, cuBLAS path")
    cfg, params, warm, lens, prompts = full_model(args.seed)
    cublas = phase5_full(cfg, params, warm, prompts, kernels)
    phase("phase 6: the same, blocking model's page and chunk, every "
          "projection through matmul_blocked")
    blocked = phase6_blocked(cfg, params, warm, prompts, kernels)
    phase("phase 6b: the fused path: the same, fuse=True (one-pass QKV, "
          "epilogue-fused MLP, oproj-fused decode)")
    fused = phase6_fused(cfg, params, warm, prompts, kernels)
    print(f"  fused {fused['tok_per_s']:.1f} tok/s against blocked "
          f"{blocked['tok_per_s']:.1f} tok/s in this run")
    phase("phase 9: the quantized path (w8fp8): int8 projections from "
          "quantize_params on the card, an fp8 page pool, the model's page "
          "and chunk")
    from repro_torch.quant import (dequantize_params, quantize_params,
                                   quantized_bytes)
    want_bf16 = _cublas_logits(cfg, params, prompts[0])
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    qb, db = quantized_bytes(qparams)
    print(f"  quantized projection weights: {qb / 1e9:.3f} GB (same "
          f"projections at bf16: {db / 1e9:.3f} GB), quantized in "
          f"{time.perf_counter() - t0:.1f}s")
    del params
    torch.cuda.empty_cache()
    fq = dequantize_params(qparams, torch.bfloat16)
    want_fq = _cublas_logits(cfg, fq, prompts[0])
    del fq
    torch.cuda.empty_cache()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    quant = phase9_quantized(cfg8, qparams, warm, prompts, kernels, False,
                             want_fq, want_bf16)
    phase("phase 9b: the quantized path, fuse=True (q/k/v and wo through "
          "matmul_w8, the MLP through the int8 matmul_fused)")
    quant_fused = phase9_quantized(cfg8, qparams, warm, prompts, kernels,
                                   True, want_fq, want_bf16)
    for r in (quant, quant_fused):
        r["quantized_bytes"], r["bf16_bytes"] = qb, db
    print(f"  w8fp8 {quant['tok_per_s']:.1f} tok/s, fused "
          f"{quant_fused['tok_per_s']:.1f} tok/s in this run")
    del qparams
    torch.cuda.empty_cache()
    phase("phase 10: training parity, granite-3-8b width, 2 layers, fp32: "
          "one train step on the kernel path (blocked linears) and on the "
          "plain path")
    parity = phase10_train_parity(args.seed, kernels)
    phase("phase 11: training granite-3-8b at full width, 4 of 40 layers, "
          "bf16, remat block, 4 x 512 tokens, 8 steps: default path and "
          "blocked kernels")
    train = phase11_train(args.seed, kernels)
    phase("phase 12: the paper's conv path at full Table-4 size: Conv1-5 "
          "and AlexNet conv1, batch 2, bf16, ops.conv2d forward and "
          "backward")
    conv = phase12_conv(kernels)
    phase("phase 7: tune_op matmul (8, 4096, 4096), qkv_fused "
          "(8, 1024, 4096, 4) and conv2d (Conv4), bfloat16")
    tuned = phase7_tune()
    phase("phase 8: kernel timings at the blocked, fused and quantized "
          "runs' shapes")
    rows = time_kernels(cfg, lens, blocked["launches"], blocked["page"])
    rows += time_fused_kernels(cfg, lens, fused["launches"], fused["page"])
    rows += time_quant_kernels(cfg, lens, quant["launches"],
                               quant_fused["launches"], quant["page"])
    rows += time_train_kernels(cfg, train)
    train["attention"] = time_attention_passes()
    rows += time_conv_kernels(conv)
    for name, t in time_conv_layers().items():
        conv[name].setdefault("timing", {})["layers"] = t
    print("serve " + json.dumps({"prompt_lens": [int(n) for n in lens],
                                 "cublas": cublas, "blocked": blocked,
                                 "fused": fused, "w8fp8": quant,
                                 "w8fp8_fused": quant_fused,
                                 "tune": tuned}))
    print("train " + json.dumps({"parity": parity, "full_width": train,
                                 "reduced": reduced}))
    print("conv " + json.dumps(conv))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
