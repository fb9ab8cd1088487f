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
   largest that fits: 111 keys in fp32) and the model's page, repeats
   bit-equal; rows 1 and 2's split grid in bf16 (batches of 1 to 64
   rows, so one split to the most, a row whose later splits see
   nothing, decode and chunk, every split count at 1 and 8 rows,
   repeats bit-equal);
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
   q_span 1 and 64, window, cap and unit or drawn scales; rows 1 and 2
   at the speculative verify's shape (B 8, q_span 2..5, the unfused,
   fused and fp8 engines' pages and page 16, a slot at length 1 and one
   whose rows pass max_seq, window on and off, bf16 and fp32 q); the training
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
   the new archs' shapes: rows 1 and 2 at G 16 and 48 (Hkv 2 and 1,
   every split count at B 1), row 3 there at B 1, 8 and 20 in head
   chunks, row 4 at D 256 with window and cap and at G 48, row 11 at
   (M, 128, 6144, 48) and (M, 256, 4096, 16) in bf16 and fp32; the other
   arch families' shapes (``phase3_families``): row 4 non-causal at
   seamless-m4t-medium's cross-attention (Sq 1, 17, 300 over Skv 1024,
   D 64, G 1) and encoder (1024 x 1024), row 4 at phi-3-vision's D 96
   over 576 + 64 positions, rows 1, 3 and row 2 over fp8 pages at
   recurrentgemma-9b's local layers (D 256, G 16, Hkv 1, window 2048,
   B 1 and 8), repeats bit-equal;
4. engine parity at granite-3-8b width, 2 layers, fp32, unfused and
   fused, with wide weights and under w8fp8 (int8 projections, fp8
   pages): the kernel path and the plain path give identical greedy
   token streams, through both whole-prompt joins and chunked prefill,
   and the plain path launches nothing;
5. the full run on the cuBLAS path: granite-3-8b at full width and depth
   in bf16, weights from ``--seed``, serving 16 requests (prompts of
   16..300 tokens, 32 new tokens each) through ``PagedEngine`` with page
   64, prefill chunk 64, max_seq 512 and 8 slots, and a short
   torch.profiler window of the same engine (4 of the requests x 4
   tokens; every row 1 launch in it
   on the split tensor-core core, as in phases 6, 9 and 9b for rows 1
   and 2);
6. the blocked path: the same model and requests with the page size and
   prefill chunk left to the blocking model and every projection through
   ``matmul_blocked`` (``ops.blocked_linear``), with its own profiler
   window (every bf16 launch of it on the tensor-core instances) and
   the prefill logits held against the cuBLAS path;
6b. the fused path: phase 6 with ``fuse=True`` (``qkv_fused``,
   ``matmul_fused`` and ``flash_decode_oproj``; the page under the fused
   key), with the same checks and its own profiler window;
15. the observability stack on phase 6b's path (8 of its prompts x 16
   new tokens): served untraced (each ``DramLedger.record`` call timed)
   and with ``Obs(trace=StepTracer, dram=KernelProfiler)``; greedy
   tokens identical, the trace's ``step`` spans holding ``host_prep``,
   ``plan_step`` and ``dispatch.decode``, each per-call key's dispatches
   equal to its kernel's launches, every roofline row with ``min_bytes
   <= hbm_bytes`` and ``peak_frac <= 1.05``; ``python -m
   repro_torch.profile --corrupt matmul`` on the blocked path writes the
   fidelity gate's keys to the miss log and ``tune --from-telemetry
   --dry-run`` lists them (15b, after phase 11: its blocked training for
   2 steps with and without ``obs``, step-0 loss within 2%, the
   ``train_step`` scope's GEMM keys' dispatches equal to rows 6-8's
   launches);
16. the serving features: (a) at granite-3-8b width, 2 layers, fp32,
   unfused, fused and w8fp8, speculative decode at k = 2 and 4 gives
   the tokens of spec off (``mean_accepted > 1``), the prefix cache
   those of the cache off with hits and copy-on-write forks, each on
   the kernel path and the plain path alike; a forced preemption
   restores byte-exact tokens, ``inject_logit_fault`` fails only its
   request, ``shutdown`` empties the pool, ``engine_smoke`` passes on
   the card; (b) after 15, on the full bf16 model: speculative decode
   k = 2 fused on phase 5's requests and the prefix cache on a zipf(1.2)
   shared-prefix workload (its page priced by ``reuse_hint`` 0.5):
   tok/s, the stats and row 1's launches by q_span; one verify step's
   logits held against the plain path (5% of max |logit|, argmax
   equal);
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
   kernels (and, blocked, dgrad kernels) are the tensor-core ones; then
   3 steps under remat "dots": step 0's loss within 2% of "block"'s,
   step time and peak memory beside it, fewer ``aten.mm`` calls a step;
12. the paper's conv path at full Table-4 size: Conv1..Conv5 and AlexNet
   conv1 (stride 4) at batch 2 in bf16 through ``ops.conv2d`` forward and
   ``torch.autograd.grad`` (dX through row 12, dW through row 13), tiles
   from the model under the three conv keys, held against the fp32
   oracles, launch counts asserted, every wgrad on row 13's tensor-core
   instance, the plain path launching nothing;
14. the static-batch engine (``DecodeEngine``, dense caches, a ring
   buffer for local layers): (a) granite-3-8b, glm4-9b, granite-34b and
   gemma2-9b at full width, 2 layers, fp32 (gemma2's 4064-token prompts
   and 40 new tokens wrap its ring at step 32): the kernel path, the
   plain path
   and the paged engine give identical greedy tokens, unfused and fused,
   with the launch counts of each; (b) gemma2-9b at full width, 14 of
   its 42 layers (7 local, 7 global; the depth cut to keep the run
   inside its time limit), in bf16, 4 prompts of 4000 tokens and 128 new ones through both
   engines (the ring wraps at step 96): tok/s, peak memory, a profiled
   window each, the prefill logits against the plain path and a step
   past the wrap (dense cache against paged) within 5% of max |logit|;
   (c) glm4-9b and granite-34b at full width, 4 layers, bf16, both
   engines unfused and fused, each path's prefill logits and paged
   decode logits (row 3 at G 16 and 48 when fused) against the plain
   path within 5% of max |logit|; and glm4-9b under w8fp8 (int8
   projections, an fp8 dense cache) through the static engine, unfused
   and fused, its prefill and one decode step's logits held against the
   plain path;
13b. (after 13) the six new archs' reduced configs (MoE, SSD, the
   RG-LRU hybrid, encoder-decoder, vision prefix), fp32: the static
   engine's kernel path against its plain path, and the paged engine's
   for the four decoder-only ones, tokens identical, unfused and fused;
   3 bf16 training steps each (step 0 within 2% of the plain path);
   their launchers' usage lines;
17. the other arch families, after 14: (a) a gate: phi3.5-moe,
   qwen3-moe, mamba2-780m, recurrentgemma-9b (3 layers: one local),
   seamless-m4t-medium and phi-3-vision at full width, 2 layers, fp32,
   2 prompts x 300 tokens + 16 (recurrentgemma 2100, past its 2048
   window): the static engine's kernel path and plain path, and the
   paged engine's for the four decoder-only archs, unfused and fused,
   recurrentgemma also under w8fp8, greedy tokens identical, the launch
   counts of each path; (b) the five but qwen3-moe at full width in
   bf16 (phi3.5-moe at 8 of 32 layers, the rest at full depth): the
   static engine on 8 x 512 + 32 and the paged engine on 8 requests of
   64-512 + 32 where the family has it: tok/s, peak memory, the prefill
   logits against the plain path within 5% of max |logit|;
18. the last single-card modules: (a) after 9's ``quantize_params``,
   ``quant.logit_report`` on the full bf16 granite against its int8
   projections (2 x 128 tokens from ``--seed``): its four numbers, row
   10 launched on each quantized projection of every layer and row 4
   once a layer per tree, nothing else; the quantized tree's logits on
   the kernel path held against its plain path (5% of max |logit|,
   argmax equal), and the bf16 tree against itself reporting no error;
   (b) ``AbsMaxCalibrator`` (absmax and EMA 0.9) over the final hidden
   state of three full-width bf16 forwards, its statistics on the card
   and equal to a host reduction's, its int8 and fp8 scales the scale
   rule over them (EMA within 1e-6 relative); (c) after 17, the four ``examples/*_torch.py`` as
   processes of their own, all at once: ``serve_lm_torch`` matches the
   static engine on its three archs, ``train_lm_torch`` converges and
   restarts, ``quickstart_torch`` exits 0, ``schedule_search_torch
   --layer Conv4 --hopper --measure`` tunes into a temporary cache; then
   a fresh process on that cache runs ``ops.conv2d`` on Conv4 with the
   cached tiles (row 12, held against its plain version at phase 12's
   gate); an ``examples`` JSON line; (d) ``optimize_fused`` for
   granite's SwiGLU MLP at the card's per-block budget (decode and the
   fused engine's prefill chunk), its top result's bytes equal to
   ``fused_dram_bytes``;
19. distribution, after 15b: (a) rows 4 and 5 at the production
   mesh's local head shapes (``TP_HEADS``: 2, 2, 3 and 1 query heads on
   one kv head) against their plain versions, then the sharded train
   step (``make_train_step(..., mesh=)``) on a one-rank NCCL mesh:
   granite-3-8b at full width, 4 of 40 layers, bf16, remat "block", 4 x
   512 tokens, 3 steps under ``tp_fsdp``, ``fsdp``, ``tp_fsdp`` with
   compressed gradients and ``tp_fsdp`` with blocked linears, each
   step's loss within 0.5% of the unsharded step's from the same params
   and batches, the largest parameter difference after step 3, the
   launch counts held as phase 11 holds them; (b) ``launch.train
   --reduced --steps 3`` under ``torch.distributed.run`` (one rank) and
   alone, the same final loss; (c) the dry run of granite-3-8b on 16 x
   16 (train_4k under both parallelisms, decode_32k) in processes of
   their own ((b) and (c) start after phase 2, beside phase 3):
   collective bytes by kind, argument bytes per rank equal
   to the local shards' bytes, fsdp's total below tp_fsdp's; a
   ``distributed`` JSON line;
7. ``tune_op`` on the decode GEMM shape, the decode QKV pass and Conv4
   into a temporary cache;
8. each kernel timed at the shapes of phases 6, 6b, 9, 9b, 11 and 12
   beside its bound, its plain version and a library call (rows 1 and 2
   and the chunk with their grid: splits, cluster, blocks; rows 4 and 5
   with their tiles, TFLOP/s, share of the bound and ratio to SDPA, and
   at S 2048 and 8192 beside SDPA, each pass's kernel time; rows 7 and 8
   at all four projection shapes with the model's tiles, TFLOP/s, share
   of the bound, ratio to ``torch.matmul``, two and three stages);
   rows 12 and 13 at Conv1 and Conv4 with TFLOP/s and share of the bound
   (row 13 with its instance and ratio to ``conv2d_weight``); row 12's
   forward and dgrad and row 13 at all six conv layers; rows 3 and 11 at
   glm4-9b's and granite-34b's decode (row 11 in fp32 and bf16) with
   their grids and shared memory.

Phase 3's row 9 runs granite's and ``WIDE_MLP``'s projections with wide
and int8 weights alike.  The last two lines are a JSON ``{"kernels":
[...]}`` record and
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
            atol: float | None = None, quiet: bool = False) -> float:
    """Max abs error of ``out`` vs ``ref``; raises past the tolerance
    (``quiet``: prints only then)."""
    import torch
    atol, rtol = atol or TOL[dtype_name][0], TOL[dtype_name][1]
    out, ref = out.float(), ref.float()
    err = float((out - ref).abs().max())
    ok = bool(torch.all((out - ref).abs() <= atol + rtol * ref.abs()))
    if not quiet or not ok:
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


def phase3_wide_groups(dev) -> None:
    """The new archs' shapes, each kernel against its plain version:
    rows 1 and 2 at glm4-9b's (Hkv 2, G 16) and granite-34b's (Hkv 1, G
    48) grouping, decode and a 16-token chunk, window and cap, every split
    count at B 1 (bf16); row 3 there at B 1, 8 and 20 (its query heads in
    ``oproj_chunks`` partials), fp32 and bf16, repeats bit-equal, the
    slice counters left zero; row 4 at gemma2-9b's D 256 with its window
    (4096, here 300) and cap (50), at glm4-9b's (Hq 32, Hkv 2) and at
    granite-34b's G 48; row 11 at (M, 128, 6144,
    48) and (M, 256, 4096, 16), bf16 and fp32 (bn below 64), under every
    adapter tile."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    bf16 = torch.bfloat16
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[1]
        for hkv, g, e in ((2, 16, 4096), (1, 48, 6144)):
            for q_span in (1, 16):
                for window, cap in ((None, None), (37, 50.0)):
                    lengths = [1, 33, 130, 300]
                    args = paged_inputs(dev, dtype, lengths, q_span,
                                        seed=g + q_span, hkv=hkv, g=g,
                                        page=32, n_blocks=16)
                    kw = dict(window=window, logit_cap=cap, q_span=q_span)
                    out = FD.flash_decode(*args, **kw)
                    assert torch.equal(out, FD.flash_decode(*args, **kw))
                    ref = FD.paged_attention_ref(*args, **kw)
                    tag = (f"flash_decode {dn} Hkv={hkv} G={g} "
                           f"q_span={q_span} window={window} cap={cap}")
                    compare(tag, out, ref, dn)
                    f8 = fp8_paged(paged_inputs(
                        dev, torch.float32, lengths, q_span, seed=g,
                        hkv=hkv, g=g, page=32, n_blocks=16), seed=g,
                        unit=window is None)
                    f8 = (f8[0].to(dtype),) + f8[1:]
                    out8 = FD.flash_decode_fp8(*f8, **kw)
                    assert torch.equal(out8, FD.flash_decode_fp8(*f8, **kw))
                    ref8 = FD.paged_attention_fp8_ref(*f8, **kw)
                    compare(tag.replace("flash_decode", "flash_decode_fp8"),
                            out8, ref8, dn)
                    if dtype == bf16 and window is None:
                        one = paged_inputs(dev, bf16, [450], q_span, seed=g,
                                           hkv=hkv, g=g, page=32,
                                           n_blocks=16)
                        check_decode_splits(
                            FD.flash_decode, one,
                            FD.paged_attention_ref(*one, **kw), dn,
                            f"{tag} B=1", **kw)
            for b in (1, 8, 20):
                lengths = [(97 * i + 13) % 512 + 1 for i in range(b)]
                args = oproj_inputs(dev, dtype, lengths, seed=g + b,
                                    page=32, hkv=hkv, g=g, e=e)
                for window, cap in ((None, None), (37, 50.0)):
                    kw = dict(window=window, logit_cap=cap)
                    out = FD.flash_decode_oproj(*args, **kw)
                    assert torch.equal(out, FD.flash_decode_oproj(*args,
                                                                  **kw))
                    assert not FD._COUNTERS[out.device].any()
                    smem = FD.oproj_smem_bytes_required(
                        32, g, 128, dtype.itemsize, batch=b)
                    chunks = FD.oproj_chunks(g, 128, b)
                    compare(f"flash_decode_oproj {dn} B={b} Hkv={hkv} G={g} "
                            f"E={e} window={window} cap={cap} (grid "
                            f"{FD.oproj_grid(hkv, e, chunks)} x {hkv} x "
                            f"{chunks} chunks of "
                            f"{FD.oproj_head_chunk(g, 128, b)}, {smem} B "
                            f"shared)", out,
                            FD.paged_attention_oproj_ref(*args, **kw), dn,
                            gemm_atol(dn, hkv * g * 128))
        for b, sq, hq, hkv, d, window, cap in (
                (1, 400, 16, 8, 256, 300, 50.0), (2, 130, 16, 8, 256, None,
                                                  50.0),
                (1, 300, 32, 2, 128, None, None),
                (1, 200, 48, 1, 128, None, None)):
            check_attention_edge(dev, dtype, b, sq, sq, hq, hkv, d, True,
                                 window, cap)
        for m in (1, 8, 24, 512):
            for nkv, k, g in ((128, 6144, 48), (256, 4096, 16)):
                check_qkv(dev, dtype, m, nkv, k, g)
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
                out = FD.flash_decode(*args, **kw)
                assert torch.equal(out, FD.flash_decode(*args, **kw))
                compare(f"flash_decode {dn} q_span={q_span} window={window}"
                        f" cap={cap} {FD.flash_decode.instance}", out,
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


def check_decode_splits(fn, args, ref, dn: str, tag: str, **kw) -> None:
    """Row 1 or 2 (``fn``) with bf16 q rows at every split count from 1
    to the most the launch takes (``n_blocks`` and the cluster limit),
    each recorded as the tensor-core core, repeats bit-equal, each against
    ``ref``.  The count is forced by patching the wrapper's
    ``decode_grid`` for the call."""
    from unittest import mock

    import torch
    from repro_torch.core.hopper_adapter import default_smem_budget
    from repro_torch.kernels import flash_decode as FD
    q, k_pages, bt = args[0], args[1], args[-2]
    page, d = k_pages.shape[1], q.shape[3]
    two = FD.decode_smem_bytes(page, d, k_pages.element_size()) \
        <= default_smem_budget()
    most = min(bt.shape[1], FD.MAX_CLUSTER if two else 8)
    worst = 0.0
    for s in range(1, most + 1):
        with mock.patch.object(FD, "decode_grid", lambda *a: (s, s, 0)):
            out = fn(*args, **kw)
            assert fn.instance == ("mma", s), fn.instance
            assert torch.equal(out, fn(*args, **kw)), (tag, s)
        worst = max(worst, compare(f"{tag} splits={s}", out, ref, dn,
                                   quiet=True))
    print(f"  {tag}: splits 1..{most}, repeats bit-equal, max_abs_err "
          f"{worst:.3e}")


def phase3_decode_grid(dev) -> None:
    """Rows 1 and 2's split grid in bf16 (q bf16; pages bf16 or fp8, the
    model's page 32 and fp8 page 64): batches whose grid takes one split
    (24 and 64 rows) and the most (1 row: 16 at page 32, 8 at 64), a
    5-key row whose later splits see nothing, lengths 1 and an exact page
    multiple, decode and a 64-token chunk, window and cap, drawn fp8
    scales, every split count from 1 to the most at B 1 and 8; rows of
    300 pages (the block reloads its page table); each against the plain
    version, repeats bit-equal."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    bf16 = torch.bfloat16
    for batch in (1, 2, 8, 24, 64):
        rng = np.random.default_rng(batch)
        lengths = ([5] if batch == 1 else [1, 64] if batch == 2 else
                   [int(n) for n in rng.integers(1, 450, batch)])
        for q_span in (1, 64):
            for fp8, page in ((False, 32), (True, 64)):
                for window, cap in ((None, None), (37, 30.0)):
                    args = paged_inputs(dev, torch.float32 if fp8 else bf16,
                                        lengths, q_span, seed=batch + page,
                                        page=page, n_blocks=512 // page)
                    fn, plain = FD.flash_decode, FD.paged_attention_ref
                    if fp8:
                        args = fp8_paged(args, seed=batch, unit=False)
                        args = (args[0].to(bf16),) + args[1:]
                        fn, plain = FD.flash_decode_fp8, \
                            FD.paged_attention_fp8_ref
                    kw = dict(window=window, logit_cap=cap, q_span=q_span)
                    q, kp = args[0], args[1]
                    grid = FD.decode_grid(batch, q.shape[1], q.shape[2],
                                          page, 512 // page, q.shape[3],
                                          kp.element_size())
                    out = fn(*args, **kw)
                    assert fn.instance == ("mma", grid[0]), fn.instance
                    assert torch.equal(out, fn(*args, **kw))
                    ref = plain(*args, **kw)
                    tag = (f"{fn.__name__} B={batch} q_span={q_span} "
                           f"page={page} window={window} cap={cap} grid "
                           f"(splits, cluster, blocks) {grid}")
                    compare(tag, out, ref, "bfloat16")
                    if batch in (1, 8) and window is None:
                        check_decode_splits(fn, args, ref, "bfloat16", tag,
                                            **kw)
    # rows of 300 pages of 16 keys: a run longer than the block's 128 page
    # indices reloads them, and with a window the run starts past them
    for window in (None, 100):
        for q_span in (1, 4):
            args = paged_inputs(dev, bf16, [4797, 2000, 9], q_span,
                                seed=q_span, hkv=2, page=16, n_blocks=300)
            kw = dict(window=window, q_span=q_span)
            out = FD.flash_decode(*args, **kw)
            assert torch.equal(out, FD.flash_decode(*args, **kw))
            ref = FD.paged_attention_ref(*args, **kw)
            tag = (f"flash_decode B=3 lengths 4797, 2000, 9 page=16 "
                   f"q_span={q_span} window={window}")
            compare(tag, out, ref, "bfloat16")
            check_decode_splits(FD.flash_decode, args, ref, "bfloat16", tag,
                                **kw)
    torch.cuda.synchronize()


def phase3_verify_spans(dev) -> dict:
    """Rows 1 and 2 at the speculative verify's shape: B 8 (the engine's
    max_batch), q_span 2..5 (k = 1..4 drafts), granite's Hkv 8, G 4, D
    128, at the unfused and fused engines' pages for max_seq 512 (row 2:
    the fp8 engine's) and page 16; lengths ragged, one slot at 1 and one
    at 510, whose last rows pass max_seq (their keys end at the table's
    512, as the engine's spans do); window off and 37; q bf16 (the split
    core) and fp32; each against its plain version, repeats bit-equal.
    Returns the pages checked."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve import kv_cache as KV
    cfg = get_config("granite-3-8b")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    pages = {"flash_decode": sorted({KV.choose_page_size(cfg, 512),
                                     KV.choose_page_size(cfg, 512,
                                                         fused=True), 16}),
             "flash_decode_fp8": sorted({KV.choose_page_size(cfg8, 512),
                                         16})}
    rng = np.random.default_rng(11)
    lengths = [1, 510] + [int(n) for n in rng.integers(2, 500, 6)]
    worst, ran = {}, {}
    for name, fp8 in (("flash_decode", False), ("flash_decode_fp8", True)):
        fn = getattr(FD, name)
        plain = FD.paged_attention_fp8_ref if fp8 else FD.paged_attention_ref
        for page in pages[name]:
            nb = -(-512 // page)
            for q_span in (2, 3, 4, 5):
                for dtype in (torch.bfloat16, torch.float32):
                    args = list(paged_inputs(dev, dtype, [1] * 8, q_span,
                                             seed=page + q_span, page=page,
                                             n_blocks=nb))
                    # a shuffled table, scratch past each slot's span
                    bt = (1 + rng.permutation(8 * nb)).reshape(8, nb)
                    for i, n in enumerate(lengths):
                        bt[i, min(nb, -(-(n + q_span - 1) // page)):] = 0
                    args[3] = torch.tensor(bt, dtype=torch.int32,
                                           device=dev)
                    args[4] = torch.tensor(lengths, dtype=torch.int32,
                                           device=dev)
                    if fp8:
                        args = list(fp8_paged(tuple(args), seed=page,
                                              unit=False))
                    dn = str(dtype).split(".")[1]
                    for window in (None, 37):
                        kw = dict(window=window, q_span=q_span)
                        out = fn(*args, **kw)
                        ran.setdefault(name, set()).add((dn, fn.instance))
                        assert torch.equal(out, fn(*args, **kw)), \
                            (name, page, q_span, dn, window)
                        tag = (f"{name} verify B=8 q_span={q_span} "
                               f"page={page} {dn} window={window}")
                        err = compare(tag, out, plain(*args, **kw), dn,
                                      quiet=True)
                        worst[name] = max(worst.get(name, 0.0), err)
            print(f"  {name} verify spans B=8 q_span 2..5 page={page}, "
                  f"bf16 and fp32 q, window off and 37, lengths "
                  f"{lengths}: repeats bit-equal, held to plain")
        assert {i[0] for dn, i in ran[name] if dn == "bfloat16"} == {"mma"}
    seen = sorted(map(str, set().union(*ran.values())))
    print(f"  verify spans: max_abs_err {worst}; (q dtype, instance) {seen}")
    torch.cuda.synchronize()
    return pages


GRANITE_MLP = (("gate", 12800, 4096, dict(act="silu")),
               ("up", 12800, 4096, dict(mul=True)),
               ("down", 4096, 12800, dict(residual=True)))
# the dense archs' MLPs beside granite's (phase 14 runs them fused):
# glm4-9b's SwiGLU and granite-34b's GELU MLP
WIDE_MLP = (("glm4-9b gate", 13696, 4096, dict(act="silu")),
            ("glm4-9b up", 13696, 4096, dict(mul=True)),
            ("glm4-9b down", 4096, 13696, dict(residual=True)),
            ("granite-34b up", 24576, 6144, dict(act="gelu")),
            ("granite-34b down", 6144, 24576, dict(residual=True)))


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
                 e=4096, n_blocks=None):
    """``paged_inputs`` at q_span 1 (``n_blocks`` pages a request, 512
    positions' worth by default) plus a (Hkv, G*D, E) wo scaled so every
    output is O(1)."""
    import torch
    args = paged_inputs(dev, dtype, lengths, 1, seed, hkv=hkv, g=g, d=d,
                        page=page, n_blocks=n_blocks or -(-512 // page))
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
    bit-equal, and ``WIDE_MLP``'s the same way (an int8 W too: their N
    are multiples of 16).  bf16 asserts the instance: ``"mma_t"`` at M <= 16,
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
        for name, n, k, epi_kw in GRANITE_MLP + WIDE_MLP:
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
    (decode) or mma instance, row 1's chunks on the split tensor-core
    core.  Training, bf16: 3 steps on the default path (rows 4 and 5
    forward and backward), finite losses, step 0's loss within 2%
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
    from repro_torch.kernels import flash_decode as FD
    chunks = FD.flash_decode.launches
    try:
        reqs = serve(cfgb, paramsb, prompts, 8, max_batch=4, fuse=True)
    finally:
        for name in kinds:
            setattr(ops, f"_{name}_kernel", real[name])
    # the chunks' row 1 launches: bf16 q rows run the split core
    chunks = FD.flash_decode.launches - chunks
    assert chunks > 0 and FD.flash_decode.instance[0] == "mma", \
        (chunks, FD.flash_decode.instance)
    assert all(len(r.output) == 8 and int(r.output.max()) < cfgb.vocab
               for r in reqs)
    for name, seen in kinds.items():
        assert seen == {(True, "mma_t"), (False, "mma")}, (name, seen)
    print(f"  bf16 fuse=True: 6 requests x 8 tokens; rows 9 and 11 on "
          f"{sorted(k for _, k in kinds['matmul_fused'])} and "
          f"{sorted(k for _, k in kinds['qkv_fused'])}; row 1 ({chunks} "
          f"chunk launches) on {FD.flash_decode.instance}; first tokens "
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


def hold_logits(name: str, got, want, what: str = "prefill logits") -> dict:
    """``got`` against ``want`` within 5% of the largest |logit|."""
    import torch
    dev_ = float((got - want).abs().max())
    scale = float(want.abs().max())
    same = int(got.argmax()) == int(want.argmax())
    print(f"  full-width {what}, {name}: max |diff| {dev_:.3e} of "
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
    # 4 requests x 4 tokens: this path's events (page and chunk 64, every
    # projection a library call) cost the profiler 80 s of processing at
    # 8 x 8, a twelfth of the run's limit
    summary["profile"] = profile_window(engine_for(cfg, params, max_batch=8),
                                        prompts[:4], 4)
    hold_decode_core(summary["profile"], "flash_decode")
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
        hold_decode_core(summary["profile"], "flash_decode")
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


def nested(inner: dict, outer: dict) -> bool:
    """Whether Chrome-trace span ``inner`` lies inside ``outer``."""
    return (outer["ts"] - 1e-3 <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1e-3)


def hold_roofline(rep: dict, what: str, bound: float | None = 1.05) -> dict:
    """Print each dispatched key's roofline row; every row has
    ``min_bytes <= hbm_bytes`` and a measured ``peak_frac`` (at most
    ``bound``: above it a count or a time is wrong; nothing is clamped).
    Returns the rows without their tiles' energy split."""
    rows = {}
    for key, r in rep["per_op"].items():
        print(f"    {what} {key}: tiles {r['tiles']} ({r['source']}), "
              f"{r['dispatches']} dispatches, hbm_bytes {r['hbm_bytes']}, "
              f"min_bytes {r['min_bytes']}, time {r['time_us']:.1f} us, "
              f"bound {r['bound_us']:.1f} us ({r['bound']}), peak_frac "
              f"{r['peak_frac']:.4f}, fidelity {r['fidelity_ratio']}")
        assert r["min_bytes"] <= r["hbm_bytes"], (key, r)
        assert r["peak_frac"] is not None and r["peak_frac"] > 0, (key, r)
        assert bound is None or r["peak_frac"] <= bound, (key, r)
        rows[key] = {k: v for k, v in r.items() if k != "energy_split"}
    return rows


# ------------------------- serving features (phase 16) ----------------------


class SpanCounts:
    """Rows 1 and 2's launches by ``q_span`` while it is entered: the
    ops' references to the two wrappers are swapped for counting ones
    (each wrapper's own ``launches`` still counts every launch)."""

    def __init__(self):
        self.counts: dict[str, dict[int, int]] = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._real = {n: getattr(ops, n) for n in ("flash_decode",
                                                    "flash_decode_fp8")}

        def spy(name):
            real = self._real[name]

            def launch(*args, q_span=1, **kw):
                per = self.counts.setdefault(name, {})
                per[q_span] = per.get(q_span, 0) + 1
                return real(*args, q_span=q_span, **kw)
            return launch
        for name in self._real:
            setattr(ops, name, spy(name))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self._real.items():
            setattr(ops, name, fn)


def feature_run(engine, prompts, n_tokens: int, kernels: dict,
                hook=None) -> tuple[list, dict, dict]:
    """Serve ``prompts`` on ``engine`` with every launch count at 0 just
    before (``hook(engine, steps, rids)`` after every step); returns the
    finished requests in submission order, the launches and rows 1 and
    2's launches by q_span."""
    reset(kernels)
    with SpanCounts() as spans:
        rids = [engine.submit(p, n_tokens) for p in prompts]
        done, steps = {}, 0
        while engine.has_work:
            steps += 1
            for r in engine.step():
                done[r.rid] = r
            if hook is not None:
                hook(engine, steps, rids)
            assert steps < 500, "the engine failed to drain"
    return [done[r] for r in rids], counts(kernels), spans.counts


def same_tokens(what: str, got: list, want: list) -> None:
    for g, w in zip(got, want):
        if not np.array_equal(g.output, w.output):
            raise AssertionError(f"{what}, request {g.rid}: "
                                 f"{g.output.tolist()} != {w.output.tolist()}")


def phase16_gate(seed: int, kernels: dict) -> dict:
    """The serving features at granite-3-8b width, 2 layers, fp32, page
    64, chunk 64, max_seq 512, 4 slots, unfused, fused and w8fp8: on the
    kernel path, speculative decode at k = 2 and 4 gives the tokens of
    spec off with ``mean_accepted > 1`` (prompts of a repeated motif),
    and the prefix cache on a shared 128-token prefix (two exact
    full-page matches, so the copy-on-write fork runs) the tokens of the
    cache off with hits; k = 2 and the prefix cache on the plain path
    give the kernel path's tokens, launching nothing.  Unfused: a forced
    preemption restores byte-exact tokens, ``inject_logit_fault`` fails
    only its request, ``shutdown`` leaves the pool empty, and
    ``engine_smoke(device="cuda")`` passes."""
    import torch
    from repro_torch.chaos import engine_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.quant import quantize_params
    from repro_torch.serve import kv_cache as KV
    from repro_torch.serve.lifecycle import RequestStatus
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                              dtype=torch.float32)
    params = T.init_params(cfg, seed=seed, device="cuda")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    qparams = quantize_params(params)
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, cfg.vocab, (7,), dtype=np.int32)
    spec_prompts = [np.tile(motif, 10)[:n] for n in (30, 61, 9)] + \
        [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in (20, 70)]
    pre = rng.integers(0, cfg.vocab, (128,), dtype=np.int32)
    prefix_prompts = [np.concatenate([pre, rng.integers(
        0, cfg.vocab, (n,), dtype=np.int32)]) for n in (5, 40, 70)] + \
        [pre.copy(), pre.copy()]
    forks = []
    fork_page = KV.fork_page
    KV.fork_page = lambda cache, s, d: (forks.append((s, d)),
                                        fork_page(cache, s, d))
    out = {}
    try:
        for mode, c, p, fuse in (("wide", cfg, params, False),
                                 ("wide", cfg, params, True),
                                 ("w8fp8", cfg8, qparams, False)):
            tag = f"{mode} fuse={fuse}"
            attn = "flash_decode_fp8" if mode == "w8fp8" else "flash_decode"
            path = ("flash_attention", attn) + (
                ("qkv_fused", "matmul_fused") if fuse else ()) + (
                ("matmul_w8",) if mode == "w8fp8" else ())

            def mk(slots=4, **kw):
                return engine_for(c, p, max_batch=slots, fuse=fuse, **kw)
            ref, _, _ = feature_run(mk(), spec_prompts, 16, kernels)
            row = {}
            for k in (2, 4):
                eng = mk(spec_decode=k)
                got, launched, spans = feature_run(eng, spec_prompts, 16,
                                                   kernels)
                same_tokens(f"{tag} spec k={k} against spec off", got, ref)
                st = eng.spec_stats()
                assert st["mean_accepted"] > 1, st
                assert min(launched[n] for n in path) > 0, launched
                assert spans[attn].get(k + 1, 0) > 0, spans
                row[f"spec_{k}"] = {"spec_stats": st, "spans": spans,
                                    "launches": {n: launched[n]
                                                 for n in path}}
                print(f"  {tag} spec k={k}: 5 requests x 16 tokens "
                      f"identical to spec off; {st}; {attn} launches by "
                      f"q_span {spans[attn]}")
            plain, launched, _ = feature_run(
                mk(spec_decode=2, use_kernel=False), spec_prompts, 16,
                kernels)
            assert not any(launched.values()), launched
            same_tokens(f"{tag} spec k=2, plain against kernel path", plain,
                        ref)
            # 2 slots: the first two prompts miss and register the
            # prefix, the next three hit it (two of them exactly)
            off, _, _ = feature_run(mk(2), prefix_prompts, 12, kernels)
            eng = mk(2, prefix_cache=True)
            n_forks = len(forks)
            got, launched, spans = feature_run(eng, prefix_prompts, 12,
                                               kernels)
            n_forks = len(forks) - n_forks
            st = eng.prefix_stats()
            same_tokens(f"{tag} prefix cache against the cache off", got,
                        off)
            assert st["hits"] > 0 and n_forks > 0, (st, forks)
            # prompts past the 64-token chunk: misses and hits alike
            # prefill through the span path
            assert launched[attn] > 0, launched
            plain, launched, _ = feature_run(
                mk(2, prefix_cache=True, use_kernel=False), prefix_prompts,
                12, kernels)
            assert not any(launched.values()), launched
            same_tokens(f"{tag} prefix cache, plain against kernel path",
                        plain, got)
            row["prefix"] = {"prefix_stats": st, "forks": n_forks,
                             "spans": spans}
            print(f"  {tag} prefix cache: 5 requests x 12 tokens identical "
                  f"to the cache off and to the plain path; {st}; "
                  f"{n_forks} copy-on-write forks; {attn} "
                  f"launches by q_span {spans[attn]}")
            out[tag] = row
    finally:
        KV.fork_page = fork_page
    # the lifecycle, unfused
    ref, _, _ = feature_run(engine_for(cfg, params, max_batch=2), spec_prompts,
                            16, kernels)
    target = []

    def preempt(eng, steps, rids):
        if steps >= 2 and not target:
            cands = [r for r in eng.scheduler.running.values()
                     if r.max_new_tokens - r.generated > 0]
            if cands:
                target.append(max(cands, key=lambda r: r.rid).rid)
                assert eng.preempt(target[0])
    eng = engine_for(cfg, params, max_batch=2, preempt=True,
                     prefix_cache=True)
    got, _, _ = feature_run(eng, spec_prompts, 16, kernels, preempt)
    same_tokens("forced preemption against the undisturbed run", got, ref)
    assert got[target[0]].status is RequestStatus.PREEMPTED_RETRIED
    poisoned = []

    def poison(eng, steps, rids):
        if not poisoned and any(r.rid == rids[0] and r.decode_ready
                                for r in eng.scheduler.running.values()):
            eng.inject_logit_fault(rids[0])
            poisoned.append(steps)
    eng = engine_for(cfg, params, max_batch=2, nan_guard=True)
    got, _, _ = feature_run(eng, spec_prompts, 16, kernels, poison)
    assert got[0].status is RequestStatus.FAILED, got[0].status
    assert np.array_equal(got[0].output, ref[0].output[:len(got[0].output)])
    assert all(r.status is RequestStatus.OK for r in got[1:])
    same_tokens("requests beside the poisoned one", got[1:], ref[1:])
    eng = engine_for(cfg, params, max_batch=2, prefix_cache=True)
    for q in spec_prompts:
        eng.submit(q, 16)
    for _ in range(2):
        eng.step()
    drained = eng.shutdown()
    assert eng.scheduler.allocator.in_use() == 0 and not eng.has_work
    smoke = engine_smoke(seed=seed, device="cuda")
    out["lifecycle"] = {"preempted": target[0],
                        "poisoned_tokens": len(got[0].output),
                        "shutdown": sorted(r.status.value for r in drained),
                        "engine_smoke": smoke}
    print(f"  unfused: rid {target[0]} preempted at step 2 and restored "
          f"byte-exact; rid 0 poisoned FAILED after {len(got[0].output)} "
          f"clean tokens, the rest OK and exact; shutdown drained "
          f"{len(drained)} requests to an empty pool; engine_smoke "
          f"(reduced, cuda): {smoke}")
    del params, qparams
    torch.cuda.empty_cache()
    return out


def zipf_prefix_workload(cfg, n: int, seed: int) -> list:
    """``n`` prompts over 4 shared 192-token prefixes drawn with zipf(1.2)
    popularity, each with its own tail of 8..64 tokens."""
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, cfg.vocab, (192,), dtype=np.int32)
            for _ in range(4)]
    pick = np.minimum(rng.zipf(1.2, n), len(pool)) - 1
    return [np.concatenate([pool[i], rng.integers(
        0, cfg.vocab, (int(t),), dtype=np.int32)])
        for i, t in zip(pick, rng.integers(8, 65, n))]


def phase16_full(cfg, params, prompts, kernels) -> dict:
    """The serving features on the full granite-3-8b in bf16 (the model
    of phases 5-15), max_seq 512, 8 slots, the blocking model's page and
    chunk, the fused path: speculative decode at k = 2 over phase 5's 16
    prompts x 32 tokens; the prefix cache on a zipf(1.2) shared-prefix
    workload of 16 requests x 32 tokens, its page priced by
    ``reuse_hint`` 0.5; each timed on a fresh engine after an untimed
    pass; tok/s, ``spec_stats``, ``prefix_stats``, ``lifecycle_stats``
    and row 1's launches by q_span of each; then one
    verify step's logits at B 8, q_span 3, kernel path against plain,
    within 5% of max |logit| with argmax equal."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_cache as KV
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig

    def mk(**kw):
        return PagedEngine(cfg, params, PagedServeConfig(
            max_seq=512, max_batch=8, device="cuda", **kw))
    out = {}
    n_layers = cfg.n_layers
    for name, kw, work in (
            ("spec", dict(fuse=True, spec_decode=2), prompts),
            ("prefix", dict(fuse=True, prefix_cache=True, reuse_hint=0.5),
             zipf_prefix_workload(cfg, 16, 16))):
        # an untimed pass first: the verify span's and the prefix tails'
        # projection shapes (M = 24; 16, 32, 64) are new to the tuner
        feature_run(mk(**kw), work, 32, kernels)
        eng = mk(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs, launched, spans = feature_run(eng, work, 32, kernels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()["engine"]
        for r in reqs:
            assert r.status.value == "ok" and len(r.output) == 32, r.rid
            assert 0 <= r.output.min() and r.output.max() < cfg.vocab
        tokens = sum(len(r.output) for r in reqs)
        assert launched["flash_attention"] == n_layers * snap["joins"]
        assert launched["flash_decode"] + launched["flash_decode_oproj"] \
            == n_layers * (snap["prefill_chunks"] + snap["decode_steps"]
                           + snap["verify_steps"]), (launched, snap)
        if name == "spec":
            assert launched["qkv_fused"] > 0 and \
                launched["matmul_fused"] > 0, launched
            assert spans["flash_decode"].get(3, 0) == \
                n_layers * snap["verify_steps"], spans
        row = {"tok_per_s": tokens / wall, "wall_s": wall,
               "page": eng.page_size, "prefill_chunk": eng.prefill_chunk,
               "spec_stats": eng.spec_stats(),
               "prefix_stats": eng.prefix_stats(),
               "lifecycle_stats": eng.lifecycle_stats(),
               "spans": spans, "launches": launched,
               "verify_steps": snap["verify_steps"],
               "decode_steps": snap["decode_steps"],
               "prefill_chunks": snap["prefill_chunks"],
               "joins": snap["joins"]}
        if name == "prefix":
            assert row["prefix_stats"]["hits"] > 0, row["prefix_stats"]
            assert eng.page_size == KV.reuse_priced_page(
                KV.choose_page_size(cfg, 512, fused=True), 512, 0.5)
        out[name] = row
        print(f"  {name} ({kw}): 16 requests, {tokens} tokens in "
              f"{wall:.3f}s = {tokens / wall:.1f} tok/s; page "
              f"{eng.page_size}, chunk "
              f"{eng.prefill_chunk}; joins {snap['joins']}, chunks "
              f"{snap['prefill_chunks']}, decode steps "
              f"{snap['decode_steps']}, verify steps {snap['verify_steps']}")
        print(f"    spec_stats {row['spec_stats']}; prefix_stats "
              f"{row['prefix_stats']}; lifecycle_stats "
              f"{row['lifecycle_stats']}; row 1 launches by q_span "
              f"{spans.get('flash_decode')}")
        del eng
        torch.cuda.empty_cache()
    # one verify step's logits, kernel path against plain, at B 8
    eng = mk(fuse=True, spec_decode=2)
    for q in prompts[:8]:
        eng.submit(q, 32)
    eng.step()                      # admission, joins and one verify chunk
    assert len(eng.scheduler.running) == 8
    feed = torch.cat([eng._cur_tok[:, None],
                      eng._drafts(eng._lengths).clamp(min=0)], dim=1)
    logits = {}
    for use_kernel in (True, False):
        attn = KV.make_paged_span_step(cfg, eng._block_tables,
                                       eng.page_size, 512, use_kernel)
        with torch.no_grad(), ops.fused_ops(True):
            lg, _ = T.decode_step(cfg, params, feed, eng.cache,
                                  eng._lengths, attn, use_kernel=use_kernel)
        logits[use_kernel] = lg[..., :cfg.vocab].float()
    out["verify_logits"] = hold_logits("verify step B=8 q_span=3, kernels "
                                       "vs plain", logits[True],
                                       logits[False], "verify logits")
    del eng, logits
    torch.cuda.empty_cache()
    return out


def phase15_observed(cfg, params, prompts, kernels) -> dict:
    """The observability stack on phase 6b's path: granite-3-8b at full
    width and depth, bf16, fused, blocked ``wo``, 8 of phase 5's prompts
    x 16 new tokens, served twice on fresh engines: with the default
    ``Obs()`` (tracer off; each ``DramLedger.record`` call timed on the
    host clock, repeats apart from first resolutions) and with
    ``Obs(trace=StepTracer, dram=KernelProfiler)``.
    The greedy tokens are identical; the trace parses, and its ``step``
    spans hold ``host_prep``, ``plan_step`` and ``dispatch.decode``; each
    per-call key's dispatches equal its kernel's launches over the run
    (``qkv_fused``, ``matmul_fused``, and ``matmul`` for row 6's wo);
    every row has ``min_bytes <= hbm_bytes`` and ``peak_frac <= 1.05``.
    Then ``python -m repro_torch.profile --corrupt matmul`` on the
    blocked path (bf16, 48-token prompts): the fidelity gate writes the
    miss log, and ``python -m repro_torch.tune --from-telemetry LOG
    --dry-run`` lists every flagged key."""
    import contextlib
    import io
    import tempfile

    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import (KernelProfiler, MetricsRegistry, Obs,
                                 StepTracer, read_miss_log)
    from repro_torch.profile import main as profile_main
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    from repro_torch.tune.__main__ import main as tune_main

    def engine(obs):
        return PagedEngine(cfg, params, PagedServeConfig(
            max_seq=512, max_batch=8, device="cuda", fuse=True), obs=obs)

    def serve(obs):
        eng = engine(obs)
        torch.cuda.synchronize()
        reset(kernels)
        t0 = time.perf_counter()
        out = eng.generate(prompts[:8], 16)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts(kernels)

    tmp = Path(tempfile.mkdtemp(prefix="phase15_"))
    res = {}
    with ops.blocked_linear():
        plain_obs = Obs()
        led = plain_obs.dram
        record = led.record
        spent = {"first": [0, 0], "repeat": [0, 0]}   # ns, calls

        def timed_record(spec, schedule):
            kind = "repeat" if (spec, schedule.tiles) in led._res \
                else "first"
            t = time.perf_counter_ns()
            record(spec, schedule)
            spent[kind][0] += time.perf_counter_ns() - t
            spent[kind][1] += 1
        led.record = timed_record
        plain, wall0, _ = serve(plain_obs)
        res["record"] = {k: {"calls": n, "us_each": ns / 1e3 / max(n, 1)}
                         for k, (ns, n) in spent.items()}
        rec = res["record"]
        print(f"  untraced: {plain.size} tokens in {wall0:.3f}s "
              f"({plain.size / wall0:.1f} tok/s); DramLedger.record on "
              f"the host clock: {rec['repeat']['calls']} repeat calls at "
              f"{rec['repeat']['us_each']:.3f} us each, "
              f"{rec['first']['calls']} first resolutions at "
              f"{rec['first']['us_each']:.1f} us each")

        reg = MetricsRegistry()
        tracer = StepTracer(tmp / "trace.json")
        prof = KernelProfiler(registry=reg, tracer=tracer, device="cuda")
        obs = Obs(registry=reg, trace=tracer, dram=prof)
        traced, wall1, launches = serve(obs)
        obs.close()
        print(f"  traced (fenced after every dispatch): {traced.size} "
              f"tokens in {wall1:.3f}s ({traced.size / wall1:.1f} tok/s); "
              f"launches {launches}")
        assert np.array_equal(plain, traced), "observation changed tokens"
        events = json.loads((tmp / "trace.json").read_text())
        steps = [e for e in events if e["name"] == "step"]
        for name in ("host_prep", "plan_step", "dispatch.decode"):
            inner = [e for e in events if e["name"] == name]
            assert inner and all(any(nested(e, st) for st in steps)
                                 for e in inner), name
        print(f"  trace: {len(events)} events, {len(steps)} steps; "
              f"host_prep, plan_step and dispatch.decode nested in them")
        rep = prof.roofline_report()
        for prefix, kernel in (("qkv_fused/", "qkv_fused"),
                               ("matmul_fused/", "matmul_fused"),
                               ("matmul/", "matmul_blocked")):
            n = sum(r["dispatches"] for k, r in rep["per_op"].items()
                    if k.startswith(prefix))
            print(f"  {prefix[:-1]}: {n} dispatches, {kernel} "
                  f"{launches[kernel]} launches")
            assert n == launches[kernel] > 0, (prefix, n, launches)
        res["rows"] = hold_roofline(rep, "serve")
        res["totals"] = rep["totals"]
        res["per_tag"] = {t: v["executions"] for t, v in
                          prof.report()["per_tag"].items()}
        res["tok_per_s"] = {"untraced": plain.size / wall0,
                            "traced": traced.size / wall1}

        log = tmp / "miss.jsonl"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            profile_main(["--no-fuse", "--dtype", "bfloat16",
                          "--prompt-len", "48", "--requests", "2", "--gen",
                          "2", "--max-seq", "64", "--corrupt", "matmul",
                          "--miss-log", str(log), "--trace",
                          str(tmp / "corrupt.json"), "--json",
                          str(tmp / "corrupt_roofline.json")])
    flagged = json.loads((tmp / "corrupt_roofline.json").read_text())[
        "fidelity_misses"]
    assert "fidelity gate" in buf.getvalue() and flagged, buf.getvalue()
    assert all(k.startswith("matmul/") for k in flagged), flagged
    targets = read_miss_log(str(log))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tune_main(["--from-telemetry", str(log), "--dry-run"])
    listed = buf.getvalue()
    for key in flagged:
        assert f"would tune {key}" in listed, (key, listed)
    print(f"  --corrupt matmul: fidelity gate flagged {flagged}; the miss "
          f"log holds {len(targets)} targets, all listed by tune "
          f"--from-telemetry --dry-run")
    res["corrupt_flagged"] = flagged
    return res


def phase15_train(seed: int, kernels: dict) -> dict:
    """Phase 11's blocked training (granite-3-8b full width, 4 of 40
    layers, bf16, remat "block", 4 x 512 tokens) for 2 steps through
    ``train.loop.train``, without and with ``Obs(trace=StepTracer,
    dram=KernelProfiler)``: step 0's loss within 2% (observation, not
    perturbation), a ``train_step`` scope per step whose ``matmul`` and
    ``matmul_dgrad`` rows have as many dispatches as rows 6, 7 and 8
    launched, ``min_bytes <= hbm_bytes`` and a measured ``peak_frac``
    (printed: the whole step's wall clock, optimizer and attention
    included, is shared among the GEMM keys)."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.obs import KernelProfiler, Obs, StepTracer
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4,
                              remat="block")
    batches = [make_batch(cfg, 512, 4, s, seed=seed, device="cuda")
               for s in range(2)]
    tc = loop.TrainConfig(opt=adamw.AdamWConfig(lr=3e-3, warmup_steps=0,
                                                total_steps=2),
                          blocked_linear=True, log_every=100)
    quiet = dict(seed=seed, device="cuda", log=lambda *_: None)
    plain = loop.train(cfg, tc, iter(batches), **quiet)["history"]
    torch.cuda.empty_cache()
    path = Path(tempfile.mkdtemp(prefix="phase15_")) / "train.json"
    prof = KernelProfiler(device="cuda")
    obs = Obs(trace=StepTracer(path), dram=prof)
    reset(kernels)
    traced = loop.train(cfg, tc, iter(batches), obs=obs, **quiet)["history"]
    obs.close()
    torch.cuda.empty_cache()
    launches = counts(kernels)
    rel = abs(traced[0] - plain[0]) / abs(plain[0])
    print(f"  step 0 loss traced {traced[0]:.5f} vs untraced {plain[0]:.5f} "
          f"(rel {rel:.2e}, bound 2e-2); step 1 {traced[1]:.5f} vs "
          f"{plain[1]:.5f}")
    assert rel <= 2e-2, (traced, plain)
    rep = prof.roofline_report()
    assert prof.report()["per_tag"]["train_step"]["executions"] == 2
    by_op = {}
    for k, r in rep["per_op"].items():
        by_op[k.split("/")[0]] = by_op.get(k.split("/")[0], 0) + \
            r["dispatches"]
    assert by_op == {"matmul": launches["matmul_blocked"],
                     "matmul_dgrad": launches["matmul_dgrad_a"]
                     + launches["matmul_dgrad_b"]}, (by_op, launches)
    names = {e["name"] for e in json.loads(path.read_text())}
    assert {"step 0", "step 1", "grad", "train"} <= names, names
    print(f"  train_step dispatches {by_op} = rows 6, 7 + 8 launches")
    return {"loss_untraced": plain, "loss_traced": traced,
            "rows": hold_roofline(rep, "train", bound=None)}


def hold_decode_core(profile: dict, row: str) -> float:
    """Every launch of row 1 (``flash_decode``) or 2
    (``flash_decode_fp8``) in a bf16 profiled window ran the tensor-core
    decode core (``decode_mma_kernel``), none the fp32 instance's
    ``attn_rows``; returns the row's device ms."""
    kinds = profile["device_ms_by_kind"]
    assert not any(k.endswith("(fp32)") for k in kinds), kinds
    ms = kinds.get(row, 0.0)
    assert ms > 0, (row, kinds)
    print(f"  {row} in the profiled window: {ms:.3f} ms, every launch on "
          f"the split tensor-core core")
    return ms


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
    hold_decode_core(summary["profile"], "flash_decode_fp8")
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
    if "decode_mma_kernel" in name:   # rows 1 and 2's tensor-core core
        return ("flash_decode_fp8" if "unsigned char" in name
                else "flash_decode")
    if "attn_rows_kernel" in name:
        if "PagedLayout" not in name:
            return "flash_attention"
        return ("flash_decode_fp8 (fp32)" if "unsigned char" in name
                else "flash_decode (fp32)")
    if any(w in name.lower()
           for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    if "elementwise" in name or "reduce_kernel" in name or "copy" in name:
        return "elementwise/copy/reduce"
    return "other"


def profile_window(engine, prompts, n_tokens: int) -> dict:
    """Device busy share and device time by kernel kind over a short run
    of the paged engine traced by torch.profiler (whose overhead inflates
    the host time, so the busy share is a lower bound of the untraced
    one).  Only the card's activity is traced: the host's op events cost
    more than the run to collect (phase 5's window on the H100: 169 s of
    processing for an 8.7 s run) and no number here reads them."""
    for p in prompts:
        engine.submit(p, n_tokens)

    def run():
        while engine.has_work:
            engine.step()
    return profile_call(run, f"{len(prompts)} requests x {n_tokens} tokens")


def profile_call(run, what: str) -> dict:
    """``profile_window``'s trace and summary of one call of ``run``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    post = time.perf_counter() - t0 - wall   # stopping and averaging it
    kinds: dict[str, float] = {}
    top = []
    for e in averages:
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        kinds[kernel_kind(e.key)] = kinds.get(kernel_kind(e.key), 0.0) + us
        top.append((us, e.count, e.key[:90]))
    busy = sum(kinds.values()) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy,
           "busy_share": busy / wall,
           "device_ms_by_kind": {k: v / 1e3 for k, v in sorted(kinds.items())}}
    print(f"  profiled window ({what}): "
          f"wall {wall:.3f}s, device busy {busy:.3f}s "
          f"({100 * busy / wall:.1f}%), the trace's own processing "
          f"{post:.1f}s, by kind (ms) "
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
        grid = FD.decode_grid(8, hkv, hq // hkv, p, -(-512 // p), d)
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
                     f"lengths={dec_lens} bf16; grid (splits, cluster, "
                     f"blocks) {grid}"}
        if p == page:
            out.append(row)
        else:
            print(f"  flash_decode at page {p} (the cuBLAS run's; grid "
                  f"{grid}): {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms")

    # chunked prefill: the third 64-token chunk of a 300-token prompt
    cargs = paged_inputs(dev, bf16, [129], 64, seed=6, page=page,
                         n_blocks=-(-512 // page))
    n_pairs = sum(129 + t for t in range(64))     # causal (row, key) pairs
    c_bytes = 2 * (129 + 63) * hkv * d * 2 + 2 * cargs[0].numel() * 2
    cb_ms, cb_by = bound(c_bytes, 4 * n_pairs * hq * d)
    c_ms = time_ms(lambda: FD.flash_decode(*cargs, q_span=64))
    cp_ms = time_ms(lambda: FD.paged_attention_ref(*cargs, q_span=64))
    cgrid = FD.decode_grid(1, hkv, 64 * hq // hkv, page, -(-512 // page), d)
    print(f"  flash_decode chunk (q_span=64, cache 129..192, page {page}, "
          f"grid (splits, cluster, blocks) {cgrid}): {c_ms:.4f} ms, plain "
          f"{cp_ms:.4f} ms, bound {cb_ms:.4f} ms ({cb_by})")

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
    grid = FD.decode_grid(8, hkv, hq // hkv, page, -(-512 // page), d, 1)
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
                 f"float8_e4m3fn, unit scales; grid (splits, cluster, "
                 f"blocks) {grid}; phase 9b launches "
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


# ------------------------------ the dense engine -----------------------------

DENSE_ARCHS = ("granite-3-8b", "glm4-9b", "granite-34b", "gemma2-9b")


def dense_engine(cfg, params, max_seq: int, **kw):
    """The static-batch engine on the card."""
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    return DecodeEngine(cfg, params, ServeConfig(max_seq=max_seq,
                                                 device="cuda", **kw))


def paged_engine(cfg, params, max_seq: int, batch: int, **kw):
    """The paged engine with the model's page and chunk."""
    from repro_torch.serve.engine import PagedEngine, PagedServeConfig
    return PagedEngine(cfg, params, PagedServeConfig(
        max_seq=max_seq, max_batch=batch, device="cuda", **kw))


def dense_prompts(cfg, b: int, s0: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s0), dtype=np.int32)


def dense_launches(cfg, n_tokens: int, fuse: bool) -> dict:
    """The static engine's launches for one ``generate``: row 4 once a
    layer (the one prefill); under ``fuse`` row 11 once a layer a model
    call (the prefill and n - 1 decode steps) and row 9 once a weight of
    the MLP a layer a call; nothing else (decode attention is plain
    PyTorch, as in JAX; ``wo`` is ``ops.linear``)."""
    want = {"flash_attention": cfg.n_layers}
    if fuse:
        mats = 3 if cfg.mlp_kind == "swiglu" else 2
        want["qkv_fused"] = cfg.n_layers * n_tokens
        want["matmul_fused"] = mats * cfg.n_layers * n_tokens
    return want


def phase14_parity(seed: int, kernels: dict) -> dict:
    """(a) Each dense arch at full width, 2 layers, fp32: the static
    engine's kernel path against its plain path (``use_kernel=False``),
    unfused and fused, and against the paged engine, token for token;
    the launch counts of each.  gemma2-9b's prompts (4064 tokens, 40 new
    ones) run its local layers' ring past the 4096 window."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    out = {}
    for arch in DENSE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype=torch.float32)
        params = T.init_params(cfg, seed=seed, device="cuda")
        ring = cfg.window is not None
        b, s0, n, max_seq = (2, 4064, 40, 4224) if ring else (2, 300, 24,
                                                              512)
        prompts = dense_prompts(cfg, b, s0, seed)
        res = {}
        t0 = time.perf_counter()
        for fuse in (False, True):
            reset(kernels)
            kern = dense_engine(cfg, params, max_seq,
                                fuse=fuse).generate(prompts, n)
            torch.cuda.synchronize()
            launched = counts(kernels)
            plain = dense_engine(cfg, params, max_seq, fuse=fuse,
                                 use_kernel=False).generate(prompts, n)
            assert counts(kernels) == launched, \
                "the plain path launched a kernel"
            want = dense_launches(cfg, n, fuse)
            assert {k: v for k, v in launched.items() if v} == want, \
                (arch, fuse, launched, want)
            assert np.array_equal(kern, plain), (arch, fuse, kern, plain)
            reset(kernels)
            eng = paged_engine(cfg, params, max_seq, b, fuse=fuse)
            paged = eng.generate(list(prompts), n)
            torch.cuda.synchronize()
            plaunch = {k: v for k, v in counts(kernels).items() if v}
            decode = "flash_decode_oproj" if fuse else "flash_decode"
            assert plaunch.get(decode, 0) > 0, (arch, fuse, plaunch)
            assert np.array_equal(paged, kern), (arch, fuse, paged, kern)
            print(f"  {arch} fuse={fuse}: {b} x {n} tokens from {s0}-token "
                  f"prompts identical on the static kernel path, its plain "
                  f"path and the paged engine (page {eng.page_size}, chunk "
                  f"{eng.prefill_chunk}); static launches {want}, paged "
                  f"{plaunch}; first tokens {kern[:, :4].tolist()}")
            res["fused" if fuse else "unfused"] = {
                "static_launches": want, "paged_launches": plaunch,
                "page": eng.page_size}
        print(f"  {arch}: {time.perf_counter() - t0:.1f}s")
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


def teacher_forced_logits(cfg, params, prompt, tokens, max_seq: int):
    """The logits of the last of ``tokens`` fed one by one after
    ``prompt`` (1, S0): through the static engine's dense cache (its ring
    for local layers; plain PyTorch attention) and through the paged
    cache (``flash_decode``).  Returns (dense, paged), fp32."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_cache as KV
    dev = torch.device("cuda")
    s0 = prompt.shape[1]
    tok = torch.from_numpy(prompt).to(dev)
    feed = torch.from_numpy(np.asarray(tokens, np.int32)).to(dev)
    with torch.no_grad():
        _, cache = T.prefill(cfg, params, tok, max_seq=max_seq)
        for i in range(len(tokens)):
            dense, cache = T.decode_step(cfg, params, feed[i:i + 1], cache,
                                         s0 + i)
        del cache
        page = KV.choose_page_size(cfg, max_seq)
        nb = KV.num_blocks(max_seq, page)
        pool = KV.init_paged_cache(cfg, 1, nb + 1, page, dev)
        pages = torch.arange(1, nb + 1, device=dev)
        _, full = T.prefill(cfg, params, tok, max_seq=s0, full_kv=True)
        KV.write_prefill(cfg, pool, full, 0, pages, page)
        del full
        attn = KV.make_paged_attn_step(cfg, pages[None].int(), page)
        pos = torch.tensor([s0], dtype=torch.int32, device=dev)
        for i in range(len(tokens)):
            paged, _ = T.decode_step(cfg, params, feed[i:i + 1], pool,
                                     pos + i, attn)
    return dense.float(), paged.float()


def paged_logits(cfg, params, prompts, tokens, max_seq: int, fuse: bool,
                 use_kernel: bool):
    """The prefill logits of ``prompts`` (B, S0), and the logits of the
    last of ``tokens`` (B, n) fed one step at a time through a paged
    cache at the model's page, all under ``ops.fused_ops(fuse)`` (fused:
    one-pass QKV, the MLP through ``matmul_fused``, single-token decode
    through ``flash_decode_oproj``), on the kernel path or the plain one.
    Returns (prefill, decode), fp32."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_cache as KV
    dev = torch.device("cuda")
    b, s0 = prompts.shape
    tok = torch.from_numpy(prompts).to(dev)
    feed = torch.from_numpy(np.asarray(tokens, np.int32)).to(dev)
    page = KV.choose_page_size(cfg, max_seq, fused=fuse)
    nb = KV.num_blocks(max_seq, page)
    pages = torch.arange(1, b * nb + 1, device=dev).reshape(b, nb)
    with torch.no_grad(), ops.fused_ops(fuse):
        pre, full = T.prefill(cfg, params, tok, max_seq=s0, full_kv=True,
                              use_kernel=use_kernel)
        pool = KV.init_paged_cache(cfg, b, b * nb + 1, page, dev)
        for r in range(b):
            KV.write_prefill(cfg, pool, {"layers": [
                {key: c[key][r:r + 1] for key in ("k", "v")}
                for c in full["layers"]]}, r, pages[r], page)
        del full
        attn = KV.make_paged_attn_step(cfg, pages.int(), page,
                                       use_kernel=use_kernel, fused=fuse)
        pos = torch.full((b,), s0, dtype=torch.int32, device=dev)
        for i in range(feed.shape[1]):
            dec, _ = T.decode_step(cfg, params, feed[:, i], pool, pos + i,
                                   attn, use_kernel=use_kernel)
    return pre.float(), dec.float()


def serve_timed(label: str, run, n_tokens: int) -> dict:
    """``run()`` on a synchronised clock with the peak memory reset
    before: tok/s and peak GB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {label}: {n_tokens} tokens in {wall:.3f}s = "
          f"{n_tokens / wall:.1f} tok/s, peak {peak:.2f} GB")
    return {"out": out, "wall_s": wall, "tok_per_s": n_tokens / wall,
            "peak_gb": peak}


def phase14_gemma2(seed: int, kernels: dict) -> dict:
    """(b) gemma2-9b at full width, 14 of 42 layers (the local/global
    pattern whole), in bf16: the static and the
    paged engine serve the same 4 prompts of 4000 tokens, 128 new ones
    each (max_seq 4352), so the local layers' ring wraps at position
    4096.  The prefill logits of the kernel path against the plain path,
    and the logits of a step past the wrap (position 4099, the static
    engine's tokens fed to both) of the dense cache against the paged
    one, each within 5% of max |logit| with the argmax equal; tok/s, peak
    memory and a profiled window of each engine."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=14)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.param_count() * 2 / 1e9:.2f} GB of bf16 weights "
          f"({cfg.n_layers} layers) in {time.perf_counter() - t0:.1f}s")
    b, s0, n, max_seq = 4, 4000, 128, 4352
    prompts = dense_prompts(cfg, b, s0, seed)
    t0 = time.perf_counter()
    dense_engine(cfg, params, max_seq).generate(prompts, 2)      # warm
    paged_engine(cfg, params, max_seq, b).generate(list(prompts), 2)
    print(f"  warm runs (the same shapes, 2 tokens): "
          f"{time.perf_counter() - t0:.1f}s")
    out = {}
    reset(kernels)
    st = serve_timed("static engine", lambda: dense_engine(
        cfg, params, max_seq).generate(prompts, n), b * n)
    out["static_launches"] = {k: v for k, v in counts(kernels).items() if v}
    assert out["static_launches"] == dense_launches(cfg, n, False), \
        out["static_launches"]
    reset(kernels)
    eng = paged_engine(cfg, params, max_seq, b)
    pg = serve_timed(f"paged engine (page {eng.page_size}, chunk "
                     f"{eng.prefill_chunk})",
                     lambda: eng.generate(list(prompts), n), b * n)
    out["paged_launches"] = {k: v for k, v in counts(kernels).items() if v}
    assert out["paged_launches"].get("flash_decode", 0) > 0, \
        out["paged_launches"]
    same = float((st["out"] == pg["out"]).mean())
    print(f"  the engines' tokens agree at {100 * same:.1f}% of "
          f"{b * n} (bf16: the dense cache's plain attention and the paged "
          f"kernel round differently); static launches "
          f"{out['static_launches']}, paged {out['paged_launches']}")
    for key, r in (("static", st), ("paged", pg)):
        out[key] = {k: v for k, v in r.items() if k != "out"}
    out["token_agreement"] = same
    tok = torch.from_numpy(prompts[:1]).cuda()
    with torch.no_grad():
        got = T.prefill(cfg, params, tok, max_seq=s0)[0].float()
        want = T.prefill(cfg, params, tok, max_seq=s0,
                         use_kernel=False)[0].float()
    out["prefill_logits"] = hold_logits(
        "gemma2-9b, 4000 tokens, kernels vs plain", got, want)
    t0 = time.perf_counter()
    dense, paged = teacher_forced_logits(cfg, params, prompts[:1],
                                         st["out"][0, :100], max_seq)
    out["wrap_logits"] = hold_logits(
        "gemma2-9b at position 4099 (past the ring's wrap), paged vs "
        "dense cache", paged, dense, what="decode logits")
    print(f"  the prefill and teacher-forced logits: "
          f"{time.perf_counter() - t0:.1f}s")
    out["static"]["profile"] = profile_call(
        lambda: dense_engine(cfg, params, max_seq).generate(prompts, 16),
        f"static engine, {b} x 16 tokens after {s0}-token prompts")
    out["paged"]["profile"] = profile_window(
        paged_engine(cfg, params, max_seq, b), list(prompts), 16)
    hold_decode_core(out["paged"]["profile"], "flash_decode")
    del params
    torch.cuda.empty_cache()
    return out


def static_quant_cell(cfg, params, prompts, kernels) -> dict:
    """(c)'s quantized cell: ``cfg`` with int8 projections
    (``quantize_params``) over an fp8 dense cache (w8fp8), through the
    static engine, unfused and fused: the engine's kernel path against
    its plain path (token agreement printed), and the prefill logits and
    one decode step's logits (the kernel path's greedy token fed to both)
    held within 5% of max |logit| with the argmax equal; the kernel path
    launches the int8 GEMMs (row 10; fused, row 9's int8 variant too),
    the plain path nothing."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant import quantize_params
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    qparams = quantize_params(params)
    tok = torch.from_numpy(prompts).cuda()
    s0 = prompts.shape[1]
    out = {}
    for fuse in (False, True):
        tag = "fused" if fuse else "unfused"
        reset(kernels)
        kern = dense_engine(cfg8, qparams, 512, fuse=fuse).generate(
            prompts, 8)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts(kernels).items() if v}
        plain = dense_engine(cfg8, qparams, 512, fuse=fuse,
                             use_kernel=False).generate(prompts, 8)
        assert {k: v for k, v in counts(kernels).items() if v} == launched, \
            "the plain path launched a kernel"
        assert launched.get("matmul_w8", 0) > 0, launched
        assert (launched.get("matmul_fused", 0) > 0) == fuse, launched
        same = float((kern == plain).mean())
        logits = {}
        for use_kernel in (True, False):
            with torch.no_grad(), ops.fused_ops(fuse):
                pre, cache = T.prefill(cfg8, qparams, tok, max_seq=512,
                                       use_kernel=use_kernel)
                if use_kernel:
                    first = pre[:, :cfg.vocab].argmax(-1).to(torch.int32)
                dec, _ = T.decode_step(cfg8, qparams, first, cache, s0,
                                       use_kernel=use_kernel)
            logits[use_kernel] = (pre.float(), dec.float())
            del cache
        print(f"  {cfg.name} w8fp8 {tag} static engine: launches "
              f"{launched}; {kern.shape[0]} x 8 tokens agree with the plain "
              f"path at {100 * same:.1f}%")
        out[tag] = {"launches": launched, "token_agreement": same,
                    "prefill_logits": hold_logits(
                        f"{cfg.name} w8fp8 {tag} static, kernels vs plain",
                        logits[True][0], logits[False][0]),
                    "decode_logits": hold_logits(
                        f"{cfg.name} w8fp8 {tag} static decode at position "
                        f"{s0}, kernels vs plain", logits[True][1],
                        logits[False][1], what="decode logits")}
    del qparams
    torch.cuda.empty_cache()
    return out


def phase14_wide(seed: int, kernels: dict) -> dict:
    """(c) glm4-9b and granite-34b at full width, depth cut to 4 layers
    (granite-34b's 88 would hold 67 GB), bf16: 8 prompts of 256 tokens,
    32 new ones each, max_seq 512, through the static and the paged
    engine, unfused and fused: tok/s, peak memory, launches (the fused
    paged decode runs row 3 at G 16 and 48).  Each path, unfused and
    fused, held against its plain path on the same inputs: the 8
    prompts' prefill logits and the paged decode logits at position 259
    (the static engine's first 4 tokens fed), each within 5% of max
    |logit| with the argmax equal; the plain path launches nothing.
    glm4-9b also runs :func:`static_quant_cell` (w8fp8)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    out = {}
    for arch in ("glm4-9b", "granite-34b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=4)
        params = T.init_params(cfg, seed=seed, device="cuda")
        prompts = dense_prompts(cfg, 8, 256, seed)
        res = {}
        for fuse in (False, True):
            tag = "fused" if fuse else "unfused"
            # warm at the run's shapes: the fused keys' tiles are searched
            # at first use
            dense_engine(cfg, params, 512, fuse=fuse).generate(prompts, 2)
            paged_engine(cfg, params, 512, 8, fuse=fuse).generate(
                list(prompts), 2)
            reset(kernels)
            st = serve_timed(f"{arch} {tag} static engine",
                             lambda: dense_engine(cfg, params, 512,
                                                  fuse=fuse).generate(
                                 prompts, 32), 8 * 32)
            slaunch = {k: v for k, v in counts(kernels).items() if v}
            assert slaunch == dense_launches(cfg, 32, fuse), slaunch
            eng = paged_engine(cfg, params, 512, 8, fuse=fuse)
            reset(kernels)
            pg = serve_timed(f"{arch} {tag} paged engine (page "
                             f"{eng.page_size}, chunk {eng.prefill_chunk})",
                             lambda: eng.generate(list(prompts), 32), 8 * 32)
            plaunch = {k: v for k, v in counts(kernels).items() if v}
            decode = "flash_decode_oproj" if fuse else "flash_decode"
            assert plaunch.get(decode, 0) > 0, plaunch
            same = float((st["out"] == pg["out"]).mean())
            print(f"    launches: static {slaunch}, paged {plaunch}; tokens "
                  f"agree at {100 * same:.1f}%")
            fed = st["out"][:, :4]
            reset(kernels)
            got = paged_logits(cfg, params, prompts, fed, 512, fuse, True)
            torch.cuda.synchronize()
            held = counts(kernels)
            assert held[decode] >= cfg.n_layers * 4, held
            want = paged_logits(cfg, params, prompts, fed, 512, fuse, False)
            assert counts(kernels) == held, "the plain path launched a kernel"
            res[tag] = {"static": {k: v for k, v in st.items() if k != "out"},
                        "paged": {k: v for k, v in pg.items() if k != "out"},
                        "static_launches": slaunch, "paged_launches": plaunch,
                        "token_agreement": same, "page": eng.page_size,
                        "prefill_logits": hold_logits(
                            f"{arch} {tag}, 8 x 256 tokens, kernels vs "
                            f"plain", got[0], want[0]),
                        "decode_logits": hold_logits(
                            f"{arch} {tag} paged decode at position 259, "
                            f"kernels vs plain", got[1], want[1],
                            what="decode logits")}
        if arch == "glm4-9b":
            res["w8fp8"] = static_quant_cell(cfg, params, prompts, kernels)
        out[arch] = res
        del params
        torch.cuda.empty_cache()
    return out


def time_wide_kernels() -> dict:
    """Rows 3 and 11 at the wide groups they were repaired for, beside
    their bound and plain versions: row 3 at glm4-9b's decode (B 8, Hkv
    2, G 16, E 4096) and granite-34b's (B 8, Hkv 1, G 48, E 6144), page
    32, bf16, lengths 100..450, with the grid, head chunks and shared
    memory; row 11 at (8, 256, 4096, 16) and (8, 128, 6144, 48), fp32 on
    the tile core (bn below 64) and bf16, the model's tiles, with the
    joint width, column blocks and shared memory, beside ``torch.matmul``
    on the concatenated ``[wq|wk|wv]`` in the same dtype."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import qkv_fused as QF
    from repro_torch.tune import best_schedule
    dev = torch.device("cuda")
    out = {}
    lens = [100 + 50 * i for i in range(8)]
    for arch, hkv, g, e in (("glm4-9b", 2, 16, 4096),
                            ("granite-34b", 1, 48, 6144)):
        args = oproj_inputs(dev, torch.bfloat16, lens, seed=g, page=32,
                            hkv=hkv, g=g, e=e)
        hq, d, n_keys = hkv * g, 128, sum(lens)
        b_ms, b_by = bound(2 * n_keys * hkv * d * 2 + args[5].numel() * 2
                           + (args[0].numel() + 8 * e) * 2,
                           4 * n_keys * hq * d + 2 * 8 * hq * d * e)
        row = {"ms": time_ms(lambda: FD.flash_decode_oproj(*args)),
               "plain_ms": time_ms(
                   lambda: FD.paged_attention_oproj_ref(*args)),
               "bound_ms": b_ms, "bound_by": b_by,
               "grid": FD.oproj_grid(hkv, e, FD.oproj_chunks(g, d, 8)),
               "head_chunk": FD.oproj_head_chunk(g, d, 8),
               "chunks": FD.oproj_chunks(g, d, 8),
               "smem": FD.oproj_smem_bytes_required(32, g, d, batch=8)}
        out[f"flash_decode_oproj {arch}"] = row
        print(f"  flash_decode_oproj {arch} decode B=8 Hkv={hkv} G={g} "
              f"D=128 E={e} page=32 bf16: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"grid (slice, slices, cluster) {row['grid']} x {hkv} heads "
              f"x {row['chunks']} chunks of {row['head_chunk']} query "
              f"heads, {row['smem']} B shared")
    for dims in ((8, 256, 4096, 16), (8, 128, 6144, 48)):
        m, nkv, k, g = dims
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            x, wq, wk, wv = qkv_inputs(dev, dtype, m, nkv, k, g, seed=g)
            bm, bk, bn = best_schedule("qkv_fused", dims, dn).tiles
            cols = (g + 2) * nkv
            b_ms, b_by = bound((m * k + k * cols + m * cols)
                               * dtype.itemsize, 2 * m * k * cols)
            wqkv = torch.cat([wq, wk, wv], dim=1)
            row = {"ms": time_ms(lambda: QF.qkv_fused(x, wq, wk, wv, bm=bm,
                                                      bk=bk, bn=bn)),
                   "plain_ms": time_ms(lambda: QF.qkv_fused_ref(x, wq, wk,
                                                                wv)),
                   "library_ms": time_ms(lambda: torch.matmul(x, wqkv)),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "tiles": (bm, bk, bn),
                   "smem": QF.smem_bytes_required(bm, bk, bn, g,
                                                  dtype.itemsize, m=m),
                   "blocks": (-(-nkv // bn) if dtype == torch.float32
                              else QF.blocks(nkv, g, bn))}
            out[f"qkv_fused {dims} {dn}"] = row
            joint = (f" of {(g + 2) * bn} joint columns"
                     if dtype == torch.float32 else "")
            print(f"  qkv_fused M={m} Nkv={nkv} K={k} G={g} {dn}: tiles "
                  f"{(bm, bk, bn)}, {row['blocks']} column blocks{joint}, "
                  f"{row['smem']} B shared: {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, torch.matmul on [wq|wk|wv] "
                  f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, the bf16 peak)")
    return out


# -------------------- the other arch families (3, 13, 17) --------------------

FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-780m",
                "recurrentgemma-9b", "seamless-m4t-medium",
                "phi-3-vision-4.2b")
DECODER_FAMILIES = FAMILY_ARCHS[:4]     # the paged engine serves these


def phase3_families(dev) -> None:
    """The other arch families' kernel shapes against the plain versions,
    fp32 and bf16, repeats bit-equal: row 4 non-causal at
    seamless-m4t-medium's cross-attention (Sq 1, 17 and 300 over Skv
    1024; Hq = Hkv = 16, D 64) and its encoder (Sq = Skv = 1024); row 4
    causal at phi-3-vision's D 96 over its 576 prefix positions and 64
    tokens (Hq = Hkv = 32); rows 1 and 3, and row 2 over fp8 pages, at
    recurrentgemma-9b's local layers (Hkv 1, G 16, D 256, window 2048,
    E 4096) at B 1 and 8 past the window, pages 32 and the model's, row 1
    and 2 also a 16-token chunk, and every split count at B 1 in bf16;
    row 3 also at B 20 (16-row groups: chunks of 2 query heads).  Row
    11 at recurrentgemma's (M, 256, 4096, 16) is phase3_wide_groups'."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve import kv_cache as KV
    rg = get_config("recurrentgemma-9b")
    pages = sorted({32, KV.choose_page_size(rg, 4096),
                    KV.choose_page_size(rg, 4096, fused=True)})
    bf16 = torch.bfloat16
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[1]
        for b, sq, skv, hq, hkv, d, causal in (
                (2, 1, 1024, 16, 16, 64, False),
                (2, 17, 1024, 16, 16, 64, False),
                (1, 300, 1024, 16, 16, 64, False),
                (1, 1024, 1024, 16, 16, 64, False),
                (1, 640, 640, 32, 32, 96, True)):
            check_attention_edge(dev, dtype, b, sq, skv, hq, hkv, d, causal,
                                 None, None)
            q, k, v = dense_inputs(dev, dtype, b, sq, skv, seed=sq + skv + hq,
                                   hq=hq, hkv=hkv, d=d)
            assert torch.equal(FA.flash_attention(q, k, v, causal=causal),
                               FA.flash_attention(q, k, v, causal=causal))
        for page in pages:
            n_blocks = -(-4200 // page)
            for b in (1, 8, 20):
                lengths = ([3000] if b == 1 else
                           [1, 100, 2047, 2048, 2049, 2500, 3000, 4100]
                           if b == 8 else
                           [(331 * i + 7) % 4150 + 1 for i in range(b)])
                for q_span in (1, 16) if b <= 8 else ():
                    kw = dict(window=2048, q_span=q_span)
                    args = paged_inputs(dev, dtype, lengths, q_span,
                                        seed=b + q_span, hkv=1, g=16, d=256,
                                        page=page, n_blocks=n_blocks)
                    out = FD.flash_decode(*args, **kw)
                    assert torch.equal(out, FD.flash_decode(*args, **kw))
                    tag = (f"flash_decode {dn} Hkv=1 G=16 D=256 page={page} "
                           f"B={b} q_span={q_span} window=2048")
                    ref = FD.paged_attention_ref(*args, **kw)
                    compare(tag, out, ref, dn)
                    f8 = fp8_paged(paged_inputs(
                        dev, torch.float32, lengths, q_span, seed=b,
                        hkv=1, g=16, d=256, page=page, n_blocks=n_blocks),
                        seed=b, unit=False)
                    f8 = (f8[0].to(dtype),) + f8[1:]
                    out8 = FD.flash_decode_fp8(*f8, **kw)
                    assert torch.equal(out8, FD.flash_decode_fp8(*f8, **kw))
                    compare(tag.replace("flash_decode", "flash_decode_fp8"),
                            out8, FD.paged_attention_fp8_ref(*f8, **kw), dn)
                    if dtype == bf16 and b == 1:
                        check_decode_splits(FD.flash_decode, args, ref, dn,
                                            tag, **kw)
                args = oproj_inputs(dev, dtype, lengths, seed=b, page=page,
                                    hkv=1, g=16, d=256, e=4096,
                                    n_blocks=n_blocks)
                out = FD.flash_decode_oproj(*args, window=2048)
                assert torch.equal(out, FD.flash_decode_oproj(*args,
                                                              window=2048))
                assert not FD._COUNTERS[out.device].any()
                chunks = FD.oproj_chunks(16, 256, b)
                compare(f"flash_decode_oproj {dn} Hkv=1 G=16 D=256 E=4096 "
                        f"page={page} B={b} window=2048 (grid "
                        f"{FD.oproj_grid(1, 4096, chunks)} x 1 x {chunks} "
                        f"chunks of {FD.oproj_head_chunk(16, 256, b)})", out,
                        FD.paged_attention_oproj_ref(*args, window=2048), dn,
                        gemm_atol(dn, 16 * 256))
    torch.cuda.synchronize()


def family_cfg(arch: str, layers: int | None, dtype):
    """``arch`` at full width, its depth cut to ``layers`` (the encoder's
    too), in ``dtype``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = {"dtype": dtype}
    if layers is not None:
        kw["n_layers"] = layers
        if cfg.is_encdec:
            kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def family_inputs(cfg, b: int, seed: int) -> dict:
    """The frontend stubs' inputs (normal draws times 0.1, numpy fp32):
    ``enc_embeds`` for the encoder-decoder, ``prefix_embeds`` for the
    vision prefix."""
    rng = np.random.default_rng(seed + 17)
    out = {}
    if cfg.is_encdec:
        out["enc_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.prefix_tokens:
        out["prefix_embeds"] = (rng.standard_normal(
            (b, cfg.prefix_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def family_static_launches(cfg) -> int:
    """Row 4's launches for one static ``generate``: once an attention
    layer (the one prefill) and, for the encoder-decoder, once an
    encoder layer and once a decoder layer's cross-attention (the cross
    decode is plain ``einsum`` s, as in JAX)."""
    from repro_torch.models import transformer as T
    n = len(T.attention_layers(cfg))
    if cfg.is_encdec:
        n += cfg.encoder_layers + cfg.n_layers
    return n


def family_serve(cfg, params, prompts, n, max_seq, kernels, ex, fuse):
    """The static engine on its kernel path and its plain path (tokens
    identical, the plain path launching nothing; row 4's launches
    counted), and for a decoder-only stack the paged engine on both
    paths (tokens identical; against the static engine's too unless the
    stack routes experts -- a chunked prefill routes fewer tokens at a
    time, so its capacity, and what it drops, differ, in JAX as here --
    or keeps fp8 K/V, which the two engines read in another order).
    Returns the launches of each path."""
    import torch
    reset(kernels)
    kern = dense_engine(cfg, params, max_seq, fuse=fuse).generate(
        prompts, n, **ex)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts(kernels).items() if v}
    plain = dense_engine(cfg, params, max_seq, fuse=fuse,
                         use_kernel=False).generate(prompts, n, **ex)
    assert {k: v for k, v in counts(kernels).items() if v} == launched, \
        "the plain path launched a kernel"
    want = family_static_launches(cfg)
    assert launched.get("flash_attention", 0) == want, (launched, want)
    if fuse and want:         # int8 q/k/v run matmul_w8, as in JAX
        assert launched.get("qkv_fused", 0) + launched.get("matmul_w8",
                                                           0) > 0, launched
    if fuse and cfg.d_ff:
        assert launched.get("matmul_fused", 0) > 0, launched
    assert np.array_equal(kern, plain), (cfg.name, fuse, kern, plain)
    out = {"static": launched, "tokens": kern[:, :4].tolist()}
    if not (cfg.is_encdec or cfg.prefix_tokens):
        reset(kernels)
        eng = paged_engine(cfg, params, max_seq, prompts.shape[0], fuse=fuse)
        paged = eng.generate(list(prompts), n)
        torch.cuda.synchronize()
        plaunch = {k: v for k, v in counts(kernels).items() if v}
        pplain = paged_engine(cfg, params, max_seq, prompts.shape[0],
                              fuse=fuse, use_kernel=False).generate(
                                  list(prompts), n)
        assert {k: v for k, v in counts(kernels).items() if v} == plaunch
        assert np.array_equal(paged, pplain), (cfg.name, fuse, paged, pplain)
        fp8 = (cfg.kv_cache_dtype or cfg.dtype).itemsize == 1
        decode = ("flash_decode_fp8" if fp8 else "flash_decode_oproj"
                  if fuse else "flash_decode")
        if want:
            assert plaunch.get(decode, 0) > 0, plaunch
        if not cfg.n_experts and not fp8:
            assert np.array_equal(paged, kern), (cfg.name, fuse, paged, kern)
        out.update(paged=plaunch, page=eng.page_size,
                   chunk=eng.prefill_chunk, spec=eng.spec,
                   prefix_caching=eng.prefix_caching,
                   paged_equals_static=bool(np.array_equal(paged, kern)))
    return out


def phase17_gate(seed: int, kernels: dict) -> dict:
    """(a) The six new archs at full width, fp32, 2 layers (recurrentgemma
    3: recurrent, recurrent, local; seamless 2 encoder layers too), 2
    prompts and 16 new tokens (300-token prompts; recurrentgemma 2100,
    past its 2048 window; phi-3-vision's 576 prefix positions ahead of
    them, seamless's 1024 encoder positions beside them): the static
    engine's kernel path against its plain path, unfused and fused, and
    the paged engine on both paths for the four decoder-only archs, greedy
    tokens identical (``family_serve``), with the launch counts of each
    path; recurrentgemma-9b also under w8fp8 (int8 projections, fp8
    caches)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.quant import quantize_params
    out = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        rg = arch == "recurrentgemma-9b"
        cfg = family_cfg(arch, 3 if rg else 2, torch.float32)
        params = T.init_params(cfg, seed=seed, device="cuda")
        b, s0, n = 2, 2100 if rg else 300, 16
        max_seq = -(-(s0 + cfg.prefix_tokens + n) // 128) * 128
        prompts = dense_prompts(cfg, b, s0, seed)
        ex = family_inputs(cfg, b, seed)
        cells = [("wide", cfg, params)]
        if rg:
            cells.append(("w8fp8", dataclasses.replace(
                cfg, kv_cache_dtype=torch.float8_e4m3fn),
                quantize_params(params)))
        res = {}
        for mode, c, p in cells:
            for fuse in (False, True):
                r = family_serve(c, p, prompts, n, max_seq, kernels, ex,
                                 fuse)
                if mode == "w8fp8":
                    assert r["static"].get("matmul_w8", 0) > 0, r
                tag = f"{mode} {'fused' if fuse else 'unfused'}"
                print(f"  {arch} {tag}: {b} x {n} tokens from {s0}-token "
                      f"prompts identical on every path; static launches "
                      f"{r['static']}" + (
                          f", paged (page {r['page']}, chunk {r['chunk']}, "
                          f"spec {r['spec']}) {r['paged']}, paged == "
                          f"static: {r['paged_equals_static']}"
                          if "paged" in r else "")
                      + f"; first tokens {r['tokens']}")
                res[tag] = r
        print(f"  {arch}: {time.perf_counter() - t0:.1f}s")
        out[arch] = res
        del params, cells
        torch.cuda.empty_cache()
    return out


# phi3.5-moe's 32 layers would hold about 84 GB in bf16
FAMILY_FULL_LAYERS = {"phi3.5-moe-42b-a6.6b": 8}


def phase17_full(seed: int, kernels: dict) -> dict:
    """(b) Five of the new archs at full width in bf16 (phi3.5-moe at 8 of
    its 32 layers, the rest at full depth; qwen3-moe stays in (a)): the
    static engine on 8 prompts of 512 tokens and, for the decoder-only
    archs, the paged engine on 8 requests of 64 to 512 tokens, 32 new
    tokens each, after a warm run: tok/s, peak memory and the launches;
    the prefill logits of a 512-token prompt on the kernel path against
    the plain path within 5% of max |logit|, argmax equal.  Each model
    and its engines are freed before the next loads (``family_full``'s
    frame), so each peak is its own."""
    import torch
    out = {}
    for arch in FAMILY_ARCHS:
        if arch == "qwen3-moe-235b-a22b":
            continue
        out[arch] = family_full(arch, seed, kernels)
        torch.cuda.empty_cache()
    return out


def family_full(arch: str, seed: int, kernels: dict) -> dict:
    """One arch of phase 17b (``phase17_full``)."""
    import torch
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg = family_cfg(arch, FAMILY_FULL_LAYERS.get(arch), torch.bfloat16)
    params = T.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    res = {"layers": cfg.n_layers, "init_s": time.perf_counter() - t0}
    print(f"  {arch}: {cfg.n_layers} layers, {cfg.param_count() / 1e9:.2f}B "
          f"parameters (active {cfg.active_param_count() / 1e9:.2f}B), "
          f"bf16, initialised in {res['init_s']:.1f}s")
    b, n = 8, 32
    max_seq = -(-(512 + cfg.prefix_tokens + n) // 128) * 128
    prompts = dense_prompts(cfg, b, 512, seed)
    ex = family_inputs(cfg, b, seed)
    dense_engine(cfg, params, max_seq).generate(prompts, 2, **ex)   # warm
    reset(kernels)
    st = serve_timed(f"{arch} static engine, {b} x {n} tokens after "
                     f"512-token prompts", lambda: dense_engine(
                         cfg, params, max_seq).generate(prompts, n, **ex),
                     b * n)
    res["static"] = {k: v for k, v in st.items() if k != "out"}
    res["static"]["launches"] = {k: v for k, v in counts(kernels).items()
                                 if v}
    assert np.isin(st["out"], np.arange(cfg.vocab)).all()
    if arch in DECODER_FAMILIES:
        lens = np.linspace(64, 512, b).astype(int)
        rng = np.random.default_rng(seed + 1)
        reqs = [rng.integers(0, cfg.vocab, (int(m),), dtype=np.int32)
                for m in lens]
        paged_engine(cfg, params, max_seq, b).generate(reqs[:2], 2)
        reset(kernels)
        eng = paged_engine(cfg, params, max_seq, b)
        pg = serve_timed(f"{arch} paged engine (page {eng.page_size}, "
                         f"chunk {eng.prefill_chunk}), {b} requests of "
                         f"64-512 tokens x {n}",
                         lambda: eng.generate(reqs, n), b * n)
        res["paged"] = {k: v for k, v in pg.items() if k != "out"}
        res["paged"]["launches"] = {k: v for k, v in counts(kernels).items()
                                    if v}
        res["paged"].update(page=eng.page_size, chunk=eng.prefill_chunk)
        assert np.isin(pg["out"], np.arange(cfg.vocab)).all()
    tok = torch.from_numpy(prompts[:1]).cuda()
    one = {k: torch.from_numpy(v[:1]).cuda() for k, v in ex.items()}
    with torch.no_grad():
        got = T.prefill(cfg, params, tok, max_seq=max_seq, **one)[0].float()
        want = T.prefill(cfg, params, tok, max_seq=max_seq,
                         use_kernel=False, **one)[0].float()
    res["prefill_logits"] = hold_logits(
        f"{arch}, 512 tokens, kernels vs plain", got, want)
    res["wall_s"] = time.perf_counter() - t0
    print(f"  {arch}: {res['wall_s']:.1f}s")
    return res


def phase13_families(seed: int, kernels: dict) -> dict:
    """The six new archs' reduced configs (``configs.get_reduced``: d_model
    64, head_dim 16) on the card.  Serving, fp32: 2 prompts of 12 tokens
    and 8 new ones through ``family_serve`` (the static engine's kernel
    path against its plain path, the paged engine's too for the
    decoder-only archs), unfused and fused.  Training, bf16: 3 steps on
    the default path, finite losses, step 0's loss within 2% of the
    plain path's.  Then each arch's launcher usage lines,
    ``launch.train --reduced --steps 2`` and ``launch.serve --reduced``,
    on their default device."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    out = {}
    for arch in FAMILY_ARCHS:
        base = get_reduced(arch)
        cfg = dataclasses.replace(base, dtype=torch.float32)
        params = T.init_params(cfg, seed=seed, device="cuda")
        prompts = dense_prompts(cfg, 2, 12, seed)
        ex = family_inputs(cfg, 2, seed)
        res = {}
        for fuse in (False, True):
            res["fused" if fuse else "unfused"] = family_serve(
                cfg, params, prompts, 8, 64, kernels, ex, fuse)
        cfgb = dataclasses.replace(base, dtype=torch.bfloat16)
        params0 = T.init_params(cfgb, seed=seed, device="cuda")
        opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
        batches = [make_batch(cfgb, 64, 4, s, seed=seed, device="cuda")
                   for s in range(3)]
        plain, _ = train_one_step(cfgb, params0, batches[0], blocked=False,
                                  use_kernel=False, opt=opt)
        step_fn = loop.make_train_step(cfgb, loop.TrainConfig(opt=opt))
        p, state, losses = params0, adamw.init_state(params0), []
        reset(kernels)
        for batch in batches:
            p, state, m = step_fn(p, state, batch)
            losses.append(float(m["loss"]))
        launched = {k: v for k, v in counts(kernels).items() if v}
        ref = float(plain["loss"])
        assert all(np.isfinite(losses)), losses
        assert abs(losses[0] - ref) <= 2e-2 * abs(ref), (arch, losses, ref)
        if family_static_launches(cfg):
            assert launched.get("flash_attention_bwd", 0) > 0, launched
        res["train"] = {"losses": losses, "plain_step0": ref,
                        "launches": launched}
        print(f"  {arch} reduced: served fp32 unfused and fused, kernel "
              f"path == plain path (static launches "
              f"{res['unfused']['static']}); bf16 training losses {losses},"
              f" step 0 vs plain {ref:.5f}; launches {launched}")
        out[arch] = res
        del params, params0, p, state
        torch.cuda.empty_cache()
        launch_train.main(["--arch", arch, "--reduced", "--steps", "2"])
        launch_serve.main(["--arch", arch, "--reduced", "--requests", "4",
                           "--gen", "8"])
    return out


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
    mm = 0
    for e in prof.key_averages():
        if e.key in ("aten::mm", "aten::addmm"):
            mm += e.count
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        kind = train_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, e.count, e.key[:90]))
    busy = sum(kinds.values()) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
           "mm_calls": mm,
           "device_ms_by_kind": {k: v / 1e3 for k, v in sorted(kinds.items())},
           "top": [{"ms": us / 1e3, "count": c, "name": n}
                   for us, c, n in sorted(top, reverse=True)[:8]]}
    print(f"  profiled step: wall {wall:.3f}s, device busy {busy:.3f}s "
          f"({100 * busy / wall:.1f}%), aten::mm calls {mm}, by kind (ms) "
          f"{ {k: round(v, 3) for k, v in out['device_ms_by_kind'].items()} }")
    for t in out["top"]:
        print(f"    {t['ms']:9.3f} ms  x{t['count']:<6} {t['name']}")
    return out


def mm_dispatched(step_fn, params, state, batch) -> int:
    """The ``aten.mm``/``aten.addmm`` calls one train step runs, counted
    by a dispatch mode (under remat "dots" a recomputed product's saved
    output is returned before it reaches this mode)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in ops
            return func(*args, **(kwargs or {}))
    with Count() as count:
        _, _, m = step_fn(params, state, batch)
        float(m["loss"])
    return count.n


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
    blocked kernels; step 0 of each held against the plain path.  Then
    3 steps of the default path under remat "dots" (the batch-free
    products' outputs saved): step 0's loss within 2% of "block"'s, step
    time and peak memory beside it, and the profiled step's ``aten::mm``
    calls fewer than "block"'s (no projection recomputed)."""
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
    for name, blocked, remat, n_steps in (("default", False, "block", steps),
                                          ("blocked", True, "block", steps),
                                          ("dots", False, "dots", 3)):
        tc = loop.TrainConfig(opt=opt, blocked_linear=blocked)
        step_fn = loop.make_train_step(
            dataclasses.replace(cfg, remat=remat), tc)
        params, state = params0, adamw.init_state(params0)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        hist = []
        for s, batch in enumerate(batches[:n_steps]):
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
            "launches_per_step": {k: launched[k] / n_steps for k in want},
            "step_ms_median": statistics.median(h["ms"] for h in steady),
            "tokens_per_s_median": statistics.median(
                h["tokens_per_s"] for h in steady),
            "profile": train_profile(step_fn, params, state, batches[0]),
            "mm_dispatched": mm_dispatched(step_fn, params, state,
                                           batches[0])}
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
    dots, block = out["dots"], out["default"]
    rel = abs(dots["history"][0]["loss"] - block["history"][0]["loss"]) / \
        abs(block["history"][0]["loss"])
    mm = (dots["mm_dispatched"], block["mm_dispatched"])
    print(f"  remat dots against block (default path): step 0 loss rel "
          f"{rel:.2e} (bound 2e-2); median step {dots['step_ms_median']:.1f}"
          f" vs {block['step_ms_median']:.1f} ms; peak "
          f"{dots['peak_gb']:.2f} vs {block['peak_gb']:.2f} GB; aten::mm "
          f"calls a step that run {mm[0]} vs {mm[1]} (the profiler's "
          f"aten::mm events {dots['profile']['mm_calls']} vs "
          f"{block['profile']['mm_calls']})")
    assert rel <= 2e-2 and mm[0] < mm[1], (rel, mm)
    del params0
    torch.cuda.empty_cache()
    return out


# the production mesh's local attention heads (M = 16): (query heads,
# kv heads, head_dim) of one rank, where several ranks share a kv head
# (and the families' local heads: recurrentgemma-9b's one kv head, the
# 16 and 32 kv heads of seamless-m4t-medium and phi-3-vision split)
TP_HEADS = {"granite-3-8b": (2, 1, 128), "glm4-9b": (2, 1, 128),
            "granite-34b": (3, 1, 128), "gemma2-9b": (1, 1, 256),
            "recurrentgemma-9b": (1, 1, 256),
            "seamless-m4t-medium": (1, 1, 64),
            "phi-3-vision-4.2b": (2, 2, 96)}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase19_sharded(seed: int, kernels: dict) -> dict:
    """(a) The sharded train step (``make_train_step(..., mesh=)``) on a
    one-rank NCCL mesh: granite-3-8b at full width, 4 of 40 layers,
    bf16, remat "block", 4 x 512 tokens, 3 steps each under ``tp_fsdp``,
    ``fsdp``, ``tp_fsdp`` with gradient compression and ``tp_fsdp`` with
    blocked linears.  Each variant's unsharded step runs first from the
    same params and batches; every sharded step's loss is held within
    0.5% of it, the largest parameter difference after step 3 printed.
    The launch counts are 0 just before the sharded steps: rows 4 and 5
    must launch, rows 6-8 under blocked, nothing else.  Before that, rows
    4 and 5 at the production mesh's local head shapes (TP_HEADS) and
    seamless-m4t-medium's cross-attention at its local heads (Sq 512
    over Skv 1,024 frames, non-causal).  The one-rank NCCL group stays
    up for (d), :func:`phase19_families`."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    dev = torch.device("cuda")
    for arch, (hq, hkv, d) in TP_HEADS.items():
        check_attention_edge(dev, torch.bfloat16, 4, 512, 512, hq, hkv, d,
                             True, None, None, with_bwd=True)
    check_attention_edge(dev, torch.bfloat16, 4, 512, 1024, 1, 1, 64, False,
                         None, None, with_bwd=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4,
                              remat="block")
    steps, seq, bsz = 3, 512, 4
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=steps)
    batches = [make_batch(cfg, seq, bsz, s, seed=seed, device="cuda")
               for s in range(steps)]
    tp = {"data": ("data",), "model": "model"}
    fsdp = {"data": ("data", "model"), "model": None}
    out = {}
    for name, mapping, compress, blocked in (
            ("tp_fsdp", tp, False, False), ("fsdp", fsdp, False, False),
            ("tp_fsdp_compress", tp, True, False),
            ("tp_fsdp_blocked", tp, False, True)):
        tc = loop.TrainConfig(opt=opt, compress_grads=compress,
                              blocked_linear=blocked)
        t0 = time.perf_counter()
        params0 = T.init_params(cfg, seed=seed, device="cuda")
        ref_p, ref_s = params0, adamw.init_state(params0)
        ref_step = loop.make_train_step(cfg, tc)
        ref_loss, ref_ms = [], []
        for batch in batches:
            t1 = time.perf_counter()
            ref_p, ref_s, m = ref_step(ref_p, ref_s, batch)
            ref_loss.append(float(m["loss"]))
            ref_ms.append((time.perf_counter() - t1) * 1e3)
        del ref_s
        params, state = loop.shard_state(cfg, params0,
                                         adamw.init_state(params0), mesh,
                                         mapping)
        del params0
        step = loop.make_train_step(cfg, tc, mesh, mapping)
        torch.cuda.synchronize()
        reset(kernels)
        hist = []
        for s, batch in enumerate(batches):
            t1 = time.perf_counter()
            params, state, m = step(params, state, batch)
            loss = float(m["loss"])
            hist.append({"step": s, "loss": loss,
                         "ms": (time.perf_counter() - t1) * 1e3})
            rel = abs(loss - ref_loss[s]) / abs(ref_loss[s])
            print(f"  {name} step {s}: loss {loss:.5f} unsharded "
                  f"{ref_loss[s]:.5f} (rel {rel:.2e}, bound 5e-3) "
                  f"{hist[-1]['ms']:.1f} ms (unsharded {ref_ms[s]:.1f})")
            assert np.isfinite(loss) and rel <= 5e-3, (name, s, loss)
        launched = counts(kernels)
        want = ("flash_attention", "flash_attention_bwd") + (
            ("matmul_blocked", "matmul_dgrad_a", "matmul_dgrad_b")
            if blocked else ())
        assert min(launched[k] for k in want) > 0, (name, launched)
        assert not any(n for k, n in launched.items() if k not in want), \
            (name, launched)
        full = loop.unshard_state(cfg, {"params": params, "opt": state},
                                  mesh, mapping)["params"]
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(adamw.leaves(full), adamw.leaves(ref_p)))
        print(f"  {name}: launches {dict((k, launched[k]) for k in want)}"
              f", largest parameter difference after step {steps}: "
              f"{diff:.3e} ({time.perf_counter() - t0:.1f}s)")
        out[name] = {"history": hist, "unsharded_loss": ref_loss,
                     "unsharded_ms": ref_ms,
                     "launches": {k: launched[k] for k in want},
                     "max_param_diff": diff}
        del params, state, full, ref_p
        torch.cuda.empty_cache()
    return out


# phase 19d: each family at full width, its depth cut (the encoder's to
# 2 layers at its 1,024 frames, phi-3-vision's 576 prefix rows kept)
MESH_FAMILIES = {"recurrentgemma-9b": 3, "mamba2-780m": 2,
                 "seamless-m4t-medium": 2, "phi-3-vision-4.2b": 2}


def phase19_families(seed: int, kernels: dict) -> dict:
    """(d) The SSD, RG-LRU, encoder-decoder and vision-prefix families on
    19a's one-rank NCCL mesh, bf16, ``tp_fsdp``, with the stub inputs:
    a mesh ``prefill`` of 2 x 256 tokens and 8 ``decode_step`` s held to
    the unsharded ones (5% of max |logit|, argmax equal), then 2 sharded
    train steps on 4 x 512 tokens, each held within 0.5% of the
    unsharded step's loss from the same params.  The launch counts are 0
    just before the sharded steps: rows 4 and 5 must launch for the
    attention families and nothing else; mamba2 launches nothing."""
    import contextlib

    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import spmd
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    tp = {"data": ("data",), "model": "model"}
    steps, seq, bsz = 2, 512, 4
    out = {}
    for arch, layers in MESH_FAMILIES.items():
        t0 = time.perf_counter()
        cfg = family_cfg(arch, layers, torch.bfloat16)
        params0 = T.init_params(cfg, seed=seed, device="cuda")
        # serving: the unsharded and the mesh prefill + decode steps
        rng = np.random.default_rng(seed + 19)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 256), dtype=np.int32)).cuda()
        nxt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (8, 2), dtype=np.int32)).cuda()
        ex = {k: torch.from_numpy(v).to("cuda", cfg.dtype)
              for k, v in family_inputs(cfg, 2, seed).items()}
        s0 = 256 + cfg.prefix_tokens
        max_seq = s0 + len(nxt)
        logits = {}
        for name in ("unsharded", "mesh"):
            ctx = use_mesh(mesh, tp) if name == "mesh" else \
                contextlib.nullcontext()
            p = spmd.shard_params(params0, T.param_specs(cfg, 1), mesh, tp) \
                if name == "mesh" else params0
            with ctx, torch.no_grad():
                lg, cache = T.prefill(cfg, p, prompt, max_seq, **ex)
                rows = [lg.float()]
                for j, tok in enumerate(nxt):
                    lg, cache = T.decode_step(cfg, p, tok, cache, s0 + j,
                                              max_seq=max_seq)
                    rows.append(lg.float())
            logits[name] = torch.stack(rows)
            del cache
        got, want = logits["mesh"], logits["unsharded"]
        dev_ = float((got - want).abs().max())
        scale = float(want.abs().max())
        agree = bool((got.argmax(-1) == want.argmax(-1)).all())
        print(f"  {arch} ({layers} layers): mesh prefill + 8 decode steps "
              f"against unsharded: max |diff| {dev_:.3e} of max |logit| "
              f"{scale:.3e} (bound 5%); argmax "
              f"{'agrees' if agree else 'differs'}")
        assert torch.isfinite(got).all() and dev_ <= 0.05 * scale and \
            agree, (arch, dev_, scale)
        # training: the unsharded steps, then the sharded ones, counted
        opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=steps)
        tc = loop.TrainConfig(opt=opt)
        batches = [make_batch(cfg, seq, bsz, s, seed=seed, device="cuda")
                   for s in range(steps)]
        ref_p, ref_s = params0, adamw.init_state(params0)
        ref_step = loop.make_train_step(cfg, tc)
        ref_loss = []
        for batch in batches:
            ref_p, ref_s, m = ref_step(ref_p, ref_s, batch)
            ref_loss.append(float(m["loss"]))
        del ref_p, ref_s
        params, state = loop.shard_state(cfg, params0,
                                         adamw.init_state(params0), mesh, tp)
        del params0
        step = loop.make_train_step(cfg, tc, mesh, tp)
        torch.cuda.synchronize()
        reset(kernels)
        hist = []
        for s, batch in enumerate(batches):
            params, state, m = step(params, state, batch)
            loss = float(m["loss"])
            rel = abs(loss - ref_loss[s]) / abs(ref_loss[s])
            hist.append({"step": s, "loss": loss, "unsharded": ref_loss[s],
                         "rel": rel})
            assert np.isfinite(loss) and rel <= 5e-3, (arch, s, loss)
        launched = counts(kernels)
        want_k = () if arch == "mamba2-780m" else (
            "flash_attention", "flash_attention_bwd")
        assert all(launched[k] > 0 for k in want_k), (arch, launched)
        assert not any(n for k, n in launched.items() if k not in want_k), \
            (arch, launched)
        secs = time.perf_counter() - t0
        print(f"  {arch}: sharded losses "
              f"{[round(h['loss'], 5) for h in hist]} against unsharded "
              f"{[round(x, 5) for x in ref_loss]} (rel max "
              f"{max(h['rel'] for h in hist):.2e}, bound 5e-3); launches "
              f"{ {k: launched[k] for k in want_k} } ({secs:.1f}s)")
        out[arch] = {"layers": layers, "history": hist,
                     "logits": {"max_abs_diff": dev_, "max_abs_logit": scale},
                     "launches": {k: launched[k] for k in want_k},
                     "s": secs}
        del params, state, batches, logits, got, want
        torch.cuda.empty_cache()
    return out


def phase19_start() -> dict:
    """Start (b)'s and (c)'s processes after the build, to run beside
    phase 3: each takes seconds to reach the card or to import, and (c)
    needs no card; phase 19 reads them."""
    import os
    env = dict(os.environ, PYTHONPATH="src")
    args = ["-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
            "--reduced", "--steps", "3"]
    runs = {"torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc-per-node", "1", *args],
            "alone": [sys.executable, *args]}
    runs.update({k: [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shp,
                     "--parallelism", par, "--force"]
                 for k, (arch, shp, par) in DRYRUN_CELLS.items()})
    return {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
            for k, c in runs.items()}


DRYRUN_CELLS = {"train_4k": ("granite-3-8b", "train_4k", "tp_fsdp"),
                "train_4k_fsdp": ("granite-3-8b", "train_4k", "fsdp"),
                "decode_32k": ("granite-3-8b", "decode_32k", "tp_fsdp"),
                **{f"{arch} train_4k": (arch, "train_4k", "tp_fsdp")
                   for arch in MESH_FAMILIES}}


def phase19_torchrun(procs: dict) -> dict:
    """(b) ``launch.train`` on the reduced granite, 3 steps, under
    ``torch.distributed.run`` with one rank (NCCL, the sharded route)
    and run alone (one-rank world, unsharded): both exit 0 with the same
    final loss."""
    out = {}
    for k in ("torchrun", "alone"):
        p = procs[k]
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, (k, se[-3000:])
        line = [x for x in so.splitlines() if x.startswith("final loss")]
        assert line, (k, so[-2000:])
        out[k] = line[-1]
        print(f"  {k}: {line[-1]}")
    assert out["torchrun"] == out["alone"], out
    return out


def phase19_dryrun(procs: dict) -> dict:
    """(c) ``python -m repro_torch.launch.dryrun`` for granite-3-8b x
    train_4k on 16 x 16 under both parallelisms and x decode_32k, and
    the four families of (d) x train_4k, seven processes at once:
    collective bytes by kind, argument bytes per rank (held to the local
    shards' bytes, from ``local_shape`` of every spec), fsdp's total
    below tp_fsdp's, the families' all-reduces over the model axis."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shapes import axis_mapping, batch_shapes
    from repro_torch.models import spmd
    from repro_torch.models import transformer as T
    from repro_torch.models.base import map_tree
    cells = DRYRUN_CELLS
    for k in cells:
        so, se = procs[k].communicate(timeout=300)
        assert procs[k].returncode == 0, (k, se[-3000:])
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    out = {}
    for k, (arch, shp, par) in cells.items():
        cfg = get_config(arch)
        with open(dryrun.artifact_path(arch, shp, False, par)) as f:
            r = json.load(f)
        assert r["ok"], r
        shape = SHAPES[shp]
        mapping = axis_mapping(cfg, shape, mesh, par)
        m = 1 if par == "fsdp" else 16
        pshapes, pspecs = T.param_shapes(cfg, m), T.param_specs(cfg, m)
        pb = spmd.local_bytes(pshapes, pspecs, sizes, mapping)
        if shape.kind == "train":
            bsh, bsp = batch_shapes(cfg, shape)
            moments = spmd.local_bytes(map_tree(lambda t: t.float(),
                                                pshapes), pspecs, sizes,
                                       mapping)
            want = pb + 2 * moments + 4 + \
                spmd.local_bytes(bsh, bsp, sizes, mapping)
        else:
            b = shape.global_batch
            want = pb + spmd.local_bytes(
                T.cache_shapes(cfg, b, shape.seq_len, m),
                T.cache_specs(cfg, b, shape.seq_len, m), sizes, mapping) + \
                spmd.local_bytes({"t": torch.empty((b,), dtype=torch.int32,
                                                   device="meta")},
                                 {"t": T.P("data")}, sizes, mapping)
        got = r["memory"]["argument_size_in_bytes"]
        print(f"  {k}: collective bytes {r['collective_bytes']} (total "
              f"{r['collective_bytes_total']:.4e}), argument bytes per rank "
              f"{got} (local shards {want}), flops {r['flops']:.4e}")
        assert got == want, (k, got, want)
        if arch in MESH_FAMILIES:
            assert r["collective_bytes"]["all-reduce"] > 0, (k, r)
        out[k] = r
    assert out["train_4k_fsdp"]["collective_bytes_total"] < \
        out["train_4k"]["collective_bytes_total"], out
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


# --------------- the last single-card modules (phase 18) --------------------


def phase18_report(cfg, params, qparams, seed: int, kernels: dict) -> dict:
    """(a) ``logit_report`` on the full-width, full-depth granite: its
    bf16 tree against its int8 projections (``quantize_params``) on 2
    prompts of 128 tokens from ``seed``, with every launch count at 0
    just before.  Row 10 launches on each quantized projection of every
    layer, row 4 once a layer per tree, nothing else (the wide tree's
    projections are cuBLAS's).  The quantized tree's logits on the kernel
    path are held against its plain path's (``hold_logits`` at each
    prompt's last position, and within 5% of max |logit| over every
    position); the wide tree against itself reports no error.  JAX's
    accuracy gate (top-1 >= 0.9, rel_err < 0.05, on the reduced config)
    is printed beside the numbers, not held: random weights at full
    depth.  The report on the plain path (``use_kernel=False``) is
    printed beside it, its max_abs_err within 10% of max |logit| of the
    kernel path's."""
    import torch
    from repro_torch.quant import QUANT_KEYS, logit_report, sequence_logits
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (2, 128), dtype=np.int32)
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    rep = logit_report(cfg, params, qparams, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    want = {"matmul_w8": len(QUANT_KEYS) * cfg.n_layers,
            "flash_attention": 2 * cfg.n_layers}
    print(f"  logit_report, 2 x 128 tokens, {cfg.n_layers} layers: "
          f"max_abs_err {rep['max_abs_err']:.6g}, mean_abs_err "
          f"{rep['mean_abs_err']:.6g}, rel_err {rep['rel_err']:.6g}, "
          f"top1_agreement {rep['top1_agreement']:.6g} in {wall:.2f}s; "
          f"launches {launches}")
    assert all(v == want.get(k, 0) for k, v in launches.items()), \
        (launches, want)
    assert all(np.isfinite(v) for v in rep.values()), rep
    gate = rep["top1_agreement"] >= 0.9 and rep["rel_err"] < 0.05
    print(f"  JAX's reduced-config gate (top-1 >= 0.9, rel_err < 0.05): "
          f"{'met' if gate else 'missed'} at full depth (not held here)")
    got = sequence_logits(cfg, qparams, tokens)
    plain = sequence_logits(cfg, qparams, tokens, use_kernel=False)
    assert got.shape == plain.shape == (2, 128, cfg.vocab)
    held = [hold_logits(f"w8, prompt {b}", got[b, -1], plain[b, -1],
                        "report logits (kernel vs plain path)")
            for b in range(2)]
    dev_ = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    print(f"  every position: max |diff| {dev_:.3e} of max |logit| "
          f"{scale:.3e} (bound 5%)")
    assert bool(torch.isfinite(got).all()) and dev_ <= 0.05 * scale
    # the report on the plain path: each tree's logits there are within
    # 5% of max |logit| of its kernel path's, so max_abs_err within 10%
    rep_plain = logit_report(cfg, params, qparams, tokens, use_kernel=False)
    gap = abs(rep_plain["max_abs_err"] - rep["max_abs_err"])
    print(f"  logit_report on the plain path: {rep_plain}; max_abs_err "
          f"{gap:.3e} from the kernel path's (bound 10% of max |logit|)")
    assert all(np.isfinite(v) for v in rep_plain.values()), rep_plain
    assert gap <= 0.1 * scale, (rep_plain, rep)
    same = logit_report(cfg, params, params, tokens)
    print(f"  identity report (bf16 tree against itself): {same}")
    assert same == {"max_abs_err": 0.0, "mean_abs_err": 0.0,
                    "rel_err": 0.0, "top1_agreement": 1.0}, same
    del got, plain
    return {"report": rep, "report_plain": rep_plain, "wall_s": wall,
            "launches": launches, "jax_gate_met": gate,
            "kernel_vs_plain": held,
            "all_positions": {"max_abs_diff": dev_, "max_abs_logit": scale},
            "identity": same}


def phase18_calibrate(cfg, params, seed: int) -> dict:
    """(b) ``AbsMaxCalibrator`` and ``AbsMaxCalibrator(momentum=0.9)`` on
    the final hidden state of three full-width bf16 forwards (2 x 128
    tokens each, from ``seed``): the statistics stay on the card and
    equal the same absmax taken by a plain torch reduction over the host
    copies, and the int8 and fp8 scales equal the scale rule applied to
    that host statistic (the EMA within 1e-6 relative)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.quant import QUANT_DTYPES, AbsMaxCalibrator
    from repro_torch.quant.quantize import _EPS
    rng = np.random.default_rng(seed + 1)
    absmax, ema = AbsMaxCalibrator(), AbsMaxCalibrator(momentum=0.9)
    host = []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(3):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (2, 128), dtype=np.int32)).cuda()
            h, _ = T.forward(cfg, params, toks)
            absmax.observe({"h": h})
            ema.observe({"h": h})
            host.append(h.cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_batch = [x.float().abs().amax() for x in host]
    want_abs = torch.stack(per_batch).amax()
    want_ema = per_batch[0]
    for a in per_batch[1:]:
        want_ema = 0.9 * want_ema + (1.0 - 0.9) * a
    out = {"wall_s": wall, "per_batch_absmax": [float(a) for a in per_batch]}
    for name, cal, want, rel in (("absmax", absmax, want_abs, 0.0),
                                 ("ema 0.9", ema, want_ema, 1e-6)):
        stat = cal._absmax["h"]
        assert stat.device.type == "cuda" and stat.dtype == torch.float32 \
            and stat.dim() == 0, (name, stat.device, stat.dtype)
        err = abs(float(stat) - float(want)) / float(want)
        print(f"  {name}: statistic {float(stat):.9g} on {stat.device}, "
              f"host reduction {float(want):.9g}, relative difference "
              f"{err:.3g} (bound {rel:g})")
        assert err <= rel, (name, float(stat), float(want))
        row = {"absmax": float(stat)}
        for dtype, (_, qmax) in QUANT_DTYPES.items():
            scale = cal.scales(dtype)["h"]
            assert scale.device.type == "cuda", (name, scale.device)
            # the scale rule on the card, over the host's statistic (the
            # card divides by a scalar through its reciprocal: the host's
            # own division may differ in the last bit)
            ref = want.cuda() / qmax + _EPS
            err = abs(float(scale) - float(ref)) / float(ref)
            host_scale = float(want / qmax + _EPS)
            print(f"    {dtype}: scale {float(scale):.9g}, the rule over "
                  f"the host statistic {float(ref):.9g} (relative "
                  f"difference {err:.3g}, bound {rel:g}; divided on the "
                  f"host {host_scale:.9g})")
            assert err <= rel, (name, dtype, float(scale), float(ref))
            row[dtype] = float(scale)
        out[name] = row
    print(f"  three forwards observed in {wall:.2f}s; per-batch absmax "
          f"{out['per_batch_absmax']}")
    return out


EXAMPLES = (("quickstart_torch.py", ()),
            ("serve_lm_torch.py", ()),
            ("train_lm_torch.py", ()),
            ("schedule_search_torch.py",
             ("--layer", "Conv4", "--hopper", "--measure", "--cache")))
# the kernel rows each example's process must launch (run_counted)
EXAMPLE_KERNELS = {"serve_lm_torch.py": ("flash_attention", "flash_decode"),
                   "train_lm_torch.py": ("flash_attention",
                                         "flash_attention_bwd"),
                   "schedule_search_torch.py": ("conv2d_block",)}


def run_counted(script: str, *args: str) -> None:
    """Run the example ``script`` as ``__main__`` with ``args``, every
    launch count at 0 just before; print the counts after it as one
    ``launches {...}`` JSON line, last."""
    import runpy
    kernels = kernel_fns()
    reset(kernels)
    sys.argv = [script, *args]
    runpy.run_path(script, run_name="__main__")
    print("launches " + json.dumps(counts(kernels)))


def phase18_examples(seed: int) -> dict:
    """(c) The four examples, each a process of its own with its
    defaults, all started together (so each one's seconds include the
    others' load on the host and the card), with the schedule cache in a
    temporary directory: ``serve_lm_torch`` prints ``matches-static=True``
    for its three archs, ``train_lm_torch`` passes its own convergence
    assert and restart drill, ``quickstart_torch`` exits 0, and
    ``schedule_search_torch --hopper --measure`` times Conv4's candidates
    into its cache.  The three that reach the card run through
    :func:`run_counted`, and each must have launched its rows of
    ``EXAMPLE_KERNELS``.  Then a fresh process with ``REPRO_TORCH_TUNE_CACHE``
    on that cache runs ``ops.conv2d`` on Conv4 with no tiles given
    (:func:`conv_cache_pickup`): it must take the cached tiles."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    cache = str(Path(tmp) / "conv4.json")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_TUNE_CACHE": str(Path(tmp) / "default.json")}
    procs, logs = {}, {}
    t0 = time.perf_counter()
    try:
        for name, args in EXAMPLES:
            args = (*args, cache) if "--cache" in args else args
            cmd = [str(ROOT / "examples" / name), *args]
            if name in EXAMPLE_KERNELS:
                cmd = ["-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                       "import chip_smoke; chip_smoke.run_counted("
                       "*sys.argv[2:])", str(ROOT), *cmd]
            with open(Path(tmp) / f"{name}.out", "w") as fo, \
                    open(Path(tmp) / f"{name}.err", "w") as fe:
                procs[name] = subprocess.Popen(
                    [sys.executable, *cmd], env=env, cwd=tmp, stdout=fo,
                    stderr=fe)
        done = {}
        while len(done) < len(procs):       # each one's seconds at exit
            for name, proc in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            assert time.perf_counter() - t0 < 600, "an example hung"
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name, proc in procs.items():
        stdout, stderr = ((Path(tmp) / f"{name}.{ext}").read_text()
                          for ext in ("out", "err"))
        print(f"  {name}: exit {proc.returncode} after {done[name]:.1f}s; "
              f"its stdout:")
        for line in stdout.splitlines():
            print(f"    | {line}")
        if proc.returncode != 0:
            print(stderr[-4000:])
        assert proc.returncode == 0, name
        out[name] = {"s": done[name], "rc": proc.returncode}
        logs[name] = stdout.splitlines()
        if name in EXAMPLE_KERNELS:
            tag, launched = logs[name].pop().split(" ", 1)
            launched = json.loads(launched)
            assert tag == "launches" and all(
                launched[k] > 0 for k in EXAMPLE_KERNELS[name]), \
                (name, launched)
            out[name]["launches"] = {k: n for k, n in launched.items()
                                     if n}
    matches = {x.split()[0]: "matches-static=True" in x
               for x in logs["serve_lm_torch.py"] if "matches-static=" in x}
    out["serve_lm_torch.py"]["matches_static"] = matches
    assert list(matches) == ["granite-3-8b", "recurrentgemma-9b",
                             "mamba2-780m"] and all(matches.values()), \
        matches
    train = logs["train_lm_torch.py"]
    out["train_lm_torch.py"]["loss"] = next(
        x for x in train if x.startswith("loss: "))
    assert train[-1] == "resumed OK", train[-3:]
    out["schedule_search_torch.py"]["winner"] = next(
        x for x in logs["schedule_search_torch.py"]
        if x.startswith("winner (measured"))
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
         "chip_smoke.conv_cache_pickup(sys.argv[2], int(sys.argv[3]))",
         str(ROOT), cache, str(seed)],
        env={**env, "REPRO_TORCH_TUNE_CACHE": cache}, cwd=tmp,
        capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        print(f"    | {line}")
    if res.returncode != 0:
        print(res.stderr[-4000:])
    assert res.returncode == 0, "the Conv4 cache pickup failed"
    pickup = json.loads(res.stdout.splitlines()[-1].split(" ", 1)[1])
    pickup["s"] = time.perf_counter() - t1
    out["conv4_cache_pickup"] = pickup
    shutil.rmtree(tmp, ignore_errors=True)
    print("examples " + json.dumps(out))
    return out


def conv_cache_pickup(cache: str, seed: int) -> None:
    """Run in a fresh process with ``REPRO_TORCH_TUNE_CACHE`` on
    ``cache``: ``ops.conv2d`` on Conv4 (batch 2, bf16) with no tiles
    given must resolve the cached ``"conv2d"`` schedule (source
    ``cache``, the stored tiles) and launch row 12 once; its output is
    held against row 12's plain version on fp32 copies of the inputs at
    phase 12's gate.  Prints one ``pickup {...}`` JSON line last."""
    import torch
    from repro_torch import tune
    from repro_torch.configs import PAPER_LAYERS
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d_blocked import (conv2d_block,
                                                    conv2d_blocked_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = PAPER_LAYERS["Conv4"]
    spec = tune.OpSpec("conv2d", (p.X, p.Y, p.C, p.K, p.Fw, p.Fh),
                       "bfloat16")
    stored = tune.ScheduleCache(cache).lookup(spec)
    assert stored is not None, f"no Conv4 entry in {cache}"
    x, w, _ = conv_inputs(torch.device("cuda"), torch.bfloat16, 2,
                          p.Y + p.Fh - 1, p.X + p.Fw - 1, p.C, p.K, p.Fh,
                          p.Fw, 1, seed)
    resolved = []
    prev = tune.set_schedule_observer(
        lambda sp, sch: resolved.append((sp, sch)))
    try:
        conv2d_block.launches = 0
        y = ops.conv2d(x, w)
        torch.cuda.synchronize()
    finally:
        tune.set_schedule_observer(prev)
    assert [sp for sp, _ in resolved] == [spec], resolved
    sch = resolved[0][1]
    print(f"Conv4 ops.conv2d resolved tiles {sch.tiles} ({sch.source}); "
          f"cached {stored.tiles}; row 12 launches {conv2d_block.launches}")
    assert sch.source == "cache" and sch.tiles == stored.tiles, sch
    assert conv2d_block.launches == 1
    err = hold_conv("Conv4 y (cached tiles)", y,
                    conv2d_blocked_ref(x.float(), w.float()),
                    p.C * p.Fh * p.Fw)
    print("pickup " + json.dumps({"tiles": list(sch.tiles),
                                  "source": sch.source,
                                  "launches": conv2d_block.launches,
                                  "max_abs_err": err}))


def phase18_fused_model(fused: dict) -> dict:
    """(d) The fused-chain model at the card's budget: ``optimize_fused``
    for granite-3-8b's SwiGLU MLP (``FusedProblem.mlp(M, 4096, 12800,
    swiglu=True)``) at ``default_smem_budget()``, M = 8 (decode) and the
    fused engine's prefill chunk (phase 6b), at the module's default
    alignment (8 rows, 128 columns) and at the Hopper target's (16 rows,
    64 columns).  The only gate is the module's own consistency: the top
    result's bytes equal ``fused_dram_bytes`` at its tiles.  No timing."""
    from repro_torch.core import (H100_SXM, FusedProblem,
                                  default_smem_budget, optimize_fused)
    budget = default_smem_budget()
    out = {"budget": budget}
    for m in (8, fused["prefill_chunk"]):
        fp = FusedProblem.mlp(m, 4096, 12800, swiglu=True)
        for label, kw in (("default", {}),
                          ("hopper", {"m_align": H100_SXM.m_mult,
                                      "n_align": H100_SXM.nk_mult})):
            res = optimize_fused(fp, budget, **kw)
            key = f"M{m}_{label}"
            if not res:
                print(f"  M {m}, {label} alignment {kw or '(8, 128)'}: "
                      f"no joint schedule fits {budget} B")
                out[key] = None
                continue
            best = res[0]
            assert best.fused_bytes == fp.fused_dram_bytes(best.tiles,
                                                           budget)
            tr = best.traffic
            print(f"  M {m}, {label} alignment {kw or '(8, 128)'}: "
                  f"{best.summary()}; intermediate resident "
                  f"{tr.intermediate_resident}, its tile "
                  f"{fp.intermediate_tile_bytes(0, best.tiles[0][0])} B; "
                  f"{len(res)} results")
            out[key] = {"tiles": [list(t) for t in best.tiles],
                        "fused_bytes": best.fused_bytes,
                        "unfused_bytes": best.unfused_bytes,
                        "savings_frac": best.savings_frac,
                        "resident": list(tr.intermediate_resident),
                        "results": len(res)}
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


def kernel_fns() -> dict:
    """Every kernel's wrapper by name; each counts its own launches."""
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
    return {"conv2d_block": CB.conv2d_block,
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
    kernels = kernel_fns()

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
    decode = [(label, regs, spill) for name in ("flash_decode",
                                                "flash_decode_fp8")
              for label, regs, spill in ptxas_report(reports.get(name, ""))
              if label.startswith("decode_mma_kernel<")]
    if decode:
        print(f"  rows 1, 2: {len(decode)} decode_mma_kernel instances, "
              f"{min(r for _, r, _ in decode)}-"
              f"{max(r for _, r, _ in decode)} registers, "
              f"{sum(sp for _, _, sp in decode)} B spilled in all")
        assert sum(sp for _, _, sp in decode) == 0, decode
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

    # phase 19's subprocesses (the launchers, the dry run) need only the
    # build: they run beside phase 3 and are read in phase 19
    procs19 = phase19_start()

    phase("phase 3: kernels vs plain versions")
    for check in (phase3_kernels, phase3_decode_grid, phase3_verify_spans,
                  phase3_head_dims,
                  phase3_oproj_wide, phase3_wide_groups, phase3_families,
                  phase3_fused,
                  phase3_quant, phase3_train, phase3_conv):
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
    phase("phase 13b: the six new archs' reduced configs on the card: "
          "static and paged serving parity, unfused and fused, 3 training "
          "steps, the launchers' usage lines")
    families = {"reduced": phase13_families(args.seed, kernels)}
    phase("phase 16a: the serving features, granite-3-8b width, 2 layers, "
          "fp32, unfused, fused and w8fp8: speculative decode, the prefix "
          "cache, preemption, the NaN guard, shutdown, engine_smoke")
    features = {"gate": phase16_gate(args.seed, kernels)}
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
    phase("phase 15: the observability stack on phase 6b's path: untraced "
          "and traced + profiled, the fidelity gate under --corrupt")
    observed = phase15_observed(cfg, params, prompts, kernels)
    phase("phase 16b: the serving features on the full granite-3-8b, bf16: "
          "speculative decode k=2 fused, the prefix cache on a zipf "
          "workload, the verify step's logits against plain")
    features["full"] = phase16_full(cfg, params, prompts, kernels)
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
    phase("phase 18a: the fake-quant logit report at full width and depth: "
          "the bf16 tree against its int8 projections, 2 x 128 tokens; "
          "the kernel path's quantized logits against the plain path's")
    modules = {"report": phase18_report(cfg, params, qparams, args.seed,
                                        kernels)}
    phase("phase 18b: activation calibration on the card: absmax and EMA "
          "over three full-width bf16 forwards, scales against a host "
          "reduction")
    modules["calibration"] = phase18_calibrate(cfg, params, args.seed)
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
    phase("phase 15b: phase 11's blocked training, 2 steps, untraced and "
          "traced + profiled")
    observed["train"] = phase15_train(args.seed, kernels)
    phase("phase 19a: the sharded train step on a one-rank NCCL mesh: "
          "granite-3-8b full width, 4 of 40 layers, bf16, 3 steps under "
          "tp_fsdp, fsdp, tp_fsdp + compressed grads and tp_fsdp + blocked "
          "linears, each against the unsharded step")
    t19 = time.perf_counter()
    distributed = {"sharded": phase19_sharded(args.seed, kernels)}
    phase("phase 19d: the SSD, RG-LRU, encoder-decoder and vision-prefix "
          "families on the one-rank mesh: full width, bf16, a mesh prefill "
          "+ 8 decode steps and 2 sharded train steps each against the "
          "unsharded ones")
    t19d = time.perf_counter()
    distributed["families"] = phase19_families(args.seed, kernels)
    distributed["phase19d_s"] = time.perf_counter() - t19d
    print(f"  phase 19d: {distributed['phase19d_s']:.1f}s")
    import torch.distributed as dist
    dist.destroy_process_group()
    phase("phase 19b: launch.train under torch.distributed.run (one rank) "
          "and alone, the reduced granite, 3 steps (started after phase 2)")
    distributed["torchrun"] = phase19_torchrun(procs19)
    phase("phase 19c: the dry run on the 16 x 16 mesh: granite-3-8b "
          "train_4k under tp_fsdp and fsdp, decode_32k, the four families' "
          "train_4k (started after phase 2)")
    distributed["dryrun"] = phase19_dryrun(procs19)
    distributed["phase19_s"] = time.perf_counter() - t19
    print(f"  phase 19: {distributed['phase19_s']:.1f}s")
    phase("phase 12: the paper's conv path at full Table-4 size: Conv1-5 "
          "and AlexNet conv1, batch 2, bf16, ops.conv2d forward and "
          "backward")
    conv = phase12_conv(kernels)
    phase("phase 14: the static-batch engine (dense caches, a ring for "
          "local layers): (a) parity at full width, 2 layers, fp32, four "
          "archs; (b) gemma2-9b, 14 of 42 layers, bf16, past the ring's "
          "wrap; "
          "(c) glm4-9b and granite-34b, 4 layers, bf16")
    dense = {"parity": phase14_parity(args.seed, kernels),
             "gemma2-9b": phase14_gemma2(args.seed, kernels),
             "wide": phase14_wide(args.seed, kernels)}
    phase("phase 17a: the six new archs at full width, fp32, 2 layers "
          "(recurrentgemma 3): static and paged engines, kernel and plain "
          "paths, unfused and fused, recurrentgemma under w8fp8")
    t17 = time.perf_counter()
    families["gate"] = phase17_gate(args.seed, kernels)
    phase("phase 17b: five new archs at full width in bf16 (phi3.5-moe 8 "
          "of 32 layers): static and paged engines, tok/s, peak memory, "
          "prefill logits against the plain path")
    families["full"] = phase17_full(args.seed, kernels)
    families["phase17_s"] = time.perf_counter() - t17
    print(f"  phase 17: {families['phase17_s']:.1f}s")
    phase("phase 18c: the four examples on the card, each a process of "
          "its own, then the Conv4 cache pickup in a fresh process")
    examples = phase18_examples(args.seed)
    phase("phase 18d: the fused-chain model at the card's budget: "
          "optimize_fused for granite-3-8b's SwiGLU MLP at decode and the "
          "fused engine's prefill chunk")
    modules["fused_model"] = phase18_fused_model(fused)
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
    dense["kernels"] = time_wide_kernels()
    for name, t in time_conv_layers().items():
        conv[name].setdefault("timing", {})["layers"] = t
    print("serve " + json.dumps({"prompt_lens": [int(n) for n in lens],
                                 "cublas": cublas, "blocked": blocked,
                                 "fused": fused, "w8fp8": quant,
                                 "w8fp8_fused": quant_fused,
                                 "tune": tuned}))
    print("dense " + json.dumps(dense))
    print("train " + json.dumps({"parity": parity, "full_width": train,
                                 "reduced": reduced}))
    print("conv " + json.dumps(conv))
    print("observed " + json.dumps(observed))
    print("features " + json.dumps(features))
    print("families " + json.dumps(families))
    print("distributed " + json.dumps(distributed))
    print("modules " + json.dumps(
        {**modules, "examples_s": {k: v["s"] for k, v in examples.items()}}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
