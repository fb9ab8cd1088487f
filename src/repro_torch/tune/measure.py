"""Measurement on the card: time candidate schedules of one op instance.

Each candidate runs the port's kernel wrapper with its tiles pinned.  A
launch is timed with CUDA events, after a write of a buffer larger than
the H100's 50 MB L2 (the serving path reads every layer's weights
between two calls of one projection, so L2 is cold) and a device spin of
about a millisecond (so the host enqueues the start event and the kernel
while the device is busy, and the events time device work, not the
host's launch overhead).  The median over the launches is the time.

There is no CPU measurement: a time taken here would be the plain
version's on the host, not the kernel's, so without a CUDA device
:func:`measure` raises.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from repro_torch.tune.schedule import Schedule

L2_FLUSH_BYTES = 64 << 20


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "measuring a schedule needs a CUDA device; without one, rank "
            "analytically (measure=False, or --no-measure on the CLI)")
    return torch.device("cuda")


def make_inputs(schedule: Schedule, seed: int = 0) -> tuple:
    """Operands for the schedule's OpSpec on the card, from ``seed``.
    ``flash_decode`` and ``flash_decode_oproj``: one request, one kv
    head, its cache of S keys laid out in pages of the schedule's tile,
    under a shuffled block table (and the head's (G*D, E) wo slab;
    ``flash_decode_fp8``: fp8 pages and per-head scales);
    ``matmul_fused``: the MLP's epilogue shape, a bias row, a gelu and a
    residual block; ``matmul_w8``: int8 weights and per-channel scales;
    ``matmul_dgrad``: the dA product's cotangent (M, K_reduce) and the
    forward weight (N, K_reduce), read transposed, as JAX measures it;
    the conv keys: one image, its input haloed for the spec's output
    (``((Y-1)*s + Fh, (X-1)*s + Fw, C)``), and ``(Fh, Fw, C, K)`` weights
    or, for ``conv2d_wgrad``, the ``(Y, X, K)`` cotangent."""
    dev = _device()
    spec = schedule.spec
    dtype = getattr(torch, spec.dtype)
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.tensor(rng.standard_normal(shape), dtype=dt,
                            device=dev)
    if spec.op == "matmul":
        M, N, K = spec.dims
        return t(M, K), t(K, N) * K ** -0.5
    if spec.op == "matmul_dgrad":
        M, N, K = spec.dims
        return t(M, K), t(N, K) * K ** -0.5
    if spec.op == "matmul_fused":
        M, N, K = spec.dims
        return (t(M, K), t(K, N) * K ** -0.5, t(N, dt=torch.float32),
                t(M, N))
    if spec.op == "qkv_fused":
        M, Nkv, K, G = spec.dims
        return (t(M, K), t(K, G * Nkv) * K ** -0.5, t(K, Nkv) * K ** -0.5,
                t(K, Nkv) * K ** -0.5)
    if spec.op in ("conv2d", "conv2d_dgrad", "conv2d_wgrad"):
        X, Y, C, K, Fw, Fh = spec.dims
        x = t(1, (Y - 1) * spec.stride + Fh, (X - 1) * spec.stride + Fw, C)
        if spec.op == "conv2d_wgrad":
            return x, t(1, Y, X, K) * 0.5
        return x, t(Fh, Fw, C, K) * 0.5
    if spec.op == "matmul_w8":
        M, N, K = spec.dims
        w_q = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8,
                           device=dev)
        scale = torch.tensor(rng.uniform(0.005, 0.05, N) * K ** -0.5,
                             dtype=torch.float32, device=dev)
        return t(M, K), w_q, scale
    G, S, D = spec.dims[:3]
    (page,) = schedule.tiles
    n_blocks = -(-S // page)
    bt = torch.tensor(1 + rng.permutation(n_blocks)[None, :],
                      dtype=torch.int32, device=dev)
    lengths = torch.tensor([S], dtype=torch.int32, device=dev)
    if spec.op == "flash_decode_fp8":
        fp8 = torch.float8_e4m3fn
        return (t(1, 1, G, D), t(n_blocks + 1, page, 1, D).to(fp8),
                t(n_blocks + 1, page, 1, D).to(fp8),
                torch.tensor(rng.uniform(0.5, 2.0, 1), dtype=torch.float32,
                             device=dev),
                torch.tensor(rng.uniform(0.5, 2.0, 1), dtype=torch.float32,
                             device=dev), bt, lengths)
    paged = (t(1, 1, G, D), t(n_blocks + 1, page, 1, D),
             t(n_blocks + 1, page, 1, D), bt, lengths)
    if spec.op == "flash_decode_oproj":
        E = spec.dims[3]
        return paged + (t(1, G * D, E) * (G * D) ** -0.5,)
    return paged


def run_once(schedule: Schedule, inputs: tuple):
    """Launch the schedule's kernel once on ``inputs``."""
    op = schedule.spec.op
    if op == "matmul":
        from repro_torch.kernels.matmul_blocked import matmul_blocked
        bm, bk, bn = schedule.tiles
        a, b = inputs
        return matmul_blocked(a, b, bm=bm, bk=bk, bn=bn)
    if op == "matmul_dgrad":
        from repro_torch.kernels.matmul_bwd import matmul_dgrad_a
        bm, br, bo = schedule.tiles
        return matmul_dgrad_a(*inputs, bm=bm, br=br, bo=bo)
    if op == "matmul_fused":
        from repro_torch.kernels.matmul_fused import matmul_fused
        bm, bk, bn = schedule.tiles
        a, w, bias, res = inputs
        return matmul_fused(a, w, bias=bias, residual=res, act="gelu",
                            bm=bm, bk=bk, bn=bn)
    if op == "qkv_fused":
        from repro_torch.kernels.qkv_fused import qkv_fused
        bm, bk, bn = schedule.tiles
        return qkv_fused(*inputs, bm=bm, bk=bk, bn=bn)
    if op == "matmul_w8":
        from repro_torch.kernels.matmul_q import matmul_w8
        bm, bk, bn = schedule.tiles
        return matmul_w8(*inputs, bm=bm, bk=bk, bn=bn)
    if op == "conv2d_wgrad":
        from repro_torch.kernels.conv2d_bwd import conv2d_wgrad_block
        bx, by, bc, bk = schedule.tiles
        _, _, _, _, fw, fh = schedule.spec.dims
        return conv2d_wgrad_block(*inputs, fh, fw, bx=bx, by=by, bc=bc,
                                  bk=bk, stride=schedule.spec.stride)
    if op in ("conv2d", "conv2d_dgrad"):   # the dgrad runs the forward
        from repro_torch.kernels.conv2d_blocked import conv2d_tiled
        bx, by, bc, bk = schedule.tiles
        return conv2d_tiled(*inputs, bx=bx, by=by, bc=bc, bk=bk,
                            stride=schedule.spec.stride)
    from repro_torch.kernels import flash_decode as FD
    if op == "flash_decode_fp8":
        return FD.flash_decode_fp8(*inputs)
    if op == "flash_decode_oproj":
        return FD.flash_decode_oproj(*inputs)
    return FD.flash_decode(*inputs)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` launches, each
    after an L2 flush and a device spin (module docstring)."""
    dev = _device()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def measure(schedule: Schedule, reps: int = 20, seed: int = 0) -> float:
    """Median device time of one schedule, in microseconds."""
    inputs = make_inputs(schedule, seed)
    return 1e3 * time_ms(lambda: run_once(schedule, inputs), reps=reps)


def measure_top(schedules: list[Schedule], top_n: int = 3,
                reps: int = 20) -> list[Schedule]:
    """Time the first ``top_n`` schedules; return ALL schedules re-ranked
    (measured ones first, by time; the rest keep their analytic order
    behind them)."""
    timed = [dataclasses.replace(s, measured_us=measure(s, reps),
                                 source="measured")
             for s in schedules[:top_n]]
    timed.sort(key=lambda s: s.measured_us)
    return timed + schedules[top_n:]
