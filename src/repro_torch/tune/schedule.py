"""Schedule data model of the tuner (the port of ``repro.tune.schedule``
for the keys the port runs).

An :class:`OpSpec` names one tunable operator instance -- the op kind
plus the problem dimensions the kernels see:

* ``matmul``: ``dims = (M, N, K)`` for ``C[M,N] = A[M,K] @ B[K,N]``;
  tiles ``(bm, bk, bn)`` of ``kernels/matmul_blocked.py`` (the tile
  core's in fp32; in bf16 its tensor-core instances', which are
  ``matmul_fused``'s: ``MMA_GEMM_OPS``, at M <= 16 one decode tile that
  fills the card);
* ``matmul_dgrad``: the backward GEMMs of ``kernels/matmul_bwd.py``;
  ``dims = (M, N, K)`` of the *cotangent* being produced in the
  (M_out, N_out, K_reduce) convention (dA: ``(M, K_fwd, N_fwd)``; dB:
  ``(K_fwd, N_fwd, M_fwd)``), tiles ``(bm, bk, bn)`` in the usual row,
  reduction and column roles;
* ``flash_decode``: ``dims = (G, S, D)`` -- per (batch, kv head) decode
  attention where the G query heads of a GQA group stream over an S-long
  paged KV cache of head dim D.  The single tile ``(page,)`` is the
  flash-decode kernel's KV tile AND the paged cache's page size
  (``serve/kv_cache.py``), so the model fixes both at once.

The fused path's keys (``FUSED_OPS``; kernels whose output tile absorbs
the next op's work instead of round-tripping through HBM):

* ``matmul_fused``: ``dims = (M, N, K)`` like any GEMM; tiles
  ``(bm, bk, bn)`` of ``kernels/matmul_fused.py`` under its own
  footprint (the blocked GEMM's in fp32; in bf16 its tensor-core
  instances', at M <= 16 one decode tile that fills the card);
* ``qkv_fused``: ``dims = (M, Nkv, K, G)``, Nkv the per-projection k/v
  width and G = Hq / Hkv (the q projection is G * Nkv wide); tiles
  ``(bm, bk, bn)`` block Nkv -- the nest is the joint GEMM, each block
  producing (G + 2) * bn output columns from one activation tile, as
  the fp32 kernel runs it; the bf16 kernel runs one projection's (bm,
  bn) tile a block on the fused GEMM's tensor-core instances;
* ``flash_decode_oproj``: ``dims = (G, S, D, E)`` (E = d_model); the
  single ``(page,)`` tile is still the KV tile AND the page size -- a
  fused engine sizes its pages under this key, because the kernel's
  extra shared memory (the G x D rows and the (1, E) partial) squeezes
  the budget the page competes for.

The quantized keys (``NARROW_WEIGHT_BYTES``: the narrow operand is one
byte wide whatever the spec's activation dtype):

* ``matmul_w8``: ``dims = (M, N, K)``; tiles ``(bm, bk, bn)`` of
  ``kernels/matmul_q.py``, the weight operand int8, activations and
  output at ``dtype``'s width; in bf16 under ``matmul_fused``'s
  tensor-core footprint, which its kernel runs (``MMA_GEMM_OPS``);
* ``matmul_fused_w8``: the int8-weight ``matmul_fused``, ``dims = (M, N,
  K)``, under the fused kernel's footprint with its weight at one byte;
* ``flash_decode_fp8``: ``dims = (G, S, D)``; the ``(page,)`` tile of
  ``flash_decode_fp8`` and the fp8 pool's page size, the streamed K/V
  pages fp8 while q keeps ``dtype``.

The paper's conv path (``CONV_OPS``; tiles ``(bx, by, bc, bk)``, the
spec carries a ``stride``):

* ``conv2d``: ``dims = (X, Y, C, K, Fw, Fh)`` in the paper's output-space
  coordinates (X = output width, Y = output height); the direct blocked
  conv of ``kernels/conv2d_blocked.py`` (row 12);
* ``conv2d_dgrad``: the transposed conv as a direct conv -- dims in *its*
  output space with the channels swapped (``(W, H, K_fwd, C_fwd, Fw,
  Fh)``, stride 1 after host-side input dilation); it runs row 12;
* ``conv2d_wgrad``: the forward conv's dims verbatim at the forward's
  stride; ``(bx, by)`` block the spatial *reduction*, ``(bc, bk)`` the
  channel dims of the dW tile (``kernels/conv2d_bwd.py``, row 13).

A :class:`Schedule` is a concrete kernel configuration for that spec: the
tile tuple, where it came from (``analytic`` / ``measured`` / ``cache``),
the model's predicted DRAM-boundary accesses, and -- when timed on the
card -- the measured latency.  Both serialize losslessly to the JSON
dicts the schedule cache stores.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.loopnest import Problem

FUSED_OPS = ("matmul_fused", "qkv_fused", "flash_decode_oproj")
# quantized ops: the narrow operand (weights / KV pages) is 1 byte wide
# regardless of the spec's activation dtype
NARROW_WEIGHT_BYTES = {"matmul_w8": 1, "flash_decode_fp8": 1,
                       "matmul_fused_w8": 1}
# the GEMM nests: one (M, N, K) problem, (bm, bk, bn) tiles
GEMM_OPS = ("matmul", "matmul_dgrad", "matmul_fused", "matmul_w8",
            "matmul_fused_w8")
# the GEMM keys whose bf16 kernels are row 9's tensor-core instances
# (csrc/gemm_mma_inst.cuh; rows 6, 9 and 10): their footprint is
# matmul_fused.py's (in fp32 each runs the blocked GEMM's tile core, and
# the two footprints agree)
MMA_GEMM_OPS = ("matmul", "matmul_fused", "matmul_fused_w8", "matmul_w8")
# the conv nests: (X, Y, C, K, Fw, Fh) and a stride, (bx, by, bc, bk) tiles
CONV_OPS = ("conv2d", "conv2d_dgrad", "conv2d_wgrad")
OPS = (("matmul", "matmul_dgrad", "flash_decode") + FUSED_OPS
       + tuple(NARROW_WEIGHT_BYTES) + CONV_OPS)
TILE_RANK = {"matmul": 3, "matmul_dgrad": 3, "flash_decode": 1,
             "matmul_fused": 3, "qkv_fused": 3, "flash_decode_oproj": 1,
             "matmul_w8": 3, "flash_decode_fp8": 1, "matmul_fused_w8": 3,
             **{op: 4 for op in CONV_OPS}}
_N_DIMS = {"matmul": 3, "matmul_dgrad": 3, "flash_decode": 3,
           "matmul_fused": 3, "qkv_fused": 4, "flash_decode_oproj": 4,
           "matmul_w8": 3, "flash_decode_fp8": 3, "matmul_fused_w8": 3,
           **{op: 6 for op in CONV_OPS}}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One tunable operator instance (the cache-key identity)."""

    op: str
    dims: tuple[int, ...]
    dtype: str = "float32"
    stride: int = 1

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; expected one of {OPS}")
        want = _N_DIMS[self.op]
        if len(self.dims) != want:
            raise ValueError(
                f"{self.op} expects {want} dims, got {self.dims}")
        if any(d < 1 for d in self.dims) or self.stride < 1:
            raise ValueError(
                f"dims and stride must be >= 1, got dims={self.dims} "
                f"stride={self.stride}")
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))

    @property
    def itemsize(self) -> int:
        return getattr(torch, self.dtype).itemsize

    def problem(self) -> Problem:
        """The spec as the paper's loop-nest Problem.  Decode attention
        per (batch, kv head) is a skinny GEMM: the G query rows stream
        over the S-long KV cache producing D outputs, its reduction dim
        (C in the paper's nest) the KV length being blocked.  The fused
        QKV pass is the joint GEMM (one activation stream feeding all
        (G+2)*Nkv output columns); the oproj-fused decode is the decode
        nest (its projection only squeezes the shared-memory budget: the
        candidate filter sees E, the nest does not).  The quantized keys
        carry their narrow operand's width (``weight_bytes``): the GEMM's
        weights, and the decode nest's K/V stream.  The conv keys are the
        paper's own nest, with the stride."""
        wb = NARROW_WEIGHT_BYTES.get(self.op)
        if self.op in CONV_OPS:
            X, Y, C, K, Fw, Fh = self.dims
            return Problem(X=X, Y=Y, C=C, K=K, Fw=Fw, Fh=Fh,
                           stride=self.stride, bytes_per_elem=self.itemsize)
        if self.op in GEMM_OPS:
            M, N, K = self.dims
            return Problem.gemm(M=M, N_cols=N, K_reduce=K,
                                bytes_per_elem=self.itemsize,
                                weight_bytes=wb)
        if self.op == "qkv_fused":
            M, Nkv, K, G = self.dims
            return Problem.gemm(M=M, N_cols=(G + 2) * Nkv, K_reduce=K,
                                bytes_per_elem=self.itemsize)
        G, S, D = self.dims[:3]
        return Problem.gemm(M=G, N_cols=D, K_reduce=S,
                            bytes_per_elem=self.itemsize, weight_bytes=wb)

    def key(self, device_kind: str) -> str:
        """Stable cache key: ``op/dims/dtype/device``."""
        if self.op in GEMM_OPS:
            M, N, K = self.dims
            shape = f"m{M}n{N}k{K}"
        elif self.op == "qkv_fused":
            M, Nkv, K, G = self.dims
            shape = f"m{M}n{Nkv}k{K}g{G}"
        elif self.op == "flash_decode_oproj":
            G, S, D, E = self.dims
            shape = f"g{G}s{S}d{D}e{E}"
        elif self.op in CONV_OPS:
            X, Y, C, K, Fw, Fh = self.dims
            shape = f"x{X}y{Y}c{C}k{K}f{Fw}x{Fh}s{self.stride}"
        else:
            G, S, D = self.dims
            shape = f"g{G}s{S}d{D}"
        return f"{self.op}/{shape}/{self.dtype}/{device_kind}"


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A concrete kernel schedule for one OpSpec."""

    spec: OpSpec
    tiles: tuple[int, ...]
    source: str = "analytic"
    predicted_dram_accesses: int | None = None
    measured_us: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "tiles", tuple(int(t) for t in self.tiles))
        if len(self.tiles) != TILE_RANK[self.spec.op]:
            raise ValueError(
                f"{self.spec.op} schedule needs {TILE_RANK[self.spec.op]} "
                f"tile sizes, got {self.tiles}")

    def with_source(self, source: str) -> "Schedule":
        return dataclasses.replace(self, source=source)

    def to_json(self) -> dict:
        return {
            "op": self.spec.op,
            "dims": list(self.spec.dims),
            "dtype": self.spec.dtype,
            "stride": self.spec.stride,
            "tiles": list(self.tiles),
            "source": self.source,
            "predicted_dram_accesses": self.predicted_dram_accesses,
            "measured_us": self.measured_us,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Schedule":
        spec = OpSpec(op=d["op"], dims=tuple(d["dims"]),
                      dtype=d.get("dtype", "float32"),
                      stride=int(d.get("stride", 1)))
        return cls(spec=spec, tiles=tuple(d["tiles"]),
                   source=d.get("source", "cache"),
                   predicted_dram_accesses=d.get("predicted_dram_accesses"),
                   measured_us=d.get("measured_us"))
