"""Per-kernel roofline and energy profiler (the port of
``repro.obs.profile``; ``python -m repro_torch.profile``).

:class:`KernelProfiler` extends the DRAM ledger's scope attribution
(``obs.dram``) from model-predicted bytes to the kernels' own counts:
every tuned kernel exports ``hbm_bytes``, the global-memory bytes its
CUDA grid's loads and stores request, and :func:`kernel_hbm_bytes`
prices each observed resolution through the matching formula.  Per op
key it then derives:

* **dispatches** -- kernel calls that resolved the key inside a scope
  (eager attribution: real calls, ``obs.dram``);
* **bytes** -- ``hbm_bytes`` (requested) and ``min_bytes`` (each input
  read once, each output written once), per call times dispatches.  On
  Hopper the 50 MB L2 serves repeated reads, so requested bytes are not
  HBM transfers: ``hbm_bytes`` feeds the fidelity gate and the DRAM
  energy, ``min_bytes`` the roofline;
* **time** -- the scope's wall clock (the engines fence every scope
  when a tracer is attached), shared among the calls inside it in
  proportion to each call's least time on the card (below).  JAX shares
  by bytes (the memory-bound assumption); sharing by the least time
  gives every key of a scope the scope's roofline share, so a reading
  above 1 means a count or a time is wrong, never a skewed split.
  Per-launch device timing is a later step;
* **roofline** -- ``peak_frac = max(flops / peak, min_bytes /
  bandwidth) / time``, the bound of ``PERF.md``'s kernel table, on
  ``core.hopper_adapter.H100_SXM``: 989 TFLOP/s for bf16 specs (the
  tensor cores), 67 TFLOP/s for fp32 ones (the CUDA cores; TF32 would
  break the fp32 tolerances), 3.35 TB/s.  On the host-bound serving
  path the scope wall clock is mostly host time, so it reads low; on a
  CPU device every time-derived field is ``None`` (not measured);
* **energy** -- modeled with the paper's figures (``obs.energy``), not
  measured.

The **model-fidelity gate** compares the resolved tiles' requested
bytes with the analytic winner's: a schedule moving more than
``fidelity_threshold`` extra is appended to the miss log, where
``python -m repro_torch.tune --from-telemetry`` picks it up.
"""

from __future__ import annotations

import contextlib
import time

from repro_torch import tune
from repro_torch.core.hopper_adapter import H100_SXM, HopperTarget
from repro_torch.obs.dram import DramLedger, _Entry
from repro_torch.obs.energy import op_energy_pj
from repro_torch.tune.schedule import (CONV_OPS, NARROW_WEIGHT_BYTES,
                                       OpSpec, Schedule)

# NVIDIA's data sheet, H100 SXM: float32 outside the tensor cores
H100_FP32_FLOPS = 67e12


def _conv_input_hw(spec: OpSpec) -> tuple[int, int]:
    X, Y, _, _, Fw, Fh = spec.dims
    s = spec.stride
    return (Y - 1) * s + Fh, (X - 1) * s + Fw


def kernel_hbm_bytes(spec: OpSpec, tiles: tuple[int, ...]) -> int:
    """Bytes one call of the kernel serving ``spec`` at ``tiles``
    requests, from the kernel's own ``hbm_bytes``.  Ragged tiles count
    with ceilings (the kernels mask the edges and run; JAX returns
    ``None`` for them).  The decode keys price one (batch 1, kv head 1)
    call over ``S`` keys, the GEMM keys one call without epilogue
    operands beyond the int8 scale (the spec does not say which the
    caller passes)."""
    bpe = spec.itemsize
    op = spec.op
    if op in ("matmul", "matmul_fused", "matmul_fused_w8"):
        from repro_torch.kernels.matmul_fused import hbm_bytes
        return hbm_bytes(*spec.dims, *tiles, bytes_per_elem=bpe,
                         w_bytes=NARROW_WEIGHT_BYTES.get(op))
    if op == "matmul_w8":
        from repro_torch.kernels.matmul_q import hbm_bytes
        return hbm_bytes(*spec.dims, *tiles, a_bytes=bpe, w_bytes=1)
    if op == "matmul_dgrad":
        from repro_torch.kernels.matmul_bwd import hbm_bytes
        return hbm_bytes(*spec.dims, *tiles, bytes_per_elem=bpe)
    if op == "qkv_fused":
        from repro_torch.kernels.qkv_fused import hbm_bytes
        return hbm_bytes(*spec.dims, *tiles, bytes_per_elem=bpe)
    if op in ("flash_decode", "flash_decode_fp8"):
        from repro_torch.kernels.flash_decode import hbm_bytes
        G, S, D = spec.dims
        return hbm_bytes(1, 1, G, D, S, tiles[0], bytes_per_elem=bpe,
                         kv_bytes=NARROW_WEIGHT_BYTES.get(op))
    if op == "flash_decode_oproj":
        from repro_torch.kernels.flash_decode import oproj_hbm_bytes
        G, S, D, E = spec.dims
        return oproj_hbm_bytes(1, 1, G, D, E, S, tiles[0],
                               bytes_per_elem=bpe)
    X, Y, C, K, Fw, Fh = spec.dims
    h, w = _conv_input_hw(spec)
    if op == "conv2d_wgrad":
        from repro_torch.kernels.conv2d_bwd import hbm_bytes
    else:
        from repro_torch.kernels.conv2d_blocked import hbm_bytes
    return hbm_bytes(1, h, w, C, K, Fh, Fw, *tiles, itemsize=bpe,
                     stride=spec.stride)


def kernel_min_bytes(spec: OpSpec) -> int:
    """Bytes one call must move at the least: each input read once, each
    output written once, at the kernel's widths (the int8 weight and fp8
    pages at one byte, with their fp32 scales; the wgrad's fp32 dW)."""
    bpe = spec.itemsize
    op = spec.op
    if op in CONV_OPS:
        X, Y, C, K, Fw, Fh = spec.dims
        h, w = _conv_input_hw(spec)
        if op == "conv2d_wgrad":
            return (h * w * C + X * Y * K) * bpe + Fh * Fw * C * K * 4
        return (h * w * C + Fh * Fw * C * K + X * Y * K) * bpe
    if op == "qkv_fused":
        M, Nkv, K, G = spec.dims
        cols = (G + 2) * Nkv
        return (M * K + K * cols + M * cols) * bpe
    if op in ("flash_decode", "flash_decode_fp8", "flash_decode_oproj"):
        G, S, D = spec.dims[:3]
        kvb = NARROW_WEIGHT_BYTES.get(op, bpe)
        total = G * D * bpe + 2 * S * D * kvb
        if op == "flash_decode_fp8":
            total += 2 * 4
        if op == "flash_decode_oproj":
            E = spec.dims[3]
            return total + G * D * E * bpe + E * bpe
        return total + G * D * bpe
    M, N, K = spec.dims
    wb = NARROW_WEIGHT_BYTES.get(op)
    total = (M * K + M * N) * bpe + K * N * (wb or bpe)
    return total + (N * 4 if wb else 0)


def kernel_flops(spec: OpSpec) -> int:
    """Floating-point operations of one call: two per multiply-add of the
    spec's nest, and for decode attention both products (q . K and
    P . V, the nest counts one) plus row 3's projection."""
    flops = 2 * spec.problem().macs
    if spec.op in ("flash_decode", "flash_decode_fp8", "flash_decode_oproj"):
        G, S, D = spec.dims[:3]
        flops = 4 * G * S * D
        if spec.op == "flash_decode_oproj":
            flops += 2 * G * D * spec.dims[3]
    return flops


class KernelProfiler(DramLedger):
    """DRAM ledger + timed scopes + kernel byte counts + roofline/energy.

    Drop-in wherever a :class:`~repro_torch.obs.dram.DramLedger` goes
    (``Obs(dram=KernelProfiler(...))``): the engines' ``obs.dram.scope``
    brackets route here.  ``tracer`` (optional) receives per-step
    counter tracks (bytes, modeled energy); attach one to the same
    :class:`~repro_torch.obs.Obs` so the engines fence every scope and
    its wall clock includes the device's work.  ``device`` is where the
    kernels run: on ``"cpu"`` (the plain versions) no time is reported.
    """

    def __init__(self, registry=None, miss_log: str | None = None,
                 fidelity_threshold: float = 0.25,
                 target: HopperTarget = H100_SXM, tracer=None,
                 device: str = "cuda"):
        super().__init__(registry=registry, miss_log=miss_log)
        self.device = device
        self.fidelity_threshold = fidelity_threshold
        self.target = target
        self.tracer = tracer
        self._wall_s: dict[str, float] = {}       # tag -> total scope wall
        self._fid_flagged: set[str] = set()

    @property
    def timed(self) -> bool:
        return not self.device.startswith("cpu")

    # -- observation ----------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, tag: str):
        """Timed version of the ledger scope (same attribution)."""
        t0 = time.perf_counter()
        try:
            with super().scope(tag):
                yield self
        finally:
            self._wall_s[tag] = (self._wall_s.get(tag, 0.0)
                                 + time.perf_counter() - t0)

    def _first(self, spec: OpSpec, schedule: Schedule) -> _Entry:
        ent = super()._first(spec, schedule)
        ent.kernel_bytes = kernel_hbm_bytes(spec, schedule.tiles)
        ent.kernel_analytic_bytes = (
            ent.kernel_bytes if schedule.source == "analytic" else
            kernel_hbm_bytes(spec, tune.analytic_schedule(spec).tiles))
        ent.min_bytes = kernel_min_bytes(spec)
        ent.flops = kernel_flops(spec)
        ent.bound_s = max(ent.flops / self._peak_flops(spec),
                          ent.min_bytes / self.target.hbm_bytes_per_s)
        ent.energy = op_energy_pj(spec, schedule.tiles, ent.kernel_bytes)
        self._check_fidelity(ent, spec, schedule)
        return ent

    def _check_fidelity(self, ent: _Entry, spec: OpSpec,
                        schedule: Schedule) -> None:
        """Resolved-vs-analytic gate: tiles requesting more bytes than
        the analytic winner's by over the threshold go to the miss log
        for ``tune --from-telemetry`` (once per key)."""
        meas, model = ent.kernel_bytes, ent.kernel_analytic_bytes
        if ent.key in self._fid_flagged or not model:
            return
        if meas / model > 1.0 + self.fidelity_threshold:
            self._fid_flagged.add(ent.key)
            self._logged.add(ent.key)
            self._log_miss(spec, schedule)

    def end_step(self, rids=()) -> int:
        n = super().end_step(rids)
        if self.tracer is not None:
            self.tracer.counter("dram", {"bytes_per_step": n})
            self.tracer.counter(
                "energy", {"total_pj": round(self._total_energy_pj(), 1)})
        return n

    # -- aggregation ----------------------------------------------------------

    def _per_op_rollup(self) -> dict[str, dict]:
        """Dispatches, requested bytes and wall seconds per op key: each
        tag's wall time shared among its calls by their least time."""
        out = {key: {"dispatches": 0, "bytes": 0, "time_s": 0.0}
               for key in self._ops}
        for tag, counts in self._tag_ops.items():
            tag_bound = sum(self._ops[k].bound_s * n
                            for k, n in counts.items())
            wall = self._wall_s.get(tag, 0.0)
            for key, n in counts.items():
                ent = self._ops[key]
                roll = out[key]
                roll["dispatches"] += n
                roll["bytes"] += ent.kernel_bytes * n
                if tag_bound:
                    roll["time_s"] += wall * ent.bound_s * n / tag_bound
        return out

    def _total_energy_pj(self) -> float:
        total = 0.0
        for key, roll in self._per_op_rollup().items():
            e = self._ops[key].energy
            if e is not None:
                total += e["total_pj"] * roll["dispatches"]
        return total

    def _peak_flops(self, spec: OpSpec) -> float:
        return (self.target.peak_bf16_flops if spec.itemsize == 2
                else H100_FP32_FLOPS)

    def roofline_report(self) -> dict:
        """JSON-safe roofline + energy report, one row per dispatched
        key.  ``peak_frac`` is the least time the card could take for
        the row's work, ``max(flops / peak, min_bytes / bandwidth)``,
        over its attributed time; ``None`` where no time was measured."""
        t = self.target
        rows = {}
        totals = {"time_s": 0.0, "bytes": 0, "min_bytes": 0, "flops": 0,
                  "energy_pj": 0.0, "dispatches": 0}
        for key, roll in sorted(self._per_op_rollup().items()):
            ent = self._ops[key]
            n = roll["dispatches"]
            if not n:
                continue
            flops = ent.flops * n
            min_b = ent.min_bytes * n
            e = ent.energy
            energy_pj = e["total_pj"] * n if e is not None else None
            peak = self._peak_flops(ent.spec)
            bound_s = ent.bound_s * n
            secs = roll["time_s"] if self.timed else None
            row = {
                "tiles": list(ent.tiles),
                "source": ent.source,
                "dispatches": n,
                "time_us": secs * 1e6 if secs is not None else None,
                "hbm_bytes": roll["bytes"],
                "min_bytes": min_b,
                "flops": flops,
                "intensity_flops_per_byte": round(flops / min_b, 3),
                "peak_flops": peak,
                "bound_us": bound_s * 1e6,
                "fidelity_ratio": self._fidelity_ratio(ent),
                "energy_pj": (round(energy_pj, 1)
                              if energy_pj is not None else None),
                "energy_split": e,
                "achieved_gflops": None,
                "achieved_gbps": None,
                "peak_frac": None,
                "bound": None,
            }
            if secs:
                row["achieved_gflops"] = flops / secs / 1e9
                row["achieved_gbps"] = min_b / secs / 1e9
                row["peak_frac"] = bound_s / secs
                row["bound"] = ("compute" if flops / peak
                                > min_b / t.hbm_bytes_per_s else "memory")
            rows[key] = row
            totals["time_s"] += roll["time_s"]
            totals["bytes"] += roll["bytes"]
            totals["min_bytes"] += min_b
            totals["flops"] += flops
            totals["dispatches"] += n
            if energy_pj is not None:
                totals["energy_pj"] += energy_pj
        return {
            "target": {"name": t.name,
                       "peak_bf16_flops": t.peak_bf16_flops,
                       "peak_fp32_flops": H100_FP32_FLOPS,
                       "hbm_bytes_per_s": t.hbm_bytes_per_s},
            "device": self.device,
            "energy": "modeled with the paper's figures, not measured",
            "fidelity_threshold": self.fidelity_threshold,
            "fidelity_misses": sorted(self._fid_flagged),
            "per_op": rows,
            "totals": {
                "dispatches": totals["dispatches"],
                "time_us": (totals["time_s"] * 1e6
                            if self.timed else None),
                "hbm_bytes": totals["bytes"],
                "min_bytes": totals["min_bytes"],
                "flops": totals["flops"],
                "energy_uj": round(totals["energy_pj"] / 1e6, 3),
            },
        }

    @staticmethod
    def _fidelity_ratio(ent: _Entry) -> float | None:
        meas, model = ent.kernel_bytes, ent.kernel_analytic_bytes
        if not model:
            return None
        return round(meas / model, 4)

    def report(self) -> dict:
        out = super().report()
        out["roofline"] = self.roofline_report()
        return out

    def format_roofline(self) -> str:
        """Aligned-text roofline table through the one metrics formatter
        (fields that were not measured are left out)."""
        from repro_torch.obs.metrics import format_metrics
        rep = self.roofline_report()
        tree = {}
        for key, row in rep["per_op"].items():
            tree[key] = {
                k: v for k, v in row.items()
                if k not in ("tiles", "energy_split") and v is not None}
            tree[key]["tiles"] = "x".join(str(t) for t in row["tiles"])
        tree["TOTAL"] = {k: v for k, v in rep["totals"].items()
                         if v is not None}
        return format_metrics({"roofline": tree}, sections=["roofline"])
