"""The port's kernel profiler against the JAX package's
(``repro_torch.obs.profile`` vs ``repro.obs.profile``): each kernel's
byte count (``hbm_bytes``, the bytes its CUDA grid's loads and stores
request) against the blocking model's level-0 bytes or JAX's count,
with every difference in closed form; modeled energy; the roofline on a
CPU device (every time field ``None``); the fidelity gate with
``CorruptScheduleCache``; ``python -m repro_torch.profile``.

Byte counts are integers and compared exactly; energies (floats of the
same model arithmetic in both packages) to a relative 1e-12.
"""

import json
import time

import pytest
import torch

from repro.core.energy import DRAM_PJ_PER_16B as J_DRAM_PJ
from repro.kernels import conv2d_bwd as jconv_bwd
from repro.kernels import flash_attention as jfa
from repro.obs.energy import op_energy_pj as j_op_energy_pj
from repro.obs.profile import kernel_hbm_bytes as j_kernel_hbm_bytes
from repro.tune.schedule import OpSpec as JOpSpec
from repro_torch import tune
from repro_torch.chaos import CorruptScheduleCache
from repro_torch.core.energy import DRAM_PJ_PER_16B
from repro_torch.kernels import conv2d_bwd as CB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import matmul_fused as MF
from repro_torch.kernels import qkv_fused as QF
from repro_torch.kernels.matmul_bwd import mma_layout
from repro_torch.obs import KernelProfiler, MetricsRegistry, Obs, read_miss_log
from repro_torch.obs.energy import op_energy_pj
from repro_torch.obs.profile import (H100_FP32_FLOPS, kernel_flops,
                                     kernel_hbm_bytes, kernel_min_bytes)
from repro_torch.profile import main as profile_main
from repro_torch.tune import OpSpec, level0_dram_bytes
from repro_torch.tune.__main__ import main as tune_main
from repro_torch.tune.schedule import OPS


# ================ kernel byte counts vs the model's level 0 =================


@pytest.mark.parametrize("op,dims,dtype,tiles", [
    ("matmul", (256, 512, 256), "float32", (64, 128, 256)),
    ("matmul", (128, 256, 512), "bfloat16", (128, 64, 64)),
    ("matmul", (8, 4096, 4096), "bfloat16", (8, 256, 32)),
    ("matmul_fused", (256, 512, 256), "bfloat16", (64, 64, 128)),
    ("matmul_fused", (8, 12800, 4096), "bfloat16", (8, 128, 64)),
    ("matmul_dgrad", (512, 512, 512), "bfloat16", (128, 64, 128)),
    ("qkv_fused", (256, 128, 256, 2), "float32", (128, 64, 128)),
    ("flash_decode", (4, 2048, 64), "float32", (512,)),
    ("flash_decode_fp8", (4, 1024, 128), "float32", (256,)),
])
def test_kernel_bytes_equal_model_level0(op, dims, dtype, tiles):
    """Where the reduction takes more than one step, every CUDA block
    re-reads what the model's level-0 string re-reads: the counts agree
    exactly (the fp32 decode instance: one 4-row block a (b, kv head))."""
    spec = OpSpec(op, dims, dtype)
    assert kernel_hbm_bytes(spec, tiles) == level0_dram_bytes(spec, tiles)


@pytest.mark.parametrize("op", ["matmul", "matmul_fused"])
def test_single_step_reduction_rereads_a(op):
    """JAX's model elides A's re-reads when K is one step (its grid
    keeps the block); every CUDA column block reads its A rows: the
    difference is A once per extra column block."""
    M, N, K, tiles = 64, 256, 64, (64, 64, 64)
    spec = OpSpec(op, (M, N, K), "bfloat16")
    extra = M * K * 2 * (N // tiles[2] - 1)
    assert kernel_hbm_bytes(spec, tiles) - extra == \
        level0_dram_bytes(spec, tiles)


@pytest.mark.parametrize("op", ["matmul_w8", "matmul_fused_w8"])
def test_w8_kernel_bytes_exceed_model_by_the_scale_loads_only(op):
    """The int8 weight streams at one byte in both counts; the kernel's
    store loads the fp32 scale for every output element (JAX's: a row
    per row block), which the model's operand set does not hold."""
    M, N, K = 256, 512, 256
    spec = OpSpec(op, (M, N, K), "bfloat16")
    for tiles in [(64, 128, 128), (128, 64, 128), (32, 128, 64)]:
        assert kernel_hbm_bytes(spec, tiles) - M * N * 4 == \
            level0_dram_bytes(spec, tiles)


def test_matmul_fused_epilogue_loads_per_output_element():
    base = MF.hbm_bytes(64, 128, 256, 64, 64, 64)
    assert MF.hbm_bytes(64, 128, 256, 64, 64, 64, has_bias=True,
                        has_mul=True, has_residual=True) - base == \
        64 * 128 * (4 + 2 + 2)


def test_bf16_qkv_reads_x_once_per_segment_block():
    """bf16 runs the segment-major grid (each block one projection's bn
    columns): x is read ``blocks`` times where the model's joint tile
    reads it ``Nkv / bn`` times."""
    M, Nkv, K, G = 64, 128, 256, 4
    tiles = (64, 64, 32)
    spec = OpSpec("qkv_fused", (M, Nkv, K, G), "bfloat16")
    extra = M * K * 2 * (QF.blocks(Nkv, G, 32) - Nkv // 32)
    assert QF.blocks(Nkv, G, 32) == 4 * 4 + 2 * 4
    assert kernel_hbm_bytes(spec, tiles) - extra == \
        level0_dram_bytes(spec, tiles)


@pytest.mark.parametrize("op", ["flash_decode", "flash_decode_fp8"])
def test_bf16_decode_reads_q_once_per_split(op):
    """bf16 rows 1 and 2 split a row tile's pages over ``decode_grid``'s
    blocks, each staging the tile's q rows: the model reads q once."""
    G, S, D, page = 4, 1024, 128, 64
    spec = OpSpec(op, (G, S, D), "bfloat16")
    kvb = 1 if op == "flash_decode_fp8" else 2
    splits = FD.decode_grid(1, 1, G, page, S // page, D, kvb)[0]
    assert splits == 16
    extra = (splits - 1) * (G * D * 2 + (8 if kvb == 1 else 0))
    assert kernel_hbm_bytes(spec, (page,)) - extra == \
        level0_dram_bytes(spec, (page,))


def test_ragged_tiles_count_with_ceilings():
    """The kernels mask ragged edges and run: the counts are defined (JAX
    returns None) and reduce to the dividing count's formula."""
    spec = OpSpec("matmul", (100, 200, 300), "float32")
    assert j_kernel_hbm_bytes(
        JOpSpec("matmul", (100, 200, 300)), (64, 64, 64)) is None
    assert kernel_hbm_bytes(spec, (64, 64, 64)) == \
        (100 * 300 * 4 + 300 * 200 * 2 + 100 * 200) * 4
    assert FD.hbm_bytes(2, 2, 4, 32, 100, 32, 4) == \
        2 * 2 * (2 * 4 * 32 * 4 + 2 * 4 * 32 * 32 * 4)


@pytest.mark.parametrize("dtype,tiles", [("float32", (8, 8, 4, 8)),
                                         ("bfloat16", (4, 8, 8, 16))])
@pytest.mark.parametrize("op", ["conv2d", "conv2d_dgrad"])
def test_conv_bytes_equal_jax_count(op, dtype, tiles):
    """Row 12's count equals JAX's on dividing tiles with more than one
    channel block: the haloed windows lie inside the image (no
    clipping), input once per K block, weights once per spatial tile."""
    dims, stride = (16, 16, 16, 32, 3, 3), 2 if op == "conv2d" else 1
    spec = OpSpec(op, dims, dtype, stride)
    jspec = JOpSpec(op, dims, dtype, stride)
    assert kernel_hbm_bytes(spec, tiles) == j_kernel_hbm_bytes(jspec, tiles)


def test_wgrad_bytes_differ_from_jax_by_the_split_partials():
    """Row 13 on the card: the cotangent tile per C tile, and fp32
    partials (``splits_for`` of them, written and read back) before one
    dW; JAX's TPU kernel writes one dW partial per spatial tile."""
    X, Y, C, K, Fw, Fh, s = 16, 16, 16, 32, 3, 3, 1
    tiles = bx, by, bc, bk = (8, 8, 8, 16)
    spec = OpSpec("conv2d_wgrad", (X, Y, C, K, Fw, Fh), "bfloat16", s)
    theirs = jconv_bwd.hbm_bytes(X, Y, C, K, Fw, Fh, *tiles, 2, s)
    dw = Fh * Fw * C * K * 4
    splits = CB.splits_for((C // bc) * (K // bk), (X // bx) * (Y // by), 132)
    extra = (X * Y * K * 2 * (C // bc - 1)
             + (2 * splits + 1 - (X // bx) * (Y // by)) * dw)
    assert kernel_hbm_bytes(spec, tiles) - extra == theirs


def test_flash_attention_bytes_equal_jax_when_nothing_is_skipped():
    """Parity count (no tuned key reads it): without a causal limit
    every q block reads every key, as JAX counts; causal blocks skip the
    keys past their last row."""
    assert FA.hbm_bytes(256, 256, 64, 64, 64, 2) == \
        jfa.hbm_bytes(256, 256, 64, 64, 64, 2)
    assert FA.hbm_bytes(256, 256, 64, 64, 64, 2, with_lse=True) == \
        jfa.hbm_bytes(256, 256, 64, 64, 64, 2, with_lse=True)
    causal = FA.hbm_bytes(256, 256, 64, 64, 64, 2, causal=True)
    keys = 64 + 128 + 192 + 256
    assert causal == 2 * 256 * 64 * 2 + 2 * keys * 64 * 2


def _adapter_specs():
    """Every tuned key at granite-3-8b's shapes (and the conv keys at a
    Table-4 layer), bf16 and fp32."""
    dims = {"matmul": (8, 4096, 4096), "matmul_fused": (64, 12800, 4096),
            "matmul_fused_w8": (8, 12800, 4096),
            "matmul_w8": (64, 4096, 4096),
            "matmul_dgrad": (2048, 4096, 12800),
            "qkv_fused": (8, 1024, 4096, 4),
            "flash_decode": (4, 1024, 128), "flash_decode_fp8": (4, 1024, 128),
            "flash_decode_oproj": (4, 1024, 128, 4096),
            "conv2d": (28, 28, 64, 128, 3, 3),
            "conv2d_dgrad": (30, 30, 128, 64, 3, 3),
            "conv2d_wgrad": (28, 28, 64, 128, 3, 3)}
    assert set(dims) == set(OPS)
    return [OpSpec(op, d, dt) for op, d in dims.items()
            for dt in ("bfloat16", "float32")]


@pytest.mark.parametrize("spec", _adapter_specs(),
                         ids=lambda s: f"{s.op}-{s.dtype}")
def test_every_tuned_key_counts_at_its_adapter_tiles(spec):
    """Each key's count is defined at the tiles its adapter picks, at
    least the least bytes of the call; flops are positive."""
    tiles = tune.analytic_schedule(spec).tiles
    b = kernel_hbm_bytes(spec, tiles)
    assert isinstance(b, int) and b >= kernel_min_bytes(spec) > 0
    assert kernel_flops(spec) > 0


def test_min_bytes_and_flops_closed_forms():
    spec = OpSpec("matmul_w8", (8, 4096, 4096), "bfloat16")
    assert kernel_min_bytes(spec) == \
        (8 * 4096 * 2) * 2 + 4096 * 4096 + 4096 * 4
    assert kernel_flops(spec) == 2 * 8 * 4096 * 4096
    dec = OpSpec("flash_decode_oproj", (4, 512, 128, 4096), "bfloat16")
    assert kernel_flops(dec) == 4 * 4 * 512 * 128 + 2 * 4 * 128 * 4096
    assert kernel_min_bytes(dec) == (4 * 128 * 2 + 2 * 512 * 128 * 2
                                     + 4 * 128 * 4096 * 2 + 4096 * 2)


# ============================== energy ======================================


def test_op_energy_pj_equals_jax():
    """Both packages price the same blocking string with the paper's
    figures: equal splits at the same byte count."""
    assert DRAM_PJ_PER_16B == J_DRAM_PJ
    for op, dims, tiles in [("matmul", (256, 256, 256), (128, 128, 128)),
                            ("flash_decode", (4, 512, 64), (64,))]:
        spec, jspec = OpSpec(op, dims, "bfloat16"), JOpSpec(op, dims,
                                                             "bfloat16")
        b = kernel_hbm_bytes(spec, tiles)
        got, want = op_energy_pj(spec, tiles, b), j_op_energy_pj(
            jspec, tiles, b)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert op_energy_pj(OpSpec("matmul", (128, 128, 128)), (96, 64, 64),
                        1000) is None


# ============================== roofline ====================================


def test_profiler_on_a_cpu_device_reports_no_time():
    prof = KernelProfiler(registry=MetricsRegistry(), device="cpu")
    for _ in range(2):
        with prof.scope("gemm[64]"):
            tune.best_schedule("matmul", (64, 64, 64))
            tune.best_schedule("matmul", (64, 64, 64))
    prof.end_step([0])
    rep = prof.roofline_report()
    (key,) = rep["per_op"]
    row = rep["per_op"][key]
    spec = OpSpec("matmul", (64, 64, 64))
    assert row["dispatches"] == 4                 # every call, eagerly
    assert row["hbm_bytes"] == 4 * kernel_hbm_bytes(spec, tuple(row["tiles"]))
    assert row["min_bytes"] == 4 * kernel_min_bytes(spec)
    assert row["flops"] == 4 * 2 * 64 ** 3
    assert row["peak_flops"] == H100_FP32_FLOPS
    for k in ("time_us", "achieved_gflops", "achieved_gbps", "peak_frac",
              "bound"):
        assert row[k] is None
    assert rep["totals"]["time_us"] is None
    assert row["fidelity_ratio"] == 1.0 and row["energy_pj"] > 0
    json.dumps(prof.report())
    text = prof.format_roofline()
    assert key in text and "TOTAL" in text and "peak_frac" not in text


def test_profiler_roofline_share_on_a_timed_device():
    """``peak_frac = max(flops / peak, min_bytes / bandwidth) / time``,
    each key's time its share of the scope's wall clock by its calls'
    least time: every key of one scope reads the scope's share, under 1
    for a scope that took longer than the card's least time."""
    prof = KernelProfiler(device="cuda")
    with prof.scope("decode[1]"):
        tune.best_schedule("matmul", (8, 4096, 4096), "bfloat16")
        tune.best_schedule("qkv_fused", (8, 1024, 4096, 4), "bfloat16")
        tune.best_schedule("qkv_fused", (8, 1024, 4096, 4), "bfloat16")
        time.sleep(0.01)
    rep = prof.roofline_report()
    rows = rep["per_op"].values()
    total = sum(r["time_us"] for r in rows)
    assert total == pytest.approx(rep["totals"]["time_us"], rel=1e-9)
    assert total >= 1e4
    share = sum(r["bound_us"] for r in rows) / total
    for row in rows:
        assert row["bound"] == "memory"            # decode GEMMs
        assert row["bound_us"] == pytest.approx(
            row["min_bytes"] / 3.35e12 * 1e6, rel=1e-12)
        assert row["peak_frac"] == pytest.approx(share, rel=1e-9)
        assert row["peak_frac"] == pytest.approx(
            row["bound_us"] / row["time_us"], rel=1e-12)
        assert 0 < row["peak_frac"] < 1
        assert row["peak_flops"] == 989e12
        assert row["achieved_gbps"] == pytest.approx(
            row["min_bytes"] / row["time_us"] / 1e3, rel=1e-12)


# ======================== the fidelity gate =================================


def test_corrupt_cache_tiles_run_and_move_more_bytes():
    """The corrupt tiles pass the key's own checks (so ``best_schedule``
    serves them and the kernel's wrapper takes them), and request more
    bytes: a bf16 prefill GEMM on the tensor-core instance, an fp32 one
    on the tile core; a decode tile with no such variant is left alone."""
    cache = CorruptScheduleCache("matmul")
    prev = tune.set_default_cache(cache)
    try:
        for dims, dtype in (((128, 4096, 4096), "bfloat16"),
                            ((64, 1024, 256), "float32")):
            spec = OpSpec("matmul", dims, dtype)
            s = tune.best_schedule("matmul", dims, dtype)
            top = tune.analytic_schedule(spec)
            assert s.source == "cache" and s.tiles != top.tiles
            assert kernel_hbm_bytes(spec, s.tiles) > \
                1.25 * kernel_hbm_bytes(spec, top.tiles)
            MF.check_tiles(getattr(torch, dtype), dims[0], s.tiles, False,
                           232_448)
            if dtype == "bfloat16":
                assert mma_layout(s.tiles[0], s.tiles[2]) is not None
        assert tune.best_schedule("matmul", (16, 256, 256),
                                  "bfloat16").source == "analytic"
        assert cache.lookup(OpSpec("qkv_fused", (8, 64, 64, 2))) is None
    finally:
        assert tune.set_default_cache(prev) is cache
    assert tune.best_schedule("matmul", (128, 4096, 4096),
                              "bfloat16").source == "analytic"


def test_fidelity_gate_routes_corrupt_schedule_to_miss_log(tmp_path,
                                                            capsys):
    miss = tmp_path / "miss.jsonl"
    prof = KernelProfiler(miss_log=str(miss), device="cpu")
    spec = OpSpec("matmul", (64, 1024, 256))
    bad = CorruptScheduleCache("matmul").lookup(spec)
    with prof.scope("prefill[64]"):
        prof.record(spec, bad)
        prof.record(spec, bad)                  # flagged once
    rep = prof.roofline_report()
    (key,) = rep["fidelity_misses"]
    assert key == "matmul/m64n1024k256/float32/cpu"
    assert rep["per_op"][key]["fidelity_ratio"] > 1.25
    prof.close()
    (line,) = [json.loads(x) for x in miss.read_text().splitlines()]
    assert line["source"] == "cache"
    assert tuple(line["fallback_tiles"]) == bad.tiles
    assert read_miss_log(str(miss)) == [
        {"op": "matmul", "dims": [64, 1024, 256], "dtype": "float32",
         "stride": 1}]
    tune_main(["--from-telemetry", str(miss), "--dry-run"])
    assert "would tune matmul/m64n1024k256/" in capsys.readouterr().out


def test_fidelity_gate_quiet_on_analytic_resolutions(tmp_path):
    miss = tmp_path / "miss.jsonl"
    prof = KernelProfiler(miss_log=str(miss), fidelity_threshold=0.05,
                          device="cpu")
    with prof.scope("gemm"):
        tune.best_schedule("matmul", (64, 64, 64))
    assert prof.roofline_report()["fidelity_misses"] == []
    prof.close()
    assert len(miss.read_text().splitlines()) == 1     # the plain miss


def test_set_default_cache_clears_the_memo():
    spec = OpSpec("matmul", (32, 32, 32))
    tune.analytic_schedule(spec)
    assert tune._derive.cache_info().currsize > 0
    prev = tune.set_default_cache(tune.ScheduleCache("/nonexistent/x.json"))
    assert tune._derive.cache_info().currsize == 0
    tune.set_default_cache(prev)


# =============================== the CLI ====================================


def test_profile_cli_smoke_on_cpu(tmp_path, capsys):
    out_json, met = tmp_path / "r.json", tmp_path / "m.json"
    profile_main(["--smoke", "--device", "cpu", "--json", str(out_json),
                  "--trace", str(tmp_path / "t.json"), "--metrics-out",
                  str(met)])
    text = capsys.readouterr().out
    assert "not measured" in text and "card:" not in text
    rep = json.loads(out_json.read_text())
    assert rep["device"] == "cpu" and rep["totals"]["time_us"] is None
    ops = {k.split("/")[0] for k in rep["per_op"]}
    assert {"qkv_fused", "matmul_fused", "flash_decode_oproj"} <= ops
    for row in rep["per_op"].values():
        assert row["peak_frac"] is None and row["time_us"] is None
        assert row["hbm_bytes"] >= row["min_bytes"] > 0
        assert row["dispatches"] > 0
    assert json.loads(met.read_text())["dram"]["roofline"] == rep
    names = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())}
    assert {"step", "dispatch.decode"} <= names


def test_profile_cli_corrupt_blocked_path_feeds_the_tuner(tmp_path, capsys,
                                                          monkeypatch):
    """``--corrupt matmul`` on the blocked-GEMM path: the gate writes the
    prefill GEMMs (M = 16 bucket rows x 4 ... > 16: the corruptible
    ones) to the miss log, and the tuner lists them."""
    monkeypatch.setenv("REPRO_BLOCKED_LINEAR", "1")
    miss = tmp_path / "miss.jsonl"
    profile_main(["--device", "cpu", "--no-fuse", "--requests", "2",
                  "--gen", "2", "--prompt-len", "48", "--max-seq", "64",
                  "--corrupt", "matmul", "--miss-log", str(miss)])
    assert "fidelity gate" in capsys.readouterr().out
    targets = read_miss_log(str(miss))
    gemms = [t for t in targets if t["op"] == "matmul"]
    assert gemms and all(t["dims"][0] == 64 for t in gemms)
    tune_main(["--from-telemetry", str(miss), "--dry-run"])
    out = capsys.readouterr().out
    assert f"{len(targets)} distinct miss target(s)" in out
    assert "would tune matmul/m64n" in out
    assert tune.best_schedule("matmul", (64, 64, 64)).source == "analytic"


def test_train_with_profiler_rows_for_both_gemm_keys(tmp_path):
    """Blocked training under a profiler on the CPU: the ``train_step``
    scope's forward and dgrad GEMM keys, each with bytes and no time;
    checkpoint spans at the configured steps."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.obs import StepTracer
    from repro_torch.train import loop
    cfg = dataclasses.replace(get_reduced("granite-3-8b"),
                              dtype=torch.float32)
    prof = KernelProfiler(device="cpu")
    obs = Obs(trace=StepTracer(tmp_path / "t.json"), dram=prof)
    tc = loop.TrainConfig(blocked_linear=True, ckpt_dir=str(tmp_path / "c"),
                          ckpt_every=1)
    batches = (make_batch(cfg, 8, 2, s, device="cpu") for s in range(2))
    loop.train(cfg, tc, batches, device="cpu", log=lambda *_: None, obs=obs)
    obs.close()
    rep = prof.roofline_report()
    ops = {k.split("/")[0] for k in rep["per_op"]}
    assert ops == {"matmul", "matmul_dgrad"}
    assert all(r["time_us"] is None and r["hbm_bytes"] > 0
               for r in rep["per_op"].values())
    ev = json.loads((tmp_path / "t.json").read_text())
    assert [e["args"]["step"] for e in ev if e["name"] == "checkpoint"] == \
        [1, 2]
