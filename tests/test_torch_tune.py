"""The port's schedule tuner: the model's arithmetic against JAX, and the
cache and ``best_schedule`` semantics of ``tests/test_tune.py``.

``schedule_to_string``, ``predicted_dram_accesses`` and
``level0_dram_bytes`` have no target, so for the same spec, tiles and
budget they must equal the JAX package's exactly.  Every test that
writes a cache writes under ``tmp_path``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.tune import OpSpec as JOpSpec
from repro.tune import lowering as jlowering
from repro_torch.core.hopper_adapter import (H100_SXM, decode_smem_limit,
                                             default_smem_budget)
from repro_torch.tune import (OpSpec, Schedule, ScheduleCache, best_schedule,
                              candidates, device_kind, divides, fits_smem,
                              level0_dram_bytes, predicted_dram_accesses,
                              predicted_dram_bytes, schedule_to_string,
                              set_schedule_observer, tune_op)
from repro_torch.tune.cache import default_cache_path

ROOT = Path(__file__).resolve().parents[1]
BUDGET = default_smem_budget()
SPECS = [("matmul", (8, 4096, 4096), "bfloat16", (8, 256, 64)),
         ("matmul", (512, 1024, 4096), "bfloat16", (128, 64, 128)),
         ("matmul", (64, 256, 512), "float32", (16, 128, 64)),
         ("flash_decode", (4, 512, 128), "bfloat16", (32,)),
         ("flash_decode", (4, 512, 128), "float32", (64,)),
         ("flash_decode", (2, 64, 16), "float32", (8,))]


@pytest.mark.parametrize("op,dims,dtype,tiles", SPECS)
def test_model_arithmetic_matches_jax(op, dims, dtype, tiles):
    spec, jspec = OpSpec(op, dims, dtype), JOpSpec(op, dims, dtype)
    assert repr(schedule_to_string(spec, tiles)) == \
        repr(jlowering.schedule_to_string(jspec, tiles))
    assert predicted_dram_accesses(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_accesses(jspec, tiles, BUDGET)
    assert level0_dram_bytes(spec, tiles) == \
        jlowering.level0_dram_bytes(jspec, tiles)
    assert spec.key("cpu") == jspec.key("cpu")
    assert spec.itemsize == jspec.itemsize


FUSED_SPECS = [("matmul_fused", (8, 12800, 4096), "bfloat16", (8, 256, 64)),
               ("matmul_fused", (64, 4096, 12800), "float32",
                (16, 64, 128)),
               ("qkv_fused", (8, 1024, 4096, 4), "bfloat16", (8, 64, 64)),
               ("qkv_fused", (64, 32, 64, 2), "float32", (16, 64, 32)),
               ("flash_decode_oproj", (4, 512, 128, 4096), "bfloat16",
                (32,)),
               ("flash_decode_oproj", (2, 64, 16, 64), "float32", (8,))]


@pytest.mark.parametrize("op,dims,dtype,tiles", FUSED_SPECS)
def test_fused_keys_model_arithmetic_matches_jax(op, dims, dtype, tiles):
    """The fused keys' nests, access counts and byte-weighted traffic
    (the rank they sort by) equal JAX's for the same spec, tiles and
    explicit budget in bytes; ``level0_dram_bytes`` covers the same keys
    in both (not the oproj nest)."""
    spec, jspec = OpSpec(op, dims, dtype), JOpSpec(op, dims, dtype)
    assert repr(schedule_to_string(spec, tiles)) == \
        repr(jlowering.schedule_to_string(jspec, tiles))
    assert predicted_dram_accesses(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_accesses(jspec, tiles, BUDGET)
    assert predicted_dram_bytes(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_bytes(jspec, tiles, BUDGET)
    if op == "flash_decode_oproj":
        for fn, sp in ((level0_dram_bytes, spec),
                       (jlowering.level0_dram_bytes, jspec)):
            with pytest.raises(ValueError):
                fn(sp, tiles)
    else:
        assert level0_dram_bytes(spec, tiles) == \
            jlowering.level0_dram_bytes(jspec, tiles)
    assert spec.key("cpu") == jspec.key("cpu")


@pytest.mark.parametrize("op,dims,dtype", [
    ("matmul_fused", (8, 12800, 4096), "bfloat16"),
    ("matmul_fused", (512, 4096, 12800), "bfloat16"),
    ("qkv_fused", (8, 1024, 4096, 4), "bfloat16"),
    ("qkv_fused", (512, 1024, 4096, 4), "float32"),
    ("qkv_fused", (64, 32, 64, 2), "float32"),
    ("flash_decode_oproj", (4, 512, 128, 4096), "bfloat16"),
    ("flash_decode_oproj", (4, 512, 128, 4096), "float32")])
def test_fused_candidates_fit_the_cuda_kernels(op, dims, dtype):
    """Every candidate of the three keys fits its CUDA kernel's own
    shared-memory footprint within the budget and, for the GEMMs, the
    accumulator cap -- for qkv_fused in fp32 the tile core's at the joint
    width, which at G = 4 caps the per-projection bn at 128; for
    matmul_fused, and qkv_fused in bf16, the instance's for the spec's M
    (the tensor cores; at decode within the opt-in where the column
    blocks are one wave)."""
    from repro_torch.kernels import matmul_blocked as MB
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import qkv_fused as QF
    from repro_torch.kernels.flash_decode import oproj_smem_bytes_required
    spec = OpSpec(op, dims, dtype)
    cands = candidates(spec)
    assert cands
    for s in cands:
        assert fits_smem(spec, s.tiles, BUDGET)
        if op == "flash_decode_oproj":
            G, S, D, _ = dims
            (page,) = s.tiles
            assert S % page == 0
            assert oproj_smem_bytes_required(page, G, D,
                                             spec.itemsize) <= BUDGET
            continue
        bm, bk, bn = s.tiles
        if op == "qkv_fused":
            m, nkv, _, G = dims
            limit = BUDGET
            if spec.itemsize == 2 and m <= 16:   # one wave may opt in
                limit = decode_smem_limit(None, bn, BUDGET,
                                          blocks=QF.blocks(nkv, G, bn))
            assert QF.smem_bytes_required(bm, bk, bn, G, spec.itemsize,
                                          m=m) <= limit
            assert QF.accumulators_per_thread(bm, bn, G, spec.itemsize,
                                              m=m) <= H100_SXM.acc_per_thread
            if G == 4 and spec.itemsize == 4:
                assert bn <= 128 and bn % H100_SXM.nk_mult == 0
        else:
            m = dims[0]
            assert MF.smem_bytes_required(bm, bk, bn, spec.itemsize,
                                          m=m) <= BUDGET
            assert MF.accumulators_per_thread(bm, bn, spec.itemsize,
                                              m=m) <= H100_SXM.acc_per_thread
            if spec.itemsize == 4:
                assert MB.accumulators_per_thread(bm, bn) <= \
                    H100_SXM.acc_per_thread
    assert not fits_smem(OpSpec("qkv_fused", (8, 1024, 4096, 4)),
                         (8, 64, 256), 10 ** 9)     # 1536 joint columns


def test_matmul_fused_ranks_the_matmul_candidates_by_bytes():
    """In fp32 the fused GEMM runs the blocked GEMM's tile core, so its
    candidates are the "matmul" ones, ranked by predicted bytes (bf16
    runs the tensor-core instances under their own footprint)."""
    dims = (64, 4096, 4096)
    fused = candidates(OpSpec("matmul_fused", dims, "float32"))
    plain = candidates(OpSpec("matmul", dims, "float32"))
    assert {s.tiles for s in fused} == {s.tiles for s in plain}
    nbytes = [predicted_dram_bytes(s.spec, s.tiles) for s in fused]
    assert nbytes == sorted(nbytes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_page_is_a_whole_page_divisor_that_fits(dtype):
    """``choose_page_size(cfg, 512, fused=True)``: a divisor of max_seq
    whose oproj footprint fits the budget the adapter sized it under."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import oproj_smem_bytes_required
    from repro_torch.serve.kv_cache import choose_page_size
    cfg = dataclasses.replace(get_config("granite-3-8b"), dtype=dtype)
    page = choose_page_size(cfg, 512, fused=True)
    g = cfg.n_heads // cfg.n_kv_heads
    assert 512 % page == 0
    assert oproj_smem_bytes_required(page, g, cfg.head_dim,
                                     dtype.itemsize) <= BUDGET
    assert page == best_schedule(
        "flash_decode_oproj", (g, 512, cfg.head_dim, cfg.d_model),
        str(dtype).removeprefix("torch.")).tiles[0]


# -- cache -----------------------------------------------------------------


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "schedules.json")
    spec = OpSpec("matmul", (256, 256, 512), "bfloat16")
    sched = Schedule(spec, (64, 128, 128), source="measured",
                     predicted_dram_accesses=12345, measured_us=6.5)
    cache = ScheduleCache(path)
    assert cache.lookup(spec, device="cpu") is None
    key = cache.store(sched, device="cpu")
    assert key == "matmul/m256n256k512/bfloat16/cpu"
    got = ScheduleCache(path).lookup(spec, device="cpu")   # a new process
    assert got.spec == spec and got.tiles == (64, 128, 128)
    assert got.source == "cache"        # disk hits are tagged as such
    assert got.predicted_dram_accesses == 12345 and got.measured_us == 6.5


def test_cache_is_device_keyed_and_merges(tmp_path):
    path = str(tmp_path / "schedules.json")
    spec = OpSpec("matmul", (64, 64, 64))
    card = "NVIDIA H100 80GB HBM3"
    ScheduleCache(path).store(Schedule(spec, (64, 64, 64),
                                       source="measured"), device="cpu")
    ScheduleCache(path).store(Schedule(spec, (16, 64, 64)), device=card)
    cache = ScheduleCache(path)
    assert cache.lookup(spec, device="cpu").tiles == (64, 64, 64)
    assert cache.lookup(spec, device=card).tiles == (16, 64, 64)
    assert len(cache.keys()) == 2
    entries = json.loads((tmp_path / "schedules.json").read_text())
    assert entries["schedules"]["matmul/m64n64k64/float32/cpu"]["source"] \
        == "measured"


def test_device_kind_and_default_path_are_the_ports_own(monkeypatch):
    assert device_kind() == (torch.cuda.get_device_name()
                             if torch.cuda.is_available() else "cpu")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "/x/s.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/jax/s.json")
    assert default_cache_path() == "/x/s.json"
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "schedules.json"))


def test_cache_quarantines_corrupt_file(tmp_path):
    path = tmp_path / "schedules.json"
    spec = OpSpec("flash_decode", (4, 64, 128))
    path.write_text("{truncated by a crashed writ")
    with pytest.warns(UserWarning, match="quarantin"):
        assert ScheduleCache(str(path)).lookup(spec, device="cpu") is None
    assert (tmp_path / "schedules.json.corrupt").read_text() == \
        "{truncated by a crashed writ"
    assert not path.exists()
    cache = ScheduleCache(str(path))
    cache.store(Schedule(spec, (32,)), device="cpu")
    assert ScheduleCache(str(path)).lookup(spec, device="cpu") is not None
    path2 = tmp_path / "other.json"
    path2.write_text("[1, 2, 3]")
    with pytest.warns(UserWarning, match="quarantin"):
        assert ScheduleCache(str(path2)).lookup(spec, device="cpu") is None
    # a missing file is a cold start, not corruption: no warning
    ScheduleCache(str(tmp_path / "absent.json")).lookup(spec, device="cpu")


def test_cache_skips_entries_of_unported_keys(tmp_path):
    """Every key of the reference is ported now: a conv entry (with its
    stride) round-trips; an entry of a key neither package has, or one
    with a malformed tile tuple, is skipped and the rest kept."""
    path = tmp_path / "schedules.json"
    good = Schedule(OpSpec("matmul", (8, 64, 64)), (8, 64, 64))
    conv = Schedule(OpSpec("conv2d", (8, 8, 4, 8, 3, 3), stride=2),
                    (8, 8, 4, 8))
    path.write_text(json.dumps({"version": 1, "schedules": {
        "conv2d/x8y8c4k8f3x3s1/float32/cpu": {
            "op": "conv2d", "dims": [8, 8, 4, 8, 3, 3], "tiles": [8, 8, 4, 8]},
        "conv2d/x8y8c4k8f3x3s2/float32/cpu": conv.to_json(),
        "conv2d_wgrad/x8y8c4k8f3x3s1/float32/cpu": {
            "op": "conv2d_wgrad", "dims": [8, 8, 4, 8, 3, 3],
            "tiles": [8, 8]},
        "relu/x8/float32/cpu": {"op": "relu", "dims": [8], "tiles": [8]},
        "matmul/m8n64k64/float32/cpu": good.to_json()}}))
    cache = ScheduleCache(str(path))
    assert cache.keys() == ["conv2d/x8y8c4k8f3x3s1/float32/cpu",
                            "conv2d/x8y8c4k8f3x3s2/float32/cpu",
                            "matmul/m8n64k64/float32/cpu"]
    hit = cache.lookup(conv.spec, device="cpu")
    assert hit.tiles == (8, 8, 4, 8) and hit.spec.stride == 2
    assert cache.lookup(OpSpec("conv2d", (8, 8, 4, 8, 3, 3)),
                        device="cpu").spec.stride == 1


# -- lowering --------------------------------------------------------------


@pytest.mark.parametrize("op,dims,dtype", [
    ("matmul", (64, 256, 512), "bfloat16"),
    ("matmul", (8, 1024, 4096), "float32"),
    ("flash_decode", (4, 512, 128), "bfloat16")])
def test_candidates_divide_fit_and_rank(op, dims, dtype):
    spec = OpSpec(op, dims, dtype)
    cands = candidates(spec)
    assert cands
    for s in cands:
        assert divides(spec, s.tiles) and fits_smem(spec, s.tiles, BUDGET)
    accesses = [s.predicted_dram_accesses for s in cands]
    assert None not in accesses and accesses == sorted(accesses)


def test_ragged_problem_keeps_a_runnable_schedule():
    """M = 257 divides by no 16-row tile: the top fitting tile comes back
    unscored, and the kernel runs it with its edges masked."""
    s = candidates(OpSpec("matmul", (257, 256, 512)))[0]
    assert not divides(s.spec, s.tiles)
    assert s.predicted_dram_accesses is None
    assert fits_smem(s.spec, s.tiles, BUDGET)


def test_predicted_accesses_reject_non_dividing_tiles():
    with pytest.raises(ValueError, match="do not divide"):
        predicted_dram_accesses(OpSpec("matmul", (256, 256, 512)),
                                (96, 128, 128))


# -- best_schedule and tune_op ---------------------------------------------


def test_best_schedule_fallback_is_analytic(tmp_path):
    cache = ScheduleCache(str(tmp_path / "empty.json"))
    s = best_schedule("matmul", (128, 128, 128), "float32", cache=cache)
    assert s.source == "analytic" and divides(s.spec, s.tiles)


def test_best_schedule_prefers_cache_and_tells_the_observer(tmp_path):
    cache = ScheduleCache(str(tmp_path / "schedules.json"))
    spec = OpSpec("matmul", (128, 128, 128), "float32")
    cache.store(Schedule(spec, (16, 128, 128), source="measured"))
    seen = []
    prev = set_schedule_observer(lambda sp, sc: seen.append((sp, sc)))
    try:
        s = best_schedule("matmul", (128, 128, 128), "float32", cache=cache)
    finally:
        set_schedule_observer(prev)
    assert s.tiles == (16, 128, 128) and s.source == "cache"
    assert seen == [(spec, s)]


def test_best_schedule_rederives_when_cached_tiles_blow_budget(tmp_path):
    cache = ScheduleCache(str(tmp_path / "schedules.json"))
    spec = OpSpec("matmul", (512, 512, 512), "bfloat16")
    cache.store(Schedule(spec, (128, 512, 128), source="measured"))
    small = 32 * 1024
    s = best_schedule("matmul", (512, 512, 512), "bfloat16", cache=cache,
                      smem_budget_bytes=small)
    assert s.source == "analytic" and fits_smem(spec, s.tiles, small)


def test_best_schedule_refuses_a_cached_conv_tile_its_kernel_cannot_hold(
        tmp_path):
    """A conv tile cached under another footprint is refused and searched
    again: Conv1's (16, 16, 4, 32) stages 121 taps of 4 channels x 32
    columns on CUDA cores (83,584 B in two stages), but row 12's bf16
    instance rounds every tap up to a whole 8-channel chunk: 976 weight
    rows, 146,560 B of weights and input."""
    from repro_torch.kernels import conv2d_blocked as CB
    cache = ScheduleCache(str(tmp_path / "schedules.json"))
    dims = (256, 256, 256, 384, 11, 11)
    spec = OpSpec("conv2d", dims, "bfloat16")
    stale = (16, 16, 4, 32)
    assert 2 * (26 * 26 * 8 + 121 * 4 * 32) * 2 == 83_584 <= BUDGET
    assert CB.smem_bytes_required(*stale, 11, 11, 2) == \
        2 * (26 * 26 * 8 + 976 * 32) * 2 + 122 * 4 == 147_048
    assert not fits_smem(spec, stale, BUDGET)
    cache.store(Schedule(spec, stale, source="measured"))
    s = best_schedule("conv2d", dims, "bfloat16", cache=cache)
    assert s.source == "analytic" and s.tiles != stale
    assert fits_smem(spec, s.tiles, BUDGET)
    # a cached tile that fits is taken as it is
    cache.store(Schedule(spec, s.tiles, source="measured"))
    assert best_schedule("conv2d", dims, "bfloat16",
                         cache=cache).source == "cache"


@pytest.mark.parametrize("dims,stale", [
    ((8, 4096, 4096), (8, 256, 64)),      # the tile core's decode tile
    ((8, 4096, 12800), (8, 64, 256)),     # bn 256: not a transposed bn
    ((512, 4096, 4096), (256, 64, 256)),  # no warp grid holds 256 x 256
])
def test_best_schedule_refuses_a_stale_bf16_matmul_tile(tmp_path, dims,
                                                        stale):
    """Row 6 runs row 9's tensor-core instances in bf16, so a ``"matmul"``
    tile cached for the CUDA-core tile core is checked against the
    instance and searched again where the instance does not hold it (a
    decode bn outside ``MMA_T_COLS``, a tile off the warp grid); one it
    holds is taken as it is, and fp32 keeps the tile core's."""
    cache = ScheduleCache(str(tmp_path / "schedules.json"))
    spec = OpSpec("matmul", dims, "bfloat16")
    cache.store(Schedule(spec, stale, source="measured"))
    s = best_schedule("matmul", dims, "bfloat16", cache=cache)
    if fits_smem(spec, stale, BUDGET):
        assert s.source == "cache" and s.tiles == stale
    else:
        assert s.source == "analytic" and fits_smem(spec, s.tiles, BUDGET)
    assert not fits_smem(spec, (8, 64, 256) if dims[0] == 8
                         else (256, 64, 256), BUDGET)
    fspec = OpSpec("matmul", dims, "float32")
    cache.store(Schedule(fspec, (16, 64, 64), source="measured"))
    assert best_schedule("matmul", dims, "float32",
                         cache=cache).source == "cache"


def test_best_schedule_ignores_other_dtypes(tmp_path):
    cache = ScheduleCache(str(tmp_path / "schedules.json"))
    cache.store(Schedule(OpSpec("matmul", (128, 128, 128), "bfloat16"),
                         (16, 128, 128), source="measured"))
    s = best_schedule("matmul", (128, 128, 128), "float32", cache=cache)
    assert s.source == "analytic"


def test_tune_op_persists_the_analytic_winner_and_measures_only_on_a_card(
        tmp_path):
    cache = ScheduleCache(str(tmp_path / "schedules.json"))
    w = tune_op("flash_decode", (4, 512, 128), "bfloat16", measure=False,
                cache=cache)
    assert ScheduleCache(cache.path).lookup(w.spec).tiles == w.tiles
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tune_op("matmul", (8, 64, 64), measure=True, cache=cache)


def test_opspec_validation():
    with pytest.raises(ValueError):
        OpSpec("matmul", (1, 2))
    with pytest.raises(ValueError):
        OpSpec("relu", (1, 2, 3))
    with pytest.raises(ValueError):
        Schedule(OpSpec("matmul", (8, 8, 8)), (8, 8))
    for op in ("conv2d", "conv2d_dgrad", "conv2d_wgrad"):
        spec = OpSpec(op, (8, 8, 4, 8, 3, 3), stride=2)
        assert spec.problem().stride == 2
        assert Schedule.from_json(Schedule(spec, (4, 4, 4, 8)).to_json()) \
            .spec == spec
        with pytest.raises(ValueError):
            OpSpec(op, (8, 8, 8))
        with pytest.raises(ValueError):
            OpSpec(op, (8, 8, 4, 8, 3, 3), stride=0)
        with pytest.raises(ValueError):
            Schedule(spec, (4, 4, 4))


@pytest.mark.parametrize("op,dims,key", [
    ("qkv_fused", ["8", "1024", "4096", "4"],
     "qkv_fused/m8n1024k4096g4/bfloat16/cpu"),
    ("flash_decode_oproj", ["4", "512", "128", "4096"],
     "flash_decode_oproj/g4s512d128e4096/bfloat16/cpu"),
    ("matmul_fused", ["8", "256", "512"],
     "matmul_fused/m8n256k512/bfloat16/cpu")])
def test_cli_takes_the_fused_keys(tmp_path, op, dims, key):
    path = tmp_path / "s.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_TUNE_CACHE": str(path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", op, *dims, "--dtype",
         "bfloat16", "--no-measure"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "winner: tiles=" in res.stdout
    assert key in json.loads(path.read_text())["schedules"]


def test_cli_ranks_and_persists_without_measuring(tmp_path):
    path = tmp_path / "s.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_TUNE_CACHE": str(path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "matmul", "8", "256",
         "512", "--dtype", "bfloat16", "--no-measure"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "#0: tiles=" in res.stdout and "winner: tiles=" in res.stdout
    assert "matmul/m8n256k512/bfloat16/cpu" in json.loads(
        path.read_text())["schedules"]


QUANT_SPECS = [("matmul_w8", (8, 4096, 4096), "bfloat16", (8, 512, 64)),
               ("matmul_w8", (64, 4096, 12800), "float32", (16, 64, 128)),
               ("matmul_w8", (16, 32, 64), "float32", (16, 64, 32)),
               ("flash_decode_fp8", (4, 512, 128), "bfloat16", (64,)),
               ("flash_decode_fp8", (2, 64, 16), "float32", (8,))]


@pytest.mark.parametrize("op,dims,dtype,tiles", QUANT_SPECS)
def test_quantized_keys_model_arithmetic_matches_jax(op, dims, dtype, tiles):
    """The quantized keys' nests carry the one-byte operand as JAX's do:
    the blocking string, access counts, byte-weighted traffic (the rank
    the port sorts them by), level-0 bytes (the fp8 scales included) and
    cache key equal JAX's for the same spec, tiles and budget."""
    spec, jspec = OpSpec(op, dims, dtype), JOpSpec(op, dims, dtype)
    assert spec.problem().weight_bpe == 1
    assert repr(schedule_to_string(spec, tiles)) == \
        repr(jlowering.schedule_to_string(jspec, tiles))
    assert predicted_dram_accesses(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_accesses(jspec, tiles, BUDGET)
    assert predicted_dram_bytes(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_bytes(jspec, tiles, BUDGET)
    assert level0_dram_bytes(spec, tiles) == \
        jlowering.level0_dram_bytes(jspec, tiles)
    assert spec.key("cpu") == jspec.key("cpu")


@pytest.mark.parametrize("op,dims,dtype", [
    ("matmul_w8", (8, 4096, 12800), "bfloat16"),
    ("matmul_w8", (512, 1024, 4096), "float32"),
    ("flash_decode_fp8", (4, 512, 128), "bfloat16"),
    ("flash_decode_fp8", (4, 512, 128), "float32")])
def test_quantized_candidates_fit_the_cuda_kernels(op, dims, dtype):
    """Every candidate fits its kernel's footprint with the narrow
    operand at one byte (``matmul_q.smem_bytes_required`` of the
    instance for the spec's M, bf16 on the tensor cores; the fp8 pages
    of ``flash_decode.smem_bytes_required``), an int8 weight tile is a
    whole number of 16-byte copies, the candidates rank by predicted
    bytes, and an fp8 page is a whole divisor of S."""
    from repro_torch.kernels import matmul_blocked as MB
    from repro_torch.kernels import matmul_fused as MF
    from repro_torch.kernels import matmul_q as MQ
    from repro_torch.kernels.flash_decode import (ROWS_PER_BLOCK,
                                                  smem_bytes_required)
    spec = OpSpec(op, dims, dtype)
    cands = candidates(spec)
    assert cands
    nbytes = [predicted_dram_bytes(spec, s.tiles) for s in cands]
    assert nbytes == sorted(nbytes)
    for s in cands:
        assert fits_smem(spec, s.tiles, BUDGET)
        if op == "flash_decode_fp8":
            G, S, D = dims
            (page,) = s.tiles
            assert S % page == 0
            assert smem_bytes_required(page, ROWS_PER_BLOCK, D,
                                       spec.itemsize, 1) <= BUDGET
            continue
        bm, bk, bn = s.tiles
        m, n, _ = dims
        assert bn % MB.INT8_COLS == 0
        limit = BUDGET
        if spec.itemsize == 2 and m <= 16:       # one wave may opt in
            limit = decode_smem_limit(n, bn, BUDGET)
        assert MQ.smem_bytes_required(bm, bk, bn, spec.itemsize,
                                      m=m) <= limit
        assert (MF.accumulators_per_thread(bm, bn, spec.itemsize, m=m)
                <= H100_SXM.acc_per_thread)


@pytest.mark.parametrize("op,dims,key", [
    ("matmul_w8", ["8", "4096", "4096"],
     "matmul_w8/m8n4096k4096/bfloat16/cpu"),
    ("flash_decode_fp8", ["4", "512", "128"],
     "flash_decode_fp8/g4s512d128/bfloat16/cpu")])
def test_cli_takes_the_quantized_keys(tmp_path, op, dims, key):
    path = tmp_path / "s.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_TUNE_CACHE": str(path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", op, *dims, "--dtype",
         "bfloat16", "--no-measure"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "winner: tiles=" in res.stdout
    assert key in json.loads(path.read_text())["schedules"]


# -- the training path's dgrad key -----------------------------------------

DGRAD_SPECS = [("matmul_dgrad", (2048, 4096, 12800), "bfloat16",
                (128, 64, 128)),
               ("matmul_dgrad", (12800, 4096, 2048), "float32",
                (64, 64, 128)),
               ("matmul_dgrad", (64, 32, 48), "float32", (16, 48, 32))]


@pytest.mark.parametrize("op,dims,dtype,tiles", DGRAD_SPECS)
def test_dgrad_key_model_arithmetic_and_cache_key_match_jax(op, dims, dtype,
                                                            tiles):
    """dA asks (M, K, N), dB (K, N, M): the GEMM nest over the
    cotangent's (M_out, N_out, K_reduce), scored and keyed as JAX's."""
    spec, jspec = OpSpec(op, dims, dtype), JOpSpec(op, dims, dtype)
    assert repr(schedule_to_string(spec, tiles)) == \
        repr(jlowering.schedule_to_string(jspec, tiles))
    assert predicted_dram_accesses(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_accesses(jspec, tiles, BUDGET)
    assert level0_dram_bytes(spec, tiles) == \
        jlowering.level0_dram_bytes(jspec, tiles)
    assert spec.key("cpu") == jspec.key("cpu") == \
        f"matmul_dgrad/m{dims[0]}n{dims[1]}k{dims[2]}/{dtype}/cpu"


@pytest.mark.parametrize("dims,dtype", [((2048, 4096, 4096), "bfloat16"),
                                        ((4096, 12800, 2048), "bfloat16"),
                                        ((2048, 12800, 4096), "float32"),
                                        ((37, 65, 33), "float32")])
def test_dgrad_candidates_fit_the_tile_core(dims, dtype):
    """Every "matmul_dgrad" candidate fits the dgrad kernels' own
    footprint (``matmul_bwd.smem_bytes_required``) within the two-block
    budget and the instance's fp32 sums within the register limit (bf16:
    the tensor-core warp grid, at most 1/8 of its rows empty; fp32: the
    tile core's accumulator); the dividing ones rank by predicted
    accesses, as JAX ranks the key."""
    from repro_torch.core.hopper_adapter import MAX_EMPTY_ROWS
    from repro_torch.kernels import matmul_blocked as MBL
    from repro_torch.kernels import matmul_bwd as MBW
    spec = OpSpec("matmul_dgrad", dims, dtype)
    cands = candidates(spec)
    assert cands
    for s in cands:
        bm, bk, bn = s.tiles
        assert fits_smem(spec, s.tiles, BUDGET)
        assert MBW.smem_bytes_required(bm, bk, bn, spec.itemsize) <= BUDGET
        assert MBW.accumulators_per_thread(bm, bn, spec.itemsize) \
            <= H100_SXM.acc_per_thread
        if spec.itemsize == 2:
            assert MBW.empty_row_share(bm, bn) <= MAX_EMPTY_ROWS
        else:
            assert MBL.accumulators_per_thread(bm, bn) \
                <= H100_SXM.acc_per_thread
    scored = [s.predicted_dram_accesses for s in cands
              if s.predicted_dram_accesses is not None]
    assert scored == sorted(scored)
    assert best_schedule("matmul_dgrad", dims, dtype).tiles == cands[0].tiles


def test_cli_takes_the_dgrad_key(tmp_path):
    path = tmp_path / "s.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_TUNE_CACHE": str(path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "matmul_dgrad", "2048",
         "4096", "12800", "--dtype", "bfloat16", "--no-measure"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "winner: tiles=" in res.stdout
    assert "matmul_dgrad/m2048n4096k12800/bfloat16/cpu" in json.loads(
        path.read_text())["schedules"]


# -- the conv path's keys ----------------------------------------------------


CONV_SPECS = [("conv2d", (26, 26, 32, 64, 3, 3), "float32", 1,
               (13, 13, 32, 64)),
              ("conv2d", (56, 56, 128, 256, 3, 3), "bfloat16", 1,
               (14, 14, 32, 64)),
              ("conv2d", (27, 27, 16, 32, 5, 5), "bfloat16", 2,
               (9, 9, 8, 16)),
              ("conv2d_dgrad", (58, 58, 256, 128, 3, 3), "float32", 1,
               (29, 29, 32, 64)),
              ("conv2d_wgrad", (56, 56, 128, 256, 3, 3), "bfloat16", 1,
               (28, 8, 32, 32)),
              ("conv2d_wgrad", (27, 27, 3, 96, 11, 11), "float32", 4,
               (27, 27, 3, 32))]


@pytest.mark.parametrize("op,dims,dtype,stride,tiles", CONV_SPECS)
def test_conv_keys_model_arithmetic_matches_jax(op, dims, dtype, stride,
                                                tiles):
    """The conv nests (the wgrad's with the spatial reduction innermost),
    their access counts and cache keys equal JAX's for the same spec,
    tiles and budget; neither package's ``level0_dram_bytes`` covers
    them (the kernels count their own halo traffic)."""
    spec = OpSpec(op, dims, dtype, stride)
    jspec = JOpSpec(op, dims, dtype, stride)
    assert repr(schedule_to_string(spec, tiles)) == \
        repr(jlowering.schedule_to_string(jspec, tiles))
    assert predicted_dram_accesses(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_accesses(jspec, tiles, BUDGET)
    assert predicted_dram_bytes(spec, tiles, BUDGET) == \
        jlowering.predicted_dram_bytes(jspec, tiles, BUDGET)
    with pytest.raises(ValueError):
        level0_dram_bytes(spec, tiles)
    with pytest.raises(ValueError):
        jlowering.level0_dram_bytes(jspec, tiles)
    X, Y, C, K, Fw, Fh = dims
    assert spec.key("cpu") == jspec.key("cpu") == \
        f"{op}/x{X}y{Y}c{C}k{K}f{Fw}x{Fh}s{stride}/{dtype}/cpu"


@pytest.mark.parametrize("op,dims,dtype,stride", [
    ("conv2d", (26, 26, 32, 64, 3, 3), "float32", 1),
    ("conv2d", (26, 26, 32, 64, 3, 3), "bfloat16", 1),
    ("conv2d", (56, 56, 128, 256, 3, 3), "bfloat16", 1),
    ("conv2d", (55, 55, 3, 96, 11, 11), "bfloat16", 4),
    ("conv2d_dgrad", (58, 58, 256, 128, 3, 3), "float32", 1),
    ("conv2d_wgrad", (56, 56, 128, 256, 3, 3), "bfloat16", 1),
    ("conv2d_wgrad", (55, 55, 3, 96, 11, 11), "float32", 4)])
def test_conv_candidates_divide_and_fit(op, dims, dtype, stride):
    """``test_tune.py``'s conv check on the Hopper target: every candidate
    fits its kernel's own footprint and accumulator limit (row 12's for
    the forward and dgrad, row 13's for the wgrad), the dividing ones
    rank by predicted accesses, and ``best_schedule`` takes the first."""
    from repro_torch.kernels import conv2d_blocked as CB
    from repro_torch.kernels import conv2d_bwd as CW
    spec = OpSpec(op, dims, dtype, stride)
    cands = candidates(spec)
    assert cands
    X, Y, C, K, Fw, Fh = dims
    s = 1 if op == "conv2d_dgrad" else stride
    for sch in cands:
        bx, by, bc, bk = sch.tiles
        assert fits_smem(spec, sch.tiles, BUDGET)
        if op == "conv2d_wgrad":
            assert CW.smem_bytes_required(bx, by, bc, bk, Fh, Fw,
                                          spec.itemsize, s) <= BUDGET
            assert CW.accumulators_per_thread(bc, bk, Fh, Fw,
                                              spec.itemsize) <= \
                H100_SXM.acc_per_thread
        else:
            assert CB.smem_bytes_required(bx, by, bc, bk, Fh, Fw,
                                          spec.itemsize, s,
                                          channels=C) <= BUDGET
            assert CB.accumulators_per_thread(bx * by, bk,
                                              spec.itemsize) <= \
                H100_SXM.acc_per_thread
        assert divides(spec, sch.tiles)
        assert sch.predicted_dram_accesses is not None
    accesses = [sch.predicted_dram_accesses for sch in cands]
    assert accesses == sorted(accesses)
    assert best_schedule(op, dims, dtype, stride=stride).tiles == \
        cands[0].tiles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_conv_candidates_respect_stride_halo(dtype):
    """``test_tune.py``'s 7 x 7 / stride-2 case: the snap loop budgets the
    stride-widened halo, or the filter (which does) rejects everything.
    The budget is tight enough that the halo decides."""
    spec = OpSpec("conv2d", (56, 56, 64, 128, 7, 7), dtype, 2)
    budget = 48 * 1024
    cands = candidates(spec, smem_budget_bytes=budget)
    assert cands
    for sch in cands:
        assert fits_smem(spec, sch.tiles, budget)
        assert sch.predicted_dram_accesses is not None
    # at stride 1 the same tiles need less: the halo is what grew
    flat = OpSpec("conv2d", (56, 56, 64, 128, 7, 7), dtype, 1)
    assert all(fits_smem(flat, sch.tiles, budget) for sch in cands)


def test_large_filters_squeeze_channel_tiles_below_the_gemm_multiple():
    """Conv1's 11 x 11 weight tile: bc and bk go below ``nk_mult`` (64),
    down to 16-byte vectors; C = 3 (AlexNet conv1) stays whole."""
    (bx, by, bc, bk), *_ = [s.tiles for s in candidates(
        OpSpec("conv2d", (256, 256, 256, 384, 11, 11), "bfloat16"))]
    assert bc < H100_SXM.nk_mult and bk < H100_SXM.nk_mult
    assert bc % 8 == 0 and bk % 8 == 0
    alex = candidates(OpSpec("conv2d", (55, 55, 3, 96, 11, 11),
                             "bfloat16", 4))
    assert all(s.tiles[2] == 3 for s in alex)


def test_best_schedule_keys_the_stride(tmp_path):
    cache = ScheduleCache(str(tmp_path / "s.json"))
    dims = (8, 8, 4, 8, 3, 3)
    w2 = tune_op("conv2d", dims, measure=False, cache=cache, stride=2)
    assert w2.spec.stride == 2
    assert best_schedule("conv2d", dims, cache=cache,
                         stride=2).source == "cache"
    assert best_schedule("conv2d", dims, cache=cache,
                         stride=1).source == "analytic"


@pytest.mark.parametrize("op,dims,stride,key", [
    ("conv2d", ["6", "6", "4", "8", "3", "3"], "1",
     "conv2d/x6y6c4k8f3x3s1/float32/cpu"),
    ("conv2d", ["6", "6", "4", "8", "3", "3"], "2",
     "conv2d/x6y6c4k8f3x3s2/float32/cpu"),
    ("conv2d_dgrad", ["8", "8", "8", "4", "3", "3"], "1",
     "conv2d_dgrad/x8y8c8k4f3x3s1/float32/cpu"),
    ("conv2d_wgrad", ["6", "6", "4", "8", "3", "3"], "2",
     "conv2d_wgrad/x6y6c4k8f3x3s2/float32/cpu")])
def test_cli_takes_the_conv_keys(tmp_path, op, dims, stride, key):
    path = tmp_path / "s.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_TUNE_CACHE": str(path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", op, *dims, "--stride",
         stride, "--no-measure"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "winner: tiles=" in res.stdout
    entry = json.loads(path.read_text())["schedules"][key]
    assert entry["stride"] == int(stride)
