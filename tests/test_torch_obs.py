"""The port's observability stack against the JAX package's
(``repro_torch.obs`` vs ``repro.obs``): the Chrome-trace tracer, the
DRAM ledger and its miss log, ``tune --from-telemetry``, the engines'
and the training loop's ``obs=``, the zero-sync guard and both
launchers' ``--trace`` / ``--miss-log``.

The reduced granite (fp32, ``params_from_numpy`` of JAX's weights) runs
the port's plain versions on the CPU and JAX's Pallas kernels in
interpret mode.  Tokens are compared exactly (greedy decoding of the
same weights; the fused path is token-identical to JAX's, as in
``test_torch_fused.py``).  Span names, scope tags, per-tag executions
and the observed ``(op, dims, dtype)`` are compared as sets or counts;
dispatches follow the eager relation the ledger documents: one per
kernel call, where JAX counts one per trace.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.obs import DramLedger as JDramLedger
from repro.obs import Obs as JObs
from repro.obs import StepTracer as JStepTracer
from repro.obs import read_miss_log as j_read_miss_log
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import PagedServeConfig as JPagedServeConfig
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import tune
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.base import map_tree
from repro_torch.obs import (DramLedger, MetricsRegistry, Obs, StepTracer,
                             read_miss_log)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import (DecodeEngine, PagedEngine,
                                      PagedServeConfig, ServeConfig)
from repro_torch.tune.__main__ import main as tune_main
from repro_torch.train import loop

ARCH = "granite-3-8b"
PAGED = dict(max_seq=32, max_batch=2, page_size=8, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    # a smaller embedding lets the blocks steer the argmax, so every
    # decode step carries information (as in test_torch_fused.py)
    tree["embed"] = {"embedding": tree["embed"]["embedding"] / 10}
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, cfg, params_from_numpy(cfg, tree, device="cpu")


PROMPTS = [np.arange(1, 6, dtype=np.int32),       # one join
           np.arange(3, 15, dtype=np.int32)]      # two prefill chunks


def _paged(obs=None, fuse=True):
    _, _, cfg, params = _model()
    eng = PagedEngine(cfg, params, PagedServeConfig(**PAGED, device="cpu",
                                                    fuse=fuse), obs=obs)
    return eng, eng.generate(PROMPTS, 5)


def _static(obs=None, fuse=True):
    _, _, cfg, params = _model()
    eng = DecodeEngine(cfg, params, ServeConfig(max_seq=32, fuse=fuse,
                                                device="cpu"), obs=obs)
    prompts = np.stack([np.arange(1, 7), np.arange(4, 10)]).astype(np.int32)
    return eng, eng.generate(prompts, 4)


class _SpecLog:
    """Mixin recording the ``(op, dims, dtype)`` every resolution the
    ledger hears about carries (both packages call ``record``)."""

    def record(self, spec, schedule):
        self.seen.add((spec.op, tuple(spec.dims), spec.dtype))
        super().record(spec, schedule)


class _Ledger(_SpecLog, DramLedger):
    seen: set


class _JLedger(_SpecLog, JDramLedger):
    seen: set


def _spans(path) -> list[dict]:
    return json.loads(path.read_text())


def _nested_in_steps(events) -> bool:
    steps = [e for e in events if e["name"] == "step"]
    return all(any(s["ts"] - 1e-6 <= e["ts"]
                   and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 1e-6
                   for s in steps)
               for e in events if e["ph"] == "X" and e["name"] != "step")


# ============================= the tracer ==================================


def _drive_tracer(tr) -> None:
    with tr.span("outer", cat="engine", args={"step": 0}):
        with tr.span("inner_a"):
            pass
        with tr.span("inner_b", cat="device"):
            pass
    tr.instant("marker", args={"k": 1})
    tr.counter("queue", {"depth": 3})
    tr.close()
    tr.close()                                  # idempotent


def test_tracer_file_matches_jax_tracer(tmp_path):
    """The same calls on both tracers give one valid JSON array each,
    with the same events in the same order (name, kind, category, args)
    and the same nesting by interval containment."""
    files = {}
    for name, cls in (("port", StepTracer), ("jax", JStepTracer)):
        files[name] = tmp_path / f"{name}.json"
        _drive_tracer(cls(files[name]))
    port, ref = _spans(files["port"]), _spans(files["jax"])

    def shape(e):
        return (e["name"], e["ph"], e.get("cat"), e.get("s"), e.get("args"))
    assert [shape(e) for e in port] == [shape(e) for e in ref]
    by = {e["name"]: e for e in port}
    outer = by["outer"]
    for inner in (by["inner_a"], by["inner_b"]):
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert by["inner_a"]["ts"] + by["inner_a"]["dur"] <= by["inner_b"]["ts"]
    # one event per line between the array's brackets
    lines = files["port"].read_text().splitlines()
    assert lines[0] == "[" and lines[-1] == "]" and len(lines) == 7


# ======================= the ledger and its miss log =======================


def test_read_miss_log_equals_jax_on_a_corrupt_file(tmp_path):
    p = tmp_path / "miss.jsonl"
    p.write_text('{"op": "matmul", "dims": [8, 8, 8]}\n'
                 "not json\n"
                 "\n"
                 '{"op": "matmul", "dims": [8, 8, 8]}\n'         # duplicate
                 '{"op": "qkv_fused", "dims": [8, 32, 64, 2], '
                 '"dtype": "bfloat16"}\n'
                 '{"op": "conv2d", "dims": [6, 6, 4, 8, 3, 3], '
                 '"stride": 2}\n'
                 '{"dims": [1]}\n'                              # no op
                 '{"op": "matmul", "dims": [8, 8')             # truncated
    got = read_miss_log(str(p))
    assert got == j_read_miss_log(str(p))
    assert [t["op"] for t in got] == ["matmul", "qkv_fused", "conv2d"]


def test_tune_cli_replays_telemetry_dry_run(tmp_path, capsys):
    p = tmp_path / "miss.jsonl"
    p.write_text('{"op": "matmul", "dims": [64, 64, 64], '
                 '"dtype": "float32", "stride": 1}\n'
                 '{"op": "flash_decode", "dims": [4, 512, 128], '
                 '"dtype": "bfloat16"}\n')
    cache = tmp_path / "cache.json"
    tune_main(["--from-telemetry", str(p), "--dry-run", "--cache",
               str(cache)])
    out = capsys.readouterr().out
    assert "2 distinct miss target(s)" in out
    assert "would tune matmul/m64n64k64/float32/" in out
    assert "would tune flash_decode/g4s512d128/bfloat16/" in out
    assert not cache.exists()                  # nothing persisted
    with pytest.raises(SystemExit):            # op and dims, or a log
        tune_main([])


def test_ledger_attributes_each_execution_eagerly(tmp_path, monkeypatch):
    """Every call's resolution counts (JAX counts one per trace): two
    executions of a scope resolving one spec twice each give 4
    resolutions, 2 executions, and a mean of twice the bytes per
    execution; a repeat resolution evaluates no model."""
    miss = tmp_path / "miss.jsonl"
    reg = MetricsRegistry()
    led = DramLedger(registry=reg, miss_log=str(miss))
    for _ in range(2):
        with led.scope("gemm[64]"):
            tune.best_schedule("matmul", (64, 64, 64))
            # the repeat is a dict hit: no model evaluation, no key
            monkeypatch.setattr(tune, "predicted_dram_bytes", None)
            tune.best_schedule("matmul", (64, 64, 64))
    tune.best_schedule("matmul", (64, 64, 64))      # outside: unobserved
    step_bytes = led.end_step([0, 1])
    rep = led.report()
    (key,) = rep["per_op"]
    ent = rep["per_op"][key]
    assert key == "matmul/m64n64k64/float32/cpu"
    assert ent["resolved"] == 4 and ent["source"] == "analytic"
    assert ent["modeled_bytes"] == ent["used_bytes"] > 0
    tag = rep["per_tag"]["gemm[64]"]
    assert tag == {"executions": 2, "ops": [key],
                   "bytes_per_execution": 2.0 * ent["used_bytes"]}
    assert rep["total_bytes"] == step_bytes == 4 * ent["used_bytes"]
    assert rep["per_request"]["by_rid"] == {
        "0": 2.0 * ent["used_bytes"], "1": 2.0 * ent["used_bytes"]}
    assert reg.snapshot()["schedule_cache"] == {"hits": 0, "misses": 4}
    assert tune.set_schedule_observer(None) is None  # scopes restored it
    led.close()
    assert read_miss_log(str(miss)) == [
        {"op": "matmul", "dims": [64, 64, 64], "dtype": "float32",
         "stride": 1}]


def test_nested_scopes_take_their_own_resolutions():
    led = DramLedger()
    with led.scope("outer"):
        tune.best_schedule("matmul", (32, 32, 32))
        with led.scope("inner"):
            tune.best_schedule("matmul", (64, 64, 64))
        tune.best_schedule("matmul", (32, 32, 32))
    rep = led.report()
    assert rep["per_tag"]["outer"]["ops"] == ["matmul/m32n32k32/float32/cpu"]
    assert rep["per_tag"]["inner"]["ops"] == ["matmul/m64n64k64/float32/cpu"]
    assert rep["per_op"]["matmul/m32n32k32/float32/cpu"]["resolved"] == 2


def test_obs_bundle_snapshot_and_close(tmp_path):
    obs = Obs(trace=str(tmp_path / "t.json"),
              miss_log=str(tmp_path / "m.jsonl"))
    with obs.dram.scope("x"):
        tune.best_schedule("matmul", (16, 16, 16))
    with obs.tracer.span("s"):
        pass
    obs.write_metrics(tmp_path / "sub" / "m.json")
    snap = json.loads((tmp_path / "sub" / "m.json").read_text())
    assert snap["schedule_cache"]["misses"] == 1
    assert "matmul/m16n16k16/float32/cpu" in snap["dram"]["per_op"]
    obs.close()
    assert [e["name"] for e in _spans(tmp_path / "t.json")] == ["s"]
    assert read_miss_log(str(tmp_path / "m.jsonl"))[0]["dims"] == [16] * 3


# ============================== the engines ================================


@pytest.mark.parametrize("which", ["paged", "static"])
def test_no_device_fence_when_tracing_off(which, monkeypatch, tmp_path):
    """JAX's zero-sync guard: without a tracer no engine path calls the
    device fence; with one, every dispatch scope does."""
    calls = []
    monkeypatch.setattr(engine_mod, "device_fence",
                        lambda device: calls.append(device))
    run = _paged if which == "paged" else _static
    eng, _ = run()
    assert eng.obs.tracer is None
    assert not calls, "an engine fenced the device without a tracer"
    obs = Obs(trace=StepTracer(tmp_path / "t.json"))
    run(obs)
    obs.close()
    assert calls and all(d.type == "cpu" for d in calls)


@pytest.mark.parametrize("which", ["paged", "static"])
def test_tokens_identical_with_tracing_on(which, tmp_path):
    run = _paged if which == "paged" else _static
    _, off = run()
    obs = Obs(trace=str(tmp_path / "t.json"))
    _, on = run(obs)
    obs.close()
    np.testing.assert_array_equal(on, off)


def test_paged_engine_obs_matches_jax(tmp_path, monkeypatch):
    """``PagedEngine(obs=...)`` against JAX's, fused, JAX's kernel paths
    forced (``REPRO_FORCE_KERNELS``, as its profiler forces them: off
    the TPU its ops otherwise resolve no schedule): equal tokens, equal
    span names (every span inside a step), equal scope tags and
    per-tag executions, the same observed ``(op, dims, dtype)``; the
    port's ``qkv_fused`` dispatches are one a layer a model call."""
    jcfg, jparams, cfg, params = _model()
    jled, led = _JLedger(), _Ledger()
    jled.seen, led.seen = set(), set()
    monkeypatch.setenv("REPRO_FORCE_KERNELS", "1")
    jobs = JObs(trace=str(tmp_path / "j.json"), dram=jled)
    want = JPagedEngine(jcfg, jparams, JPagedServeConfig(
        **PAGED, fuse=True), obs=jobs).generate(PROMPTS, 5)
    jobs.close()
    obs = Obs(trace=str(tmp_path / "p.json"), dram=led)
    eng, got = _paged(obs)
    obs.close()
    np.testing.assert_array_equal(got, want)

    jev, ev = _spans(tmp_path / "j.json"), _spans(tmp_path / "p.json")
    assert {e["name"] for e in ev} == {e["name"] for e in jev}
    assert {"step", "host_prep", "plan_step", "dispatch.decode",
            "dispatch.join", "dispatch.prefill", "readback"} <= \
        {e["name"] for e in ev}
    assert _nested_in_steps(ev)

    jrep, rep = jled.report(), led.report()
    assert {t: v["executions"] for t, v in rep["per_tag"].items()} == \
        {t: v["executions"] for t, v in jrep["per_tag"].items()}
    assert {"setup", "join[8]", "prefill[8]", "prefill[4]"} <= \
        set(rep["per_tag"])
    assert led.seen == jled.seen
    assert set(rep["per_op"]) == set(jrep["per_op"])
    # eager dispatches: one qkv_fused call a layer a model call
    snap = eng.metrics.snapshot()["engine"]
    calls = snap["joins"] + snap["prefill_chunks"] + snap["decode_steps"]
    qkv = sum(v["resolved"] for k, v in rep["per_op"].items()
              if k.startswith("qkv_fused/"))
    assert qkv == cfg.n_layers * calls
    assert rep["per_step"]["steps"] == snap["steps"]
    assert rep["per_request"]["requests"] == len(PROMPTS)


def test_static_engine_obs_matches_jax(tmp_path, monkeypatch):
    """``DecodeEngine(obs=...)`` against JAX's, fused, JAX's kernel paths
    forced: equal tokens,
    spans and tags (``static_prefill[S0]``, ``static_generate[n]``),
    the same observed specs; one step closed, both requests charged."""
    jcfg, jparams, cfg, params = _model()
    jled, led = _JLedger(), _Ledger()
    jled.seen, led.seen = set(), set()
    prompts = np.stack([np.arange(1, 7), np.arange(4, 10)]).astype(np.int32)
    monkeypatch.setenv("REPRO_FORCE_KERNELS", "1")
    jobs = JObs(trace=str(tmp_path / "j.json"), dram=jled)
    want = JDecodeEngine(jcfg, jparams, JServeConfig(
        max_seq=32, fuse=True), obs=jobs).generate(prompts, 4)
    jobs.close()
    obs = Obs(trace=str(tmp_path / "p.json"), dram=led)
    _, got = _static(obs)
    obs.close()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert {e["name"] for e in _spans(tmp_path / "p.json")} == \
        {e["name"] for e in _spans(tmp_path / "j.json")} == \
        {"prefill", "decode", "readback"}
    rep, jrep = led.report(), jled.report()
    assert set(rep["per_tag"]) == set(jrep["per_tag"]) == \
        {"static_prefill[6]", "static_generate[4]"}
    assert led.seen == jled.seen
    assert rep["per_step"]["steps"] == 1
    assert rep["per_request"]["requests"] == 2
    # the decode loop's 3 steps each call qkv_fused once a layer
    dec = [v for k, v in rep["per_op"].items()
           if k.startswith("qkv_fused/m2n")]
    assert [v["resolved"] for v in dec] == [3 * cfg.n_layers]


def test_engine_metrics_is_the_bundles_registry():
    reg = MetricsRegistry()
    eng, _ = _paged(Obs(registry=reg), fuse=False)
    assert eng.metrics is reg
    assert reg.snapshot()["engine"]["steps"] > 0


# ============================== training ===================================


def _train(obs=None, blocked=True, steps=2):
    from repro_torch.data.pipeline import make_batch
    _, _, cfg, params = _model()
    tc = loop.TrainConfig(blocked_linear=blocked, log_every=100)
    batches = (make_batch(cfg, 8, 2, s, device="cpu") for s in range(steps))
    clone = map_tree(lambda x: x.clone(), params)
    return loop.train(cfg, tc, batches, params=clone, device="cpu",
                      log=lambda *_: None, obs=obs)


def test_train_with_obs_equals_train_without(tmp_path):
    """Observation, not perturbation: the same losses; the trace has a
    step span per step with its grad span inside, the train counter
    track; the ledger's train_step scope saw the blocked GEMM's forward
    and dgrad keys, once per step."""
    plain = _train()
    obs = Obs(trace=str(tmp_path / "t.json"))
    traced = _train(obs)
    obs.close()
    assert traced["history"] == plain["history"]
    ev = _spans(tmp_path / "t.json")
    names = [e["name"] for e in ev]
    assert names.count("grad") == 2 and "step 0" in names
    assert "step 1" in names
    assert [e["args"]["loss"] for e in ev if e["ph"] == "C"] == \
        pytest.approx(plain["history"])
    rep = obs.dram.report()
    assert rep["per_tag"]["train_step"]["executions"] == 2
    ops = {k.split("/")[0] for k in rep["per_tag"]["train_step"]["ops"]}
    assert ops == {"matmul", "matmul_dgrad"}
    assert obs.registry.snapshot()["train"]["steps"] == 2


# ============================== launchers ==================================


@pytest.mark.parametrize("engine", ["paged", "static"])
def test_launch_serve_trace_and_miss_log(engine, tmp_path, capsys):
    trace, miss, met = (tmp_path / "t.json", tmp_path / "m.jsonl",
                        tmp_path / "met.json")
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--dtype", "float32", "--engine", engine,
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--max-seq", "32", "--fuse", "--trace", str(trace),
                       "--miss-log", str(miss), "--metrics-out", str(met)])
    out = capsys.readouterr().out
    assert f"chrome trace -> {trace}" in out
    assert "modeled-vs-resolved DRAM bytes per op key" in out
    names = {e["name"] for e in _spans(trace)}
    assert ("dispatch.decode" in names) if engine == "paged" else \
        ("decode" in names)
    targets = read_miss_log(str(miss))
    assert {"qkv_fused", "matmul_fused"} <= {t["op"] for t in targets}
    snap = json.loads(met.read_text())
    assert snap["schedule_cache"]["misses"] > 0 and snap["dram"]["per_op"]


def test_launch_train_trace_and_miss_log(tmp_path, capsys):
    trace, miss = tmp_path / "t.json", tmp_path / "m.jsonl"
    launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--dtype", "float32", "--steps", "2", "--seq-len",
                       "8", "--batch", "2", "--blocked-kernels",
                       "--trace", str(trace), "--miss-log", str(miss)])
    out = capsys.readouterr().out
    assert "chrome trace ->" in out and "schedule-cache miss log" in out
    assert {"step 0", "step 1", "grad"} <= \
        {e["name"] for e in _spans(trace)}
    assert {t["op"] for t in read_miss_log(str(miss))} == \
        {"matmul", "matmul_dgrad"}
