"""The harness: the device trace's reduction, the last line, the refusal
without a card, and that nothing under the benchmark imports JAX or the
JAX package (or, under ``reference/``, the measured program)."""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import devtrace, harness, layer_metrics

HERE = Path(harness.__file__).resolve().parent
ROOT = HERE.parent


def test_busy_union_and_idle_share():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0)]
    assert devtrace.busy_seconds(ev) == pytest.approx(2.5)
    assert devtrace.idle_gaps(ev, 0.0, 5.0) == [(1.5, 3.0), (4.0, 5.0)]
    r = {"events": ev, "window_s": 5.0, "busy_s": devtrace.busy_seconds(ev)}
    assert layer_metrics.idle_pct(r) == pytest.approx(50.0)


def test_breakdown_names_gaps_by_span():
    ev = [("gemm", 0.0, 1.0), ("gemm", 2.0, 3.0), ("attn", 3.0, 3.5)]
    spans = [("step", 0.0, 3.6), ("submit", 1.2, 1.9), ("wait", 3.6, 5.0)]
    b = devtrace.breakdown(ev, spans, 0.0, 5.0)
    assert b["device_ops"] == [["gemm", 2.0], ["attn", 0.5]]
    assert b["idle_gaps"] == [["wait", 1.5], ["submit", 1.0]]


def test_attn_roofline_reads_only_attention_kernels():
    ev = [("void fwd_mma_kernel<128>(...)", 0.0, 0.002),
          ("sm90_xmma_gemm", 0.002, 0.010)]
    r = {"events": ev, "attn_flops": 989e12 * 0.001, "attn_bytes": 0.0}
    assert layer_metrics.attn_roofline(r) == pytest.approx(50.0)
    assert layer_metrics.attn_roofline(dict(r, events=ev[1:])) is None


def test_mfu():
    r = {"model_flops": 989e12, "window_s": 4.0}
    assert layer_metrics.mfu(r) == pytest.approx(25.0)
    assert layer_metrics.mfu(None) is None


def _bench():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_every_named_file_exists():
    bench = _bench()
    for w in bench["workloads"]:
        mix, conf, limits, chips = harness.cell_files(bench, w["name"])
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
        assert limits and chips == w["chips"]
    for m in bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert harness.load_json(ROOT / c["file"])["name"] == c["name"]


def test_last_line_keys():
    bench = _bench()
    out = harness.Outcome(
        attempted=10, failed=1, e2e={"ttft_p90_ms": 900.0, "setup_s": 30.0},
        checks=[harness.Check("kv_rel_err", 0.01, 0.05)],
        memory_peak_bytes=5)
    ctx = harness.Context("granite-3-8b.prefill-pool", {}, {}, {}, 1, 10.0,
                          False, torch.device("cpu"), 0.0)
    info = {"platform": "gpu", "kind": "x", "count": 1,
            "memory_peak_bytes": 5}
    res = harness.line(ctx, bench, out, info)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"ttft_p90_ms", "setup_s"}
    assert res["metrics"]["setup_s"] == {"value": 30.0, "unit": "s"}
    events = [("fwd_mma_kernel", 0.0, 1.0)]
    out.readings = {"events": events, "window_s": 2.0, "busy_s": 1.0,
                    "model_flops": 1e12, "attn_flops": 1e9,
                    "attn_bytes": 1e6, "queue_waits_ms": [1.0, math.inf]}
    out.busy_s, out.window_s = 1.0, 2.0
    out.breakdown = devtrace.breakdown(events, [], 0.0, 2.0)
    ctx.trace = True
    res = harness.line(ctx, bench, out, info)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert set(res["metrics"]) == {"mfu.ttft", "attn_roofline.ttft",
                                   "device_idle_pct.ttft"}
    assert res["device"]["busy_s"] == 1.0 and res["device"]["window_s"] == 2.0
    json.dumps(res)


def test_failed_check_makes_the_run_incorrect():
    out = harness.Outcome(1, 0, {}, [harness.Check("a", 0.1, 0.05)], 0)
    assert not out.correct
    assert not harness.Outcome(1, 0, {}, [], 0).correct
    assert not harness.Check("a", math.nan, 1.0).ok


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "granite-3-8b.train4k", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_forbidden_modules_by_whole_name():
    ok = ["torch", "repro_torch", "repro_torch.serve.engine", "jaxtyping"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["repro.models", "jax.numpy",
                                           "flax"]) == ["flax", "jax",
                                                        "repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_and_no_program_in_the_reference():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        names = _imports(f)
        assert not names & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.relative_to(HERE).parts:
            assert "repro_torch" not in names, f


def _ops(kept: str) -> list:
    start = {"name": "spin_kernel", "ts": 100.0e6, "dur": 1.0}
    end = {"name": "spin_kernel", "ts": 105.0e6, "dur": 1.0}
    ops = [{"name": "gemm", "ts": 100.001e6, "dur": 5.0},
           {"name": "late", "ts": 106.0e6, "dur": 5.0}]
    ops = ([start] if kept in ("both", "start") else []) + ops + \
        ([end] if kept in ("both", "end") else [])
    return sorted(ops, key=lambda e: e["ts"])


def test_clocks_tied_by_the_start_marker():
    # host seconds 10..14 are device seconds 100..104
    ev = devtrace.clip(_ops("both"), 10.0, 14.0)
    assert [n for n, _, _ in ev] == ["gemm"]
    assert ev[0][1:] == pytest.approx((10.001, 10.001 + 5e-6))


@pytest.mark.parametrize("kept", ["start", "end", "none"])
def test_trace_without_both_markers_is_refused(kept):
    with pytest.raises(RuntimeError, match="marker"):
        devtrace.clip(_ops(kept), 10.0, 14.0)
