"""The program's spans in the benchmark: each device operation paired
with its launch and named by the innermost spans open there, the
arithmetic of the span readers on synthetic readings, and that an
untraced run builds the engine and the train step with no tracer."""

import math

import pytest

from portbench import attribution, span_metrics
from portbench.tests import tiny_cell

T0 = 100.0          # host instant of the start marker's launch
BASE_US = 5_000_000  # the trace's timestamp of that launch


def _kernel(name, us, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": BASE_US + us,
            "dur": dur, "args": {"correlation": corr}}


def _launch(us, corr, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": BASE_US + us,
            "dur": 3, "args": {"correlation": corr}}


def _trace(tie_launch=True):
    ev = [_kernel("void spin_kernel(long)", 10, 2, 1),
          _kernel("gemm", 100_000, 1000, 2),
          _launch(50_000, 2),
          _kernel("attn", 200_000, 500, 3),
          _launch(60_000, 3, "cuda_driver", "cuLaunchKernelEx"),
          _kernel("adam", 300_000, 100, 4),           # its launch is lost
          _kernel("Memcpy DtoH", 400_000, 50, 5, "gpu_memcpy"),
          _launch(390_000, 5, name="cudaMemcpyAsync"),
          _kernel("void spin_kernel(long)", 1_000_000, 2, 6),
          {"ph": "i", "cat": "cuda_runtime", "name": "x", "ts": BASE_US}]
    if tie_launch:
        ev.append(_launch(0, 1))
    return ev


HARNESS = [("step", 100.04, 100.2), ("submit", 100.3, 100.35)]
PROGRAM = [("dispatch.join", 100.045, 100.055, {"rid": 3}),
           ("step", 100.041, 100.19, {"step": 0}),
           ("dispatch.prefill", 100.058, 100.07, {"rid": 4})]


def test_each_operation_lands_in_the_innermost_span_at_its_launch():
    ops = attribution.attribute(_trace(), T0, HARNESS, PROGRAM)
    got = [(o.name, o.label, o.args) for o in ops]
    assert got == [("gemm", "step/dispatch.join", {"rid": 3}),
                   ("attn", "step/dispatch.prefill", {"rid": 4}),
                   ("adam", "untraced", None),
                   ("Memcpy DtoH", "untraced", None)]
    gemm, attn, adam, copy = ops
    assert gemm.launch == pytest.approx(100.05)
    assert (gemm.start, gemm.end) == (pytest.approx(100.1),
                                      pytest.approx(100.101))
    assert attn.launch == pytest.approx(100.06) and adam.launch is None
    sh = attribution.shares(ops, 100.0, 101.0)
    assert sh["device_s"] == pytest.approx(1.65e-3)
    assert sh["matched"] == pytest.approx(1.55 / 1.65)
    assert sh["outside"] == pytest.approx(0.05 / 1.65)
    assert attribution.by_rid(ops, span_metrics.PREFILL_SPANS) == {
        3: pytest.approx(1e-3), 4: pytest.approx(5e-4)}


def test_clock_tied_by_the_marker_kernel_without_its_launch():
    ops = attribution.attribute(_trace(tie_launch=False), T0, HARNESS,
                                PROGRAM)
    # the marker ran 10 us after its launch: every instant moves by that
    assert ops[0].launch == pytest.approx(100.05 - 1e-5)
    assert ops[0].label == "step/dispatch.join"


def test_a_trace_without_both_markers_is_refused():
    with pytest.raises(RuntimeError, match="1 of its 2 marker"):
        attribution.attribute(_trace()[1:], T0, HARNESS, PROGRAM)


def test_innermost_of_nested_spans():
    spans = [("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0),
             ("d", 5.0, 6.0)]
    times = [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 11.0]
    assert attribution.innermost(spans, times) == [0, 1, 2, 1, 0, 3, None]


def test_breakdown_names_gaps_by_span_path():
    ev = [("gemm", 0.0, 1.0), ("gemm", 2.0, 3.0)]
    prog = [("readback", 1.2, 1.9, None)]
    b = attribution.breakdown(ev, [("step", 0.0, 3.5)], prog, 0.0, 5.0)
    assert b["device_ops"] == [["gemm", 2.0]]
    assert b["idle_gaps"] == [["untraced", 2.0], ["step/readback", 1.0]]


def _op(label, start, end, rid=None):
    return attribution.Op("k", start, end, start,
                          label, None if rid is None else {"rid": rid})


def _serve_readings(ok=(True, True)):
    ops = [_op("step/dispatch.join", 1.0, 1.1, 0),
           _op("step/dispatch.prefill", 1.1, 1.6, 1),
           _op("step/dispatch.prefill", 1.6, 1.7, 1),
           _op("step/dispatch.decode", 1.7, 1.8, 1),
           _op("step/readback", 1.8, 1.81)]
    reqs = [{"rid": 0, "ok": ok[0], "t_admit": 0.9, "t_first_token": 1.2},
            {"rid": 1, "ok": ok[1], "t_admit": 1.0, "t_first_token": 1.9}]
    return {"ops": ops, "requests": reqs, "unsent": 0, "window": (0.0, 2.0),
            "busy_s": 0.81}


def test_prefill_readers():
    r = _serve_readings()
    # request 0: 100 ms of its own, 300 - 100 blocked; request 1: 600 ms
    # of its own (the decode span is not its prefill), 900 - 600 blocked
    assert span_metrics.prefill_device_p90_ms(r) == pytest.approx(
        100 + 0.9 * 500)
    assert span_metrics.prefill_blocked_p90_ms(r) == pytest.approx(
        200 + 0.9 * 100)


def test_a_miss_gives_none():
    for ok in ((True, False), (False, True)):
        r = _serve_readings(ok)
        assert span_metrics.prefill_device_p90_ms(r) is None
        assert span_metrics.prefill_blocked_p90_ms(r) is None
    r = dict(_serve_readings(), unsent=1)
    assert span_metrics.prefill_blocked_p90_ms(r) is None
    r = _serve_readings()
    r["requests"][1]["t_first_token"] = None
    assert span_metrics.prefill_device_p90_ms(r) is None


def test_optimizer_share():
    ops = [_op("train_step/fwd_bwd", 0.0, 3.0),
           _op("train_step/optimizer", 3.0, 4.5),
           _op("train_step/optimizer", 4.5, 6.0)]
    r = {"ops": ops, "window": (1.0, 5.0), "busy_s": 4.0}
    # inside the window: 2 s of fwd_bwd, 1.5 + 0.5 s of optimizer
    assert span_metrics.optimizer_pct(r) == pytest.approx(50.0)
    assert span_metrics.optimizer_pct(dict(r, ops=ops[:1])) is None


def test_readers_find_nothing_in_readings_without_spans():
    bare = {"events": [], "window_s": 1.0, "busy_s": 0.5,
            "queue_waits_ms": [1.0]}
    for read in (span_metrics.prefill_device_p90_ms,
                 span_metrics.prefill_blocked_p90_ms,
                 span_metrics.optimizer_pct):
        assert read(bare) is None and read(None) is None


@pytest.mark.parametrize("cell", ["granite-3-8b.prefill-pool",
                                  "granite-3-8b.train4k"])
def test_untraced_run_attaches_no_tracer(cell, monkeypatch):
    """An untraced run builds the engine with no tracer and no fence,
    and the train step with no ``obs``: the measured path is the one a
    program with no tracing would run."""
    from repro_torch.serve import engine
    from repro_torch.train import loop
    seen = []
    init, make = engine.PagedEngine.__init__, loop.make_train_step

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        seen.append(("engine", self.obs.tracer, self.obs.fence))

    def recording_make(*a, **k):
        seen.append(("step", k.get("obs", a[4] if len(a) > 4 else None)))
        return make(*a, **k)
    monkeypatch.setattr(engine.PagedEngine, "__init__", recording_init)
    monkeypatch.setattr(loop, "make_train_step", recording_make)
    out = tiny_cell.run(cell, 5)
    assert out.correct and out.readings is None
    want = (("engine", None, False) if cell.endswith("pool")
            else ("step", None))
    assert seen == [want]
    assert math.isfinite(next(iter(out.e2e.values())))
