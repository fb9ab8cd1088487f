"""One traced run of a cell with the program's own tracer attached, and
what its spans show: the device's operations attributed to the spans
open at their launch (``attribution.py``), the span readers
(``span_metrics.py``) and, for the serving cell, each request's time to
first token taken apart.

    python3 portbench/span_probe.py --workload <cell> --seed <n> \\
        --seconds <s> [--out requests.json]

It runs the cell as ``run.py --trace 1`` does, through the cell's own
driver, and adds from outside what the drivers do not do yet: the
serving driver's ``PagedEngine`` and the training driver's
``make_train_step`` get ``Obs(trace=StepTracer(None), fence=False)``,
and the profile's raw events are kept for the launches.  The last line
of standard output is JSON: the run's end-to-end numbers, the cell's
per-layer metrics and the span readers' beside them, the shares of the
sub-window's device time whose launch was found and that fell outside
every harness span, the device time by span path, and the breakdown
with its idle gaps named by span path.  ``--out`` takes every request's
stamps.  Needs a CUDA card.

Temporary: the probe patches the drivers and ``devtrace`` from outside,
and goes, with :func:`attribution.breakdown`, once
``drivers/serve_open.py``, ``drivers/train.py`` and ``devtrace.py``
attach the tracer and name the spans themselves.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

SPAN_READERS = {"prefill_device_p90_ms.ttft": "prefill_device_p90_ms",
                "prefill_blocked_p90_ms.ttft": "prefill_blocked_p90_ms",
                "optimizer_pct.train": "optimizer_pct"}


@dataclasses.dataclass
class Seen:
    """What the hooks keep: profiler windows, harness span lists, the
    serving loop's return."""
    windows: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    served: list = dataclasses.field(default_factory=list)


def _hook(driver, obs, seen: Seen) -> None:
    from portbench import devtrace
    from repro_torch.serve import engine
    from repro_torch.train import loop

    class TracedEngine(engine.PagedEngine):
        def __init__(self, cfg, params, sc, obs_=None):
            super().__init__(cfg, params, sc, obs=obs)
    engine.PagedEngine = TracedEngine
    make = loop.make_train_step
    loop.make_train_step = (lambda cfg, tc, mesh=None, mapping=None, _=None:
                            make(cfg, tc, mesh, mapping, obs=obs))

    window_init, spans_init = devtrace.Window.__init__, devtrace.Spans.__init__

    def w_init(self, torch):
        window_init(self, torch)
        seen.windows.append(self)

    def s_init(self):
        spans_init(self)
        seen.spans.append(self)

    def events(self):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.raw = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        ops = sorted((e for e in self.raw if e.get("ph") == "X"
                      and e.get("cat") in devtrace.DEVICE_CATS),
                     key=lambda e: float(e["ts"]))
        return devtrace.clip(ops, self.t0, self.t1)
    devtrace.Window.__init__, devtrace.Spans.__init__ = w_init, s_init
    devtrace.Window.events = events
    if hasattr(driver, "serve"):
        serve = driver.serve

        def serving(*a, **k):
            got = serve(*a, **k)
            seen.served.append(got)
            return got
        driver.serve = serving


def _s(ns):
    return None if ns is None else ns * 1e-9


def requests(served) -> list[dict]:
    recs, t0 = served[0], served[1]
    out = []
    for rec in recs:
        q = rec.req
        out.append({"rid": q.rid, "n": rec.n, "ok": rec.done is not None
                    and rec.status == "ok", "due": t0 + rec.due,
                    "t_submit": _s(q.t_submit), "t_admit": _s(q.t_admit),
                    "t_first_token": _s(q.t_first_token), "done": rec.done})
    return out


def decomposition(reqs, dev: dict) -> dict:
    """Each finished request's time to first token in parts (ms): due to
    submit (the caller held by the step in flight), queued, its own
    device time, blocked inside the engine, first token to the
    harness's stamp; and the parts of the request at the TTFT p90."""
    from portbench import e2e
    rows = []
    for q in reqs:
        if not q["ok"]:
            continue
        own = dev.get(q["rid"], 0.0)
        rows.append({
            "rid": q["rid"], "n": q["n"],
            "ttft": (q["done"] - q["due"]) * 1e3,
            "held": (q["t_submit"] - q["due"]) * 1e3,
            "queued": (q["t_admit"] - q["t_submit"]) * 1e3,
            "own_device": own * 1e3,
            "blocked": (q["t_first_token"] - q["t_admit"] - own) * 1e3,
            "to_harness": (q["done"] - q["t_first_token"]) * 1e3})
    if not rows:
        return {}
    parts = ("ttft", "held", "queued", "own_device", "blocked",
             "to_harness")
    at = sorted(rows, key=lambda r: r["ttft"])
    p90 = e2e.percentile([r["ttft"] for r in rows], 90)
    near = min(at, key=lambda r: abs(r["ttft"] - p90))
    return {"p50": {k: e2e.percentile([r[k] for r in rows], 50)
                    for k in parts},
            "p90": {k: e2e.percentile([r[k] for r in rows], 90)
                    for k in parts},
            "at_ttft_p90": near,
            "to_harness_range": [min(r["to_harness"] for r in rows),
                                 max(r["to_harness"] for r in rows)],
            "rows": at}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    mix, config, limits, _ = harness.cell_files(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        return harness.fail("no CUDA device")
    from portbench import attribution, span_metrics
    from repro_torch.obs import Obs, StepTracer
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = harness.Context(args.workload, mix, config, limits, args.seed,
                          args.seconds, True, dev, T_START)
    driver = harness.load_module("drivers", mix["driver"])
    obs = Obs(trace=StepTracer(None), fence=False)
    seen = Seen()
    _hook(driver, obs, seen)
    with contextlib.redirect_stdout(sys.stderr):
        out = driver.run(ctx)
    line = harness.line(ctx, bench, out, harness.device_info(
        torch, dev, 1, out.memory_peak_bytes))
    (w,) = seen.windows
    hs = [s for sp in seen.spans for s in sp.items]
    ps = obs.tracer.spans()
    t = time.perf_counter()
    ops = attribution.attribute(w.raw, w.t0, hs, ps)
    r = dict(out.readings, ops=ops, window=(w.t0, w.t1))
    reqs = requests(seen.served[0]) if seen.served else []
    if seen.served:
        r.update(requests=reqs, unsent=out.attempted - len(reqs))
    for name, fn in SPAN_READERS.items():
        v = getattr(span_metrics, fn)(r)
        if v is not None:
            line["metrics"][name] = {"value": v, "unit": (
                "%" if name.startswith("optimizer") else "ms")}
    sh = attribution.shares(ops, w.t0, w.t1)
    by_label: dict[str, float] = {}
    for o, d in attribution.clipped(ops, w.t0, w.t1):
        by_label[o.label] = by_label.get(o.label, 0.0) + d
    line.update(
        e2e=out.e2e, shares=sh, attribution_s=time.perf_counter() - t,
        ops=len(ops), device_s_by_span=dict(sorted(
            by_label.items(), key=lambda kv: -kv[1])),
        breakdown=attribution.breakdown(out.readings["events"], hs, ps,
                                        w.t0, w.t1))
    if reqs:
        dec = decomposition(reqs, attribution.by_rid(
            ops, span_metrics.PREFILL_SPANS))
        rows = dec.pop("rows", [])
        line["ttft_parts_ms"] = dec
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"requests": reqs, "parts": rows}, indent=1))
    print(f"span_probe: launches matched for {sh['matched']!r} of the "
          f"sub-window's device time, {sh['outside']!r} outside every "
          f"harness span", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    harness.configure_env()
    sys.exit(main(sys.argv[1:]))
