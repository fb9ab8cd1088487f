"""One run of one cell: set-up, the measured window, the check that the
window's outputs are correct, and the result's last line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is found by its name in ``BENCHMARK.json`` (at the
checkout's root): a configuration in ``configs/<config>.json``, a mix's
parameters in ``mixes/<traffic>.json``, the driver the mix names in
``drivers/<driver>.py``, a cell's limits in ``workloads/<cell>.json``
and each per-layer metric's reader in ``metrics/<metric>.py``.

A driver's ``run(ctx)`` returns a :class:`Outcome`; the harness turns it
into the line.  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """One number the verdict compares, with its limit: correct while
    ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict                      # end-to-end values by name
    checks: list                   # of Check
    memory_peak_bytes: int
    readings: object = None        # what the per-layer readers read
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


@dataclasses.dataclass
class Context:
    cell: str
    mix: dict                      # the traffic mix's parameters
    config: dict                   # the configuration file
    limits: dict                   # the cell's limits, by check
    seed: int
    seconds: float
    trace: bool
    device: object                 # torch.device
    t_start: float                 # perf_counter at process start
    control: bool = False          # also read the control (calibration)


def sync(dev) -> None:
    """Wait for the card's queued work (a CPU device has none)."""
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, cell: str) -> tuple[dict, dict, dict, int]:
    """The cell's (mix, configuration, limits, chips)."""
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    mix = load_json(HERE / "mixes" / f"{entry['traffic']}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    limits = load_json(HERE / "workloads" / f"{cell}.json")["limits"]
    return mix, config, limits, int(entry["chips"])


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those that list it, or list no cells and move (or are) a metric the
    cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or
            ("workloads" not in m and m["moves"] in names)]


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (by default the
    process's), each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(torch, dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": peak}


def line(ctx: Context, bench: dict, out: Outcome, info: dict) -> dict:
    """The result's last line; ``checks`` comes last."""
    if ctx.trace:
        metrics = {}
        for m in metrics_of(bench, ctx.cell, "per_layer"):
            value = load_module("metrics", m["name"]).read(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info = dict(info, busy_s=out.busy_s, window_s=out.window_s)
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, ctx.cell, "end_to_end")}
    res = {"correct": out.correct, "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": info}
    if ctx.trace and out.breakdown is not None:
        res["breakdown"] = out.breakdown
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    return res


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        return fail(f"BENCHMARK.json has no cell {args.workload!r}")
    mix, config, limits, chips = cell_files(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} cards, "
                    f"{torch.cuda.device_count()} present")
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = Context(args.workload, mix, config, limits, args.seed,
                  args.seconds, bool(args.trace), dev, t_start)
    driver = load_module("drivers", mix["driver"])
    with contextlib.redirect_stdout(sys.stderr):
        out = driver.run(ctx)
    found = forbidden_modules()
    if found:
        return fail(f"the run loaded {', '.join(found)}: the benchmark "
                    "measures the PyTorch package alone")
    res = line(ctx, bench, out,
               device_info(torch, dev, chips, out.memory_peak_bytes))
    print(f"portbench: end to end {out.e2e}; readings {out.extra}",
          file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


def configure_env() -> None:
    """Caches at fixed paths inside the checkout, before torch loads."""
    out = HERE / "out"
    out.mkdir(exist_ok=True)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(out / "schedules.json")
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
