"""Production-mesh dry run: every (arch x shape x mesh) cell on meta
tensors over the fake process group (the port of
``repro.launch.dryrun``).

Proves the distribution is coherent without hardware: every rank's
arguments are the local shards of JAX's specs (a spec that does not
split raises), the sharded route runs end to end on meta tensors, and
the collectives it issues are tallied.  One cell runs in a process of
its own: rank 0 of a ``"fake"`` world of the mesh's size (256 or 512),
whose collectives complete without moving data; the sharded route is
SPMD, so rank 0's tally is every rank's.  Artifacts go to
``experiments/dryrun_torch/*.json`` with JAX's fields:

* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: the
  bytes of the rank's arguments and outputs (local shards); the fields
  only a compiler gives (``temp_size_in_bytes``, ``alias_size_in_bytes``,
  ``generated_code_size_in_bytes``) are null;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the whole
  call, every layer (the backward and the recompute under remat
  included), so no 1/2-cycle extrapolation is needed;
* ``collective_bytes``: per rank, per kind (JAX's five), each
  collective's output bytes (``models.spmd.count_collectives``), as
  JAX counts the result of each collective in the partitioned HLO.

Meta tensors have no device, so the cell's functions ask for every
kernel's plain version by name (``use_kernel=False``); the kernels'
CPU/CUDA rule does not change.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES, Shape, cells, get_config
from repro_torch.models.config import ModelConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "dryrun_torch")

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _fake_world(n: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a {dist.get_world_size()}-rank world is "
                               f"initialised; this cell needs {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(cfg: ModelConfig, shape: Shape, mesh_shape: tuple[int, ...],
             names: tuple[str, ...], parallelism: str = "tp_fsdp",
             model_ax: int | None = None, verbose: bool = True) -> dict:
    """One cell on rank 0 of a fake world of ``prod(mesh_shape)`` ranks
    (initialised here if no world is).  ``shape`` need not be one of
    ``SHAPES`` (the tests' small cells)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.launch import shapes as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import spmd
    n = 1
    for k in mesh_shape:
        n *= k
    _fake_world(n)
    mesh = make_mesh(mesh_shape, names, "cpu")
    configs.SHAPES.setdefault(shape.name, shape)
    t0 = time.perf_counter()
    low = S.input_specs(cfg, shape.name, mesh, model_ax=model_ax,
                        parallelism=parallelism)
    with spmd.count_collectives() as coll, \
            FlopCounterMode(display=False) as flops:
        out = low.fn(*low.args_shapes)
    seconds = time.perf_counter() - t0
    mem = {"argument_size_in_bytes": spmd.leaves_bytes(low.args_shapes),
           "output_size_in_bytes": spmd.leaves_bytes(out),
           "temp_size_in_bytes": None, "alias_size_in_bytes": None,
           "generated_code_size_in_bytes": None}
    result = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(map(str, mesh_shape)), "kind": low.kind,
        "parallelism": parallelism, "remat": cfg.remat, "n_devices": n,
        "mapping": {k: list(v) if isinstance(v, tuple) else v
                    for k, v in low.mapping.items()},
        "memory": mem, "run_s": round(seconds, 1), "ok": True,
        # no compiler: JAX's lowering and compile times have no port
        "lower_s": None, "compile_s": None, "analysis_compile_s": None,
        "flops": float(flops.get_total_flops()), "bytes_accessed": None,
        "collective_bytes": dict(coll),
        "collective_bytes_total": sum(coll.values()),
        "analysis_method": "meta tensors, every layer (FlopCounterMode)",
    }
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape.name} x {result['mesh']} "
              f"{parallelism}: flops={result['flops']:.3e} "
              f"coll={result['collective_bytes_total']:.3e} "
              f"args={mem['argument_size_in_bytes']} ({seconds:.1f}s)")
    return result


def artifact_path(arch: str, shape_name: str, multi_pod: bool,
                  parallelism: str = "tp_fsdp") -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    mesh = "2x16x16" if multi_pod else "16x16"
    safe = arch.replace("/", "_").replace(".", "_")
    suffix = "" if parallelism == "tp_fsdp" else f"__{parallelism}"
    return os.path.join(ARTIFACT_DIR,
                        f"{safe}__{shape_name}__{mesh}{suffix}.json")


def _child(arch: str, shape_name: str, multi_pod: bool,
           parallelism: str) -> dict:
    shape, names = PRODUCTION[multi_pod]
    return run_cell(get_config(arch), SHAPES[shape_name], shape, names,
                    parallelism)


def run_and_save(arch: str, shape_name: str, multi_pod: bool,
                 force: bool = False,
                 parallelism: str = "tp_fsdp") -> dict:
    """One production cell in a process of its own; its artifact (an
    ``ok: false`` one with the error where the cell raised)."""
    path = artifact_path(arch, shape_name, multi_pod, parallelism)
    if not force and os.path.exists(path):
        with open(path) as f:
            r = json.load(f)
            if r.get("ok"):
                return r
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--child",
           "--arch", arch, "--shape", shape_name, "--parallelism",
           parallelism, "--multi-pod", "on" if multi_pod else "off",
           "--out", path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        err = proc.stderr.strip().splitlines()
        result = {"arch": arch, "shape": shape_name,
                  "mesh": "2x16x16" if multi_pod else "16x16",
                  "parallelism": parallelism, "ok": False,
                  "error": err[-1] if err else f"exit {proc.returncode}"}
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        return result
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="off")
    ap.add_argument("--parallelism", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        r = _child(args.arch, args.shape, args.multi_pod == "on",
                   args.parallelism)
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
        return

    pods = {"on": [True], "off": [False], "both": [False, True]}[
        args.multi_pod]
    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]
    failures = []
    for arch, shape_name in todo:
        for mp in pods:
            r = run_and_save(arch, shape_name, mp, force=args.force,
                             parallelism=args.parallelism)
            if not r.get("ok"):
                failures.append((arch, shape_name, mp, r.get("error")))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(todo) * len(pods)} cells ran OK")


if __name__ == "__main__":
    main()
