#!/usr/bin/env python3
"""Time kernels of two checkouts of this repository in turns, on one GPU:
the way to tell a kernel's change from the card's run-to-run spread.

    python3 ab_kernels.py PARENT_DIR CHANGE_DIR [--page P] FUNCTION...

FUNCTION names one of ``chip_smoke.py``'s phase-8 timing functions
(``time_kernels``, ``time_fused_kernels``, ``time_quant_kernels``,
``time_conv_layers``, ``time_attention_passes``, ...): each checkout runs
its own.  A function's arguments are filled by name: ``cfg`` is
granite-3-8b, ``lens`` phase 5's prompt lengths from ``--seed``, ``page``
the decode page (``--page``), and every ``launches*`` a count of zero.
One that needs an earlier phase's result (``time_train_kernels``,
``time_conv_kernels``) is refused.  The name ``outputs`` is this
script's own: the sha256 of the outputs of kernels that a change must
leave bit for bit as they were (row 3 and the fp32 instances of rows 1
and 4, fp32 and bf16, at seeded inputs through each checkout's own
modules), so two checkouts' lines can be compared.

Runs PARENT, CHANGE, CHANGE, PARENT, each in a process of its own that
builds the kernels from its checkout's sources (one ``nvcc`` each, all
at once) and imports that checkout's ``chip_smoke.py``.  Each run prints
what the functions print, then one line a returned row: its name, shape
and ``ms`` (the median of 50 launches after an L2 flush,
``chip_smoke.time_ms``), or ``outputs``' ``sha256``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import subprocess
import sys
import time


def outputs(page: int) -> list[dict]:
    """Digests of outputs that must not change: ``flash_decode_oproj``
    (bf16, fp32; phase 8's decode shape, a windowed, capped one and 20
    batch rows, the 16-row groups),
    ``flash_attention`` in fp32 (the CUDA-core instance) and bf16, and
    ``flash_decode`` in fp32 (``attn_rows``), decode and chunk."""
    import hashlib

    import chip_smoke as C
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    dev = torch.device("cuda")
    lens = [194, 147, 316, 88, 301, 57, 209, 197]
    rows = []

    def digest(name, t):
        torch.cuda.synchronize()
        h = hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                           .tobytes()).hexdigest()[:16]
        rows.append({"name": name, "sha256": h})
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        args = C.oproj_inputs(dev, dtype, lens, seed=8, page=page)
        digest(f"flash_decode_oproj {dn}", FD.flash_decode_oproj(*args))
        wide = C.oproj_inputs(dev, dtype, lens * 2 + lens[:4], seed=20,
                              page=page)
        digest(f"flash_decode_oproj {dn} B=20",
               FD.flash_decode_oproj(*wide))
        digest(f"flash_decode_oproj {dn} window 37 cap 30",
               FD.flash_decode_oproj(*args, window=37, logit_cap=30.0))
        q, k, v = C.dense_inputs(dev, dtype, 2, 200, 200, seed=3)
        digest(f"flash_attention {dn}", FA.flash_attention(q, k, v))
    f32 = torch.float32
    for q_span, ln in ((1, lens), (64, [129])):
        args = C.paged_inputs(dev, f32, ln, q_span, seed=5, page=page,
                              n_blocks=-(-512 // page))
        digest(f"flash_decode float32 q_span={q_span}",
               FD.flash_decode(*args, q_span=q_span))
    return rows


def one(root: str, names: list[str], page: int, seed: int) -> None:
    """Build the kernels of the checkout at ``root`` and run its
    ``chip_smoke`` functions ``names``."""
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/src")
    import chip_smoke as C
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    cfg = get_config("granite-3-8b")
    rng = np.random.default_rng(seed)       # chip_smoke.full_model's draws
    for n in (20, 100):
        rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
    lens = rng.integers(16, 301, 16)
    given = {"cfg": cfg, "lens": lens, "page": page}
    calls = []
    for name in names:
        if name == "outputs":
            calls.append((name, outputs, {"page": page}))
            continue
        fn, kw = getattr(C, name), {}
        for p in inspect.signature(fn).parameters:
            if p.startswith("launches"):
                kw[p] = collections.defaultdict(int)
            elif p in given:
                kw[p] = given[p]
            else:
                raise SystemExit(f"ab_kernels: {name} needs {p!r}, the "
                                 "result of an earlier chip_smoke phase")
        calls.append((name, fn, kw))
    t0 = time.perf_counter()
    _build.build()
    print(f"== {root}: built in {time.perf_counter() - t0:.0f}s", flush=True)
    for name, fn, kw in calls:
        out = fn(**kw)
        rows = out if isinstance(out, list) else [
            {"name": k, "ms": v} for k, v in out.items()]
        for r in rows:
            if "sha256" in r:
                value = f"sha256 {r['sha256']}"
            else:
                ms = r["ms"] if isinstance(r["ms"], (int, float)) \
                    else json.dumps(r["ms"])
                value = f"ms {ms}"
            print(f"== {root}: {name}: {r['name']} [{r.get('shape', '')}] "
                  f"{value}", flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        root, page, seed, *names = sys.argv[2:]
        one(root, names, int(page), int(seed))
        return 0
    ap = argparse.ArgumentParser(
        description="Time chip_smoke.py's phase-8 functions of two "
                    "checkouts in turns: parent, change, change, parent.")
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("functions", nargs="+")
    ap.add_argument("--page", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in (args.parent, args.change, args.change, args.parent):
        rc = subprocess.run([sys.executable, __file__, "--one", root,
                             str(args.page), str(args.seed),
                             *args.functions]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
