"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, so a changed source
rebuilds and an unchanged one loads as it is.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for all of them.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("conv2d_blocked", "conv2d_wgrad", "flash_attention",
           "flash_attention_bwd", "flash_decode", "flash_decode_fp8",
           "flash_decode_oproj", "matmul_blocked", "matmul_blocked_mma",
           "matmul_bwd", "matmul_fused", "matmul_fused_mma", "matmul_w8",
           "matmul_w8_mma", "qkv_fused", "qkv_fused_mma")
# <row>_mma is kernel rows 6, 9, 10 and 11's "mma" instance (bf16, M > 16),
# apart from <row> (its "fma" and "mma_t" instances) only so that the two
# compile in parallel; its symbols carry the library's name
# --split-compile 0: the optimizer runs over a library's kernels on all
# cores, so a library with many template instances does not serialise
# the parallel build
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

_LOCK = threading.Lock()
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources' hash."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None and os.path.exists(
            os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each compiled
    source's ``ptxas`` report (registers, shared memory, spills); raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not library_path(n).exists() for n in names) \
        else None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built on first
    use), with its argument types declared and ``cudaError_t`` as the
    return type."""
    key = (name, symbol)
    with _LOCK:
        if key not in _FUNCS:
            build([name])
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
        return _FUNCS[key]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
