"""Architecture registry of the port: ``--arch <id>`` resolution, and
the paper's own benchmark layers.

Only the archs the port runs are registered.  Every other arch of
``repro.configs`` raises with a pointer to ``ROADMAP.md`` (queue 1, item
11: the other arch families).

``PAPER_LAYERS`` are the paper's Table-4 problems (the five conv layers
in output-space X, Y and the two fully connected ones as batch-16
GEMMs), equal to ``repro.configs.PAPER_LAYERS``.
"""

from __future__ import annotations

from repro_torch.configs import granite_3_8b
from repro_torch.core.loopnest import Problem
from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-3-8b": granite_3_8b,
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported yet (ported: {sorted(_MODULES)}); "
            "see ROADMAP.md, queue 1, item 11")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


# --- the paper's own benchmark layers (Table 4) -----------------------------

PAPER_LAYERS: dict[str, Problem] = {
    "Conv1": Problem(X=256, Y=256, C=256, K=384, Fw=11, Fh=11),
    "Conv2": Problem(X=500, Y=375, C=32, K=48, Fw=9, Fh=9),
    "Conv3": Problem(X=32, Y=32, C=108, K=200, Fw=4, Fh=4),
    "Conv4": Problem(X=56, Y=56, C=128, K=256, Fw=3, Fh=3),
    "Conv5": Problem(X=28, Y=28, C=256, K=512, Fw=3, Fh=3),
    "FC1": Problem.gemm(M=1, N_cols=100, K_reduce=200, batch=16),
    "FC2": Problem.gemm(M=1, N_cols=4096, K_reduce=4096, batch=16),
}
