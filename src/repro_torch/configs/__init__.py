"""Architecture registry of the port: ``--arch <id>`` resolution, and
the paper's own benchmark layers.

Every arch of ``repro.configs`` is registered, each module's ``CONFIG``
and ``reduced()`` equal to the reference's: the four dense attention
decoders (granite-3-8b, glm4-9b, granite-34b, gemma2-9b), the MoE
decoders (phi3.5-moe, qwen3-moe), the attention-free Mamba-2 SSD stack
(mamba2-780m), the RG-LRU + local-attention hybrid (recurrentgemma-9b),
the encoder-decoder (seamless-m4t-medium) and the vision-prefix decoder
(phi-3-vision).

``SHAPES`` maps a shape id to (seq_len, global_batch, kind) and
``cells()`` yields every valid (arch, shape) dry-run cell, equal to
``repro.configs``' (``long_500k`` only for the sub-quadratic archs).

``PAPER_LAYERS`` are the paper's Table-4 problems (the five conv layers
in output-space X, Y and the two fully connected ones as batch-16
GEMMs), equal to ``repro.configs.PAPER_LAYERS``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (gemma2_9b, glm4_9b, granite_3_8b,
                                 granite_34b, mamba2_780m, phi3_vision,
                                 phi35_moe, qwen3_moe_235b,
                                 recurrentgemma_9b, seamless_m4t_medium)
from repro_torch.core.loopnest import Problem
from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-3-8b": granite_3_8b,
    "glm4-9b": glm4_9b,
    "granite-34b": granite_34b,
    "gemma2-9b": gemma2_9b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "seamless-m4t-medium": seamless_m4t_medium,
    "mamba2-780m": mamba2_780m,
    "recurrentgemma-9b": recurrentgemma_9b,
    "phi-3-vision-4.2b": phi3_vision,
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{sorted(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def long_context_ok(cfg: ModelConfig) -> bool:
    """long_500k runs only for the sub-quadratic archs."""
    return cfg.supports_long_context


def cells() -> list[tuple[str, str]]:
    """All valid (arch, shape) dry-run cells."""
    out = []
    for arch, cfg in ARCHS.items():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not long_context_ok(cfg):
                continue
            out.append((arch, shape.name))
    return out


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
