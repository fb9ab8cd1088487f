"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the archs the port runs are registered.  Every other arch of
``repro.configs`` raises with a pointer to ``ROADMAP.md`` (queue 1, item
11: the other arch families).
"""

from __future__ import annotations

from repro_torch.configs import granite_3_8b
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
