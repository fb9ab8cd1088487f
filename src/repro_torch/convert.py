"""Parameters from the JAX package's tree, for holding the port against it.

The caller maps the JAX param tree to numpy arrays (``np.asarray`` on
every leaf); this module imports no JAX.  The JAX tree stacks each
pattern entry's layers under ``params["layers"][j]`` with a leading
group axis and keeps the remainder under ``params["tail"]``; the port
keeps one entry per layer, in execution order (group by group, each
cycling through the pattern, then the tail).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.base import map_tree
from repro_torch.models.config import ModelConfig
from repro_torch.util import resolve_device


def _unstack(tree: Any, i: int) -> Any:
    return map_tree(lambda a: a[i], tree)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a numpy-mapped JAX param tree, on
    ``device`` in ``cfg.dtype`` (numpy has no bfloat16: map bf16 leaves
    to float32 first, and they are cast back here)."""
    dev = resolve_device(device)
    pattern = cfg.layer_pattern
    n_groups = cfg.n_layers // len(pattern)
    layers = [_unstack(tree["layers"][j], g)
              for g in range(n_groups) for j in range(len(pattern))]
    layers += list(tree.get("tail", []))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, "
                         f"{cfg.name} has {cfg.n_layers}")
    out = {k: v for k, v in tree.items() if k not in ("layers", "tail")}
    out["layers"] = layers
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(
        dev, cfg.dtype), out)
