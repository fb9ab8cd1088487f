"""Parameters from the JAX package's tree, for holding the port against it.

The caller maps the JAX param tree to numpy arrays (``np.asarray`` on
every leaf); this module imports no JAX.  The JAX tree stacks each
pattern entry's layers under ``params["layers"][j]`` with a leading
group axis and keeps the remainder under ``params["tail"]``; the port
keeps one entry per layer, in execution order (group by group, each
cycling through the pattern, then the tail).  An encoder-decoder's
encoder is one stack over ``encoder_layers`` with no tail
(``params["encoder"]["layers"]``); the port keeps a list there too.

The conv path needs no conversion: ``ops.conv2d`` keeps JAX's layouts
(activations NHWC, weights HWIO, Table-4 problems in output-space X, Y),
so the same numpy arrays go to both packages unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.base import map_tree
from repro_torch.models.config import ModelConfig
from repro_torch.quant import QuantizedTensor
from repro_torch.util import resolve_device


def _unstack(tree: Any, i: int) -> Any:
    return map_tree(lambda a: a[i], tree)


def _is_quantized(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def _per_layer(cfg: ModelConfig, tree: dict) -> dict:
    """The JAX tree's stacked groups and tail as one entry per layer."""
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
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {**enc, "layers": [
            _unstack(enc["layers"], g) for g in range(cfg.encoder_layers)]}
    return out


def _leaf_dtypes(cfg: ModelConfig) -> Any:
    """The port's parameter tree with each leaf's dtype
    (``transformer.model_defs``): ``cfg.dtype``, or fp32 where a leaf
    asks for it (SSD's ``A_log``, ``D``, ``dt_bias``; RG-LRU's
    ``lam``), as JAX's ``retype_defs`` leaves them."""
    from repro_torch.models.transformer import model_defs
    return map_tree(lambda d: d.dtype, model_defs(cfg))


def _with_dtypes(tree: Any, dtypes: Any, fn) -> Any:
    """``fn(leaf, dtype)`` on every leaf of ``tree`` (a quantized leaf
    ``{"q", "scale"}`` whole), ``dtype`` from the parallel ``dtypes``
    tree (``None`` where it has no such leaf)."""
    if _is_quantized(tree):
        return fn(tree, None)
    if isinstance(tree, dict):
        sub = dtypes if isinstance(dtypes, dict) else {}
        return {k: _with_dtypes(v, sub.get(k), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        sub = dtypes if isinstance(dtypes, list) else []
        return [_with_dtypes(v, sub[i] if i < len(sub) else None, fn)
                for i, v in enumerate(tree)]
    return fn(tree, dtypes if isinstance(dtypes, torch.dtype) else None)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a numpy-mapped JAX param tree, on
    ``device``, each leaf in the dtype the port's ``model_defs`` gives it:
    ``cfg.dtype``, or fp32 for the leaves that ask for it (SSD's
    ``A_log``, ``D``, ``dt_bias``; RG-LRU's ``lam``), as in JAX (numpy
    has no bfloat16: map bf16 leaves to float32 first, and they are cast
    back here).

    A quantized leaf is given as ``{"q": payload, "scale": fp32}`` (JAX's
    ``QuantizedTensor`` mapped to numpy; a stacked group's ``(G, K, N)``
    payload and ``(G, 1, N)`` scale are unstacked per layer like every
    leaf) and becomes a :class:`QuantizedTensor` whose payload keeps its
    dtype and whose scale stays fp32: neither is cast to ``cfg.dtype``.
    """
    dev = resolve_device(device)

    def leaf(a: Any, dtype):
        if _is_quantized(a):
            return QuantizedTensor(_tensor(a["q"], dev),
                                   _tensor(a["scale"], dev).float())
        return _tensor(a, dev).to(dtype or cfg.dtype)
    return _with_dtypes(_per_layer(cfg, tree), _leaf_dtypes(cfg), leaf)


def opt_state_from_numpy(cfg: ModelConfig, state: dict,
                         device: str | torch.device = "cuda") -> dict:
    """The port's AdamW state from a numpy-mapped JAX one (``{"mu",
    "nu", "step"}``), so a port step can continue a JAX trajectory.  The
    moments are laid out per layer like the parameters but stay fp32
    whatever ``cfg.dtype`` is, and ``step`` stays an int32 scalar: the
    cast ``params_from_numpy`` applies to every leaf would be wrong
    here."""
    dev = resolve_device(device)
    return {
        "mu": map_tree(lambda a: _tensor(a, dev).float(),
                       _per_layer(cfg, state["mu"])),
        "nu": map_tree(lambda a: _tensor(a, dev).float(),
                       _per_layer(cfg, state["nu"])),
        "step": torch.tensor(int(np.asarray(state["step"])),
                             dtype=torch.int32, device=dev),
    }
