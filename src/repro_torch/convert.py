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

from repro_torch.models.base import ParamDef, map_tree
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


def _leaf_defs(cfg: ModelConfig, model_ax: int) -> Any:
    """The port's parameter tree at ``model_ax`` with each leaf's
    ParamDef (``transformer.model_defs``): its shape, and its dtype,
    ``cfg.dtype`` or fp32 where a leaf asks for it (SSD's ``A_log``,
    ``D``, ``dt_bias``; RG-LRU's ``lam``), as JAX's ``retype_defs``
    leaves them."""
    from repro_torch.models.transformer import model_defs
    return model_defs(cfg, model_ax)


def _with_defs(tree: Any, defs: Any, fn) -> Any:
    """``fn(leaf, def)`` on every leaf of ``tree`` (a quantized leaf
    ``{"q", "scale"}`` whole), ``def`` from the parallel ``defs`` tree
    (``None`` where it has no such leaf)."""
    if _is_quantized(tree):
        return fn(tree, None)
    if isinstance(tree, dict):
        sub = defs if isinstance(defs, dict) else {}
        return {k: _with_defs(v, sub.get(k), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        sub = defs if isinstance(defs, list) else []
        return [_with_defs(v, sub[i] if i < len(sub) else None, fn)
                for i, v in enumerate(tree)]
    return fn(tree, defs if isinstance(defs, ParamDef) else None)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: str | torch.device = "cuda",
                      model_ax: int | None = None) -> dict:
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

    ``model_ax``: the JAX tree was built at that model axis (its
    embedding and ``lm_head`` padded to ``16 * model_ax``); every leaf
    must then have the shape of the port's ``model_defs(cfg,
    model_ax)``, or this raises.
    """
    dev = resolve_device(device)

    def leaf(a: Any, d: ParamDef | None):
        if _is_quantized(a):
            return QuantizedTensor(_tensor(a["q"], dev),
                                   _tensor(a["scale"], dev).float())
        if model_ax is not None and (d is None or tuple(np.shape(a)) !=
                                     tuple(d.shape)):
            raise ValueError(f"leaf of shape {np.shape(a)} is not the "
                             f"model_ax={model_ax} tree's "
                             f"{None if d is None else d.shape}")
        return _tensor(a, dev).to(d.dtype if d is not None else cfg.dtype)
    return _with_defs(_per_layer(cfg, tree), _leaf_defs(cfg, model_ax or 1),
                      leaf)


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
