"""Fault-tolerant checkpointing of the port's trees (the port of
``repro.train.checkpoint``): save/restore with atomic commit, content
hashing and automatic latest-valid resolution.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (the leaves'
path keys, dtypes and shapes, and the sha256 of the array payload).  A
checkpoint becomes visible only once its directory is renamed into place
(write-tmp + rename is atomic on POSIX), so a crash mid-save never leaves
a checkpoint that :func:`latest_valid` would pick; restore verifies the
hash.  Path keys are the port's own (``['params']['layers'][0]...``):
a JAX checkpoint, whose layers are stacked, does not load here.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path key, leaf) pairs in tree order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _to_numpy(x: Any) -> np.ndarray:
    """A leaf on the host; bf16 (which numpy lacks) as fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    return _to_numpy(tree)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save; prunes old checkpoints beyond ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    pairs = [(k, _to_numpy(v)) for k, v in _flatten(tree)]
    buf = io.BytesIO()
    np.savez(buf, **dict(pairs))
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest()
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(payload)
    manifest = {"step": step, "sha256": digest,
                "keys": [k for k, _ in pairs],
                "dtypes": [str(v.dtype) for _, v in pairs],
                "shapes": [list(v.shape) for _, v in pairs]}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _prune(ckpt_dir, keep)
    return final


_async_thread: threading.Thread | None = None


def save_async(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> None:
    """Double-buffered async save: the device-to-host copy happens now,
    the disk write on a background thread (training continues)."""
    global _async_thread
    host_tree = _host_tree(tree)
    if _async_thread is not None:
        _async_thread.join()
    _async_thread = threading.Thread(
        target=save, args=(ckpt_dir, step, host_tree, keep), daemon=True)
    _async_thread.start()


def wait_async() -> None:
    global _async_thread
    if _async_thread is not None:
        _async_thread.join()
        _async_thread = None


def _prune(ckpt_dir: str, keep: int) -> None:
    for s in sorted(_list_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name,
                                           "manifest.json")):
                out.append(int(name[5:]))
    return out


def _verify(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            payload = f.read()
        return hashlib.sha256(payload).hexdigest() == manifest["sha256"]
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def latest_valid(ckpt_dir: str) -> int | None:
    """Newest checkpoint that passes hash verification."""
    for s in sorted(_list_steps(ckpt_dir), reverse=True):
        if _verify(os.path.join(ckpt_dir, f"step_{s:08d}")):
            return s
    return None


def restore(ckpt_dir: str, template: Any,
            step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``template``, each leaf in its
    template's dtype and on its device.  ``step=None``: the newest valid
    checkpoint.  A leaf whose shape changed (an elastic re-slice) is
    zero-padded or cropped along each axis, as in JAX."""
    if step is None:
        step = latest_valid(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _verify(path):
        raise IOError(f"checkpoint {path} failed hash verification")
    data = np.load(os.path.join(path, "arrays.npz"))
    values = []
    for key, tmpl in _flatten(template):
        arr = data[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            arr = _reshape_like(arr, tuple(tmpl.shape))
        values.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=tmpl.device, dtype=tmpl.dtype))
    it = iter(values)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, list):
            return [rebuild(v) for v in t]
        return next(it)
    return rebuild(template), step


def _reshape_like(arr: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Pad/crop each axis (elastic mesh re-slice support)."""
    if arr.ndim != len(shape):
        return np.zeros(shape, arr.dtype)
    slices = tuple(slice(0, min(a, b)) for a, b in zip(arr.shape, shape))
    out = np.zeros(shape, arr.dtype)
    out[slices] = arr[slices]
    return out
