"""Random weights made on the device from the run's seed.

The program declares its parameter tree (shapes, init kinds and scales);
the benchmark fills it itself, in the type the weights are served in: one
normal draw over a single flat buffer from a generator on the device,
then one scaling pass for each distinct scale, the leaves being views
of that buffer grouped by scale.  Leaves declared as ones (the norms'
scales) are ones.  The same seed gives the same weights on the same
device, which is how the reference is handed the program's weights.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make(defs, seed: int, device: torch.device) -> dict:
    """The parameter tree of ``defs`` (a tree of declarations with
    ``shape``, ``scale``, ``init`` and ``dtype``) filled from ``seed`` on
    ``device``."""
    leaves = list(_walk(defs))
    normal = [(p, d) for p, d in leaves if d.init == "normal"]
    dtypes = {d.dtype for _, d in normal}
    if len(dtypes) > 1:
        raise ValueError(f"one buffer needs one dtype, got {dtypes}")
    normal.sort(key=lambda pd: pd[1].scale)
    total = sum(int(np.prod(d.shape)) for _, d in normal)
    out = _skeleton(defs)
    if normal:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(traffic.rng(seed, 0).integers(1 << 62)))
        buf = torch.empty(total, dtype=dtypes.pop(), device=device)
        buf.normal_(generator=gen)
        off, start, scale = 0, 0, None
        for path, d in normal:
            if d.scale != scale:
                if scale is not None:
                    buf[start:off].mul_(scale)
                start, scale = off, d.scale
            n = int(np.prod(d.shape))
            _put(out, path, buf[off:off + n].view(d.shape))
            off += n
        buf[start:off].mul_(scale)
    for path, d in leaves:
        if d.init == "normal":
            continue
        fill = torch.ones if d.init == "ones" else torch.zeros
        _put(out, path, fill(d.shape, dtype=d.dtype, device=device))
    return out
