"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each reduced to one number that a limit bounds."""

from __future__ import annotations

import statistics

import torch


def rel_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """||prog - ref|| / ||ref||, in float32."""
    ref = ref.float()
    den = float(torch.linalg.vector_norm(ref))
    num = float(torch.linalg.vector_norm(prog.float() - ref))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def logit_gap(ref_logits: torch.Tensor, token: int, vocab: int) -> float:
    """How far the reference's logit of ``token`` lies below its best
    over the real vocabulary (0 where the token is the reference's
    argmax)."""
    real = ref_logits[:vocab].float()
    return float(real.max() - real[int(token)])


def worst_leaf_gap(prog: list, ref: list, keep: list | None = None) -> float:
    """The largest gap |prog_i - ref_i| between two lists of per-leaf
    norms, each against the larger of ref_i and the median leaf's ref
    norm (some leaves' norms are all but zero); ``keep`` leaves out the
    leaves it marks False."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    worst = 0.0
    for i in idx:
        den = max(ref[i], med)
        gap = abs(prog[i] - ref[i])
        worst = max(worst, gap / den if den > 0 else (
            0.0 if gap == 0 else float("inf")))
    return worst


def worst_leaf_rel_err(prog: list, ref: list,
                       keep: list | None = None) -> float:
    """The largest :func:`rel_err` over the leaves that ``keep`` does not
    mark False, each pair compared on the card where either side is on
    one (the other side is a copy on the host)."""
    def pair(p, r):
        dev = r.device if r.device.type != "cpu" else p.device
        return rel_err(p.to(dev), r.to(dev))
    return max((pair(p, r) for i, (p, r) in enumerate(zip(prog, ref))
                if keep is None or keep[i]), default=0.0)


def moving_leaves(grad_norms: list, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least ``share`` of the median leaf's.  A leaf below that
    (a bias under softmax) moves under Adam by round-off alone."""
    med = statistics.median(grad_norms)
    return [g >= share * med for g in grad_norms]
