"""The one generator of the benchmark's traffic, driven by a mix's data.

A mix (the ``traffic`` object of a cell's file) gives its parameters:

* ``"open_loop"``: requests arrive on a schedule whatever the system
  does.  ``rate_per_s`` is the mean arrival rate, ``prompt`` the length
  distribution, ``max_new_tokens`` the output of each request.  A
  length distribution is ``"lognormal"`` by ``median`` and ``sigma``,
  clipped to ``min``..``max``; or ``"maxent"`` by ``mean`` on
  ``min``..``max``: of all the distributions on that range with that
  mean, the one of greatest entropy (density proportional to
  exp(lambda x)), which assumes nothing of the lengths beyond the range
  and a published mean.
* ``"train_batches"``: back-to-back steps of ``batch`` rows of
  ``seq_len`` tokens (and their next-token labels).

An open loop's sizes and gaps between arrivals are the distributions'
evenly spaced quantiles, in an order that the mix's own
``schedule_seed`` decides: a trace drawn once and replayed.  The run's
seed draws the token ids (and the benchmark's weights).  So the work of
a run, and when each part of it arrives, does not change with the
seed: near the knee a tail percentile moves by tens of percent with the
order of the long requests alone, far more than between two runs of
one order.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one stream of a run (any seed that fits a
    Python int: large seeds are folded in whole, not cut)."""
    return np.random.default_rng([stream, seed % (1 << 63), seed >> 63])


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _maxent_rate(mean: float, lo: float, hi: float) -> float:
    """lambda of the density proportional to exp(lambda x) on [lo, hi]
    whose mean is ``mean`` (bisection; the mean rises with lambda)."""
    span, want = hi - lo, mean - lo
    if not 0 < want < span:
        raise ValueError(f"mean {mean} outside ({lo}, {hi})")

    def mean_of(lam: float) -> float:
        if abs(lam * span) < 1e-9:
            return span / 2
        return span / -math.expm1(-lam * span) - 1 / lam
    a, b = -50.0 / span, 50.0 / span
    for _ in range(200):
        mid = (a + b) / 2
        a, b = (mid, b) if mean_of(mid) < want else (a, mid)
    return (a + b) / 2


def lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the evenly spaced quantiles of ``spec``'s
    distribution, clipped, ascending."""
    p = _quantiles(n)
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(q)) for q in p])
        raw = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "maxent":
        lo, hi = spec["min"], spec["max"]
        lam = _maxent_rate(spec["mean"], lo, hi)
        raw = lo + np.log1p(p * math.expm1(lam * (hi - lo))) / lam
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass
class Arrivals:
    """An open loop's requests: due times (s from the window's start,
    ascending), prompt lengths and prompts, ``max_new_tokens`` each."""
    due_s: np.ndarray
    prompt_lens: np.ndarray
    prompts: list
    max_new_tokens: int


def open_loop(mix: dict, seconds: float, seed: int, vocab: int) -> Arrivals:
    """The requests due in a window of ``seconds``: round(rate x seconds)
    of them, the gaps the exponential distribution's quantiles scaled to
    fill the window, sizes and gaps in the order of the mix's
    ``schedule_seed``, token ids from ``seed``."""
    n = max(1, round(mix["rate_per_s"] * seconds))
    g = rng(mix["schedule_seed"], 1)
    gaps = -np.log(1.0 - _quantiles(n))
    gaps *= seconds / gaps.sum()
    order = g.permutation(gaps)
    # request i arrives after the first i gaps, the whole schedule moved
    # on by half the shortest gap: the last gap runs to the window's end
    due = np.concatenate([[0.0], np.cumsum(order)[:-1]]) + gaps.min() * 0.5
    lens = g.permutation(lengths(mix["prompt"], n))
    ids = rng(seed, 1)
    prompts = [ids.integers(0, vocab, size=int(n_), dtype=np.int32)
               for n_ in lens]
    return Arrivals(due, lens, prompts, int(mix["max_new_tokens"]))


def prompts_of(lens, seed: int, vocab: int) -> list:
    """Prompts of the given lengths (the warm-up's), ids from the seed."""
    g = rng(seed, 2)
    return [g.integers(0, vocab, size=int(n), dtype=np.int32) for n in lens]


def batch_rows(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s (batch, seq_len + 1) token rows, drawn on
    ``device`` (no host round trip in the window): the step's tokens are
    ``rows[:, :-1]``, its labels ``rows[:, 1:]``.  No two steps or rows
    share a draw."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, 1000 + step).integers(1 << 62)))
    return torch.randint(0, vocab, (mix["batch"], mix["seq_len"] + 1),
                         generator=g, device=device)
