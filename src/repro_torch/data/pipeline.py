"""Deterministic, stateless-seekable synthetic data pipeline (the port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step): after a restart the
pipeline resumes at exactly the same batch, so checkpoint/restart
reproduces the optimizer trajectory.  :class:`TokenStream` is a copy of
the JAX package's (numpy only), so the same (seed, step) gives the same
tokens in both packages; :func:`make_batch` hands them over as tensors
on a device.

The token stream is a mixture of structured sequences (markov chains
with noise) rather than iid noise, so small models have something
learnable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.util import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenStream:
    """Seekable synthetic LM stream: markov chains + copy patterns."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.default_rng(dc.seed)
        v = dc.vocab
        # a sparse markov transition table: each token has 4 likely
        # successors
        self.successors = rng.integers(0, v, size=(v, 4), dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        """Pure function of step: {tokens, labels} as numpy arrays."""
        dc = self.dc
        rng = np.random.default_rng((dc.seed << 32) ^ step)
        b, s, v = dc.global_batch, dc.seq_len, dc.vocab
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choice = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, v, size=(b, s), dtype=np.int32)
        for t in range(1, s):
            nxt = self.successors[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                                axis=1)
        return {"tokens": toks, "labels": labels}


def make_batch(cfg: ModelConfig, seq_len: int, global_batch: int,
               step: int, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """``{"tokens", "labels"}`` of ``step`` as int32 tensors (JAX's
    dtype) on ``device`` (default ``"cuda"``; raises without a GPU unless
    ``device="cpu"``).  Dense family only: the stub modality inputs of
    the encoder-decoder and prefix families are not ported
    (``ROADMAP.md``, queue 1, item 11)."""
    if cfg.is_encdec or cfg.prefix_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder and multimodal-prefix batches "
            "are not ported yet; see ROADMAP.md, queue 1, item 11")
    dev = resolve_device(device)
    stream = TokenStream(DataConfig(cfg.vocab, seq_len, global_batch, seed))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in stream.batch_at(step).items()}
