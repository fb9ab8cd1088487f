"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that patches one function of the
program for as long as it is open.

* ``token``: every sampled token altered where it is produced (serving);
* ``kv_unwritten``: a prefill that leaves the pages as they were, the
  serving state unchanged;
* ``state_unchanged``: an optimizer step that returns its state as it
  got it (training);
* ``half_batch``: the loss over the first half of the batch's rows
  only, the mean taken over those (training).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, fn):
    old = getattr(module, name)
    setattr(module, name, fn(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def token():
    from repro_torch.serve import engine

    def wrap(orig):
        def sample(cfg, logits, temperature, generator):
            return (orig(cfg, logits, temperature, generator) + 1) % cfg.vocab
        return sample
    return _patched(engine, "sample_tokens", wrap)


@contextlib.contextmanager
def kv_unwritten():
    from repro_torch.serve import kv_cache
    with _patched(kv_cache, "write_prefill", lambda _: lambda *a: None), \
            _patched(kv_cache, "_scatter", lambda _: lambda *a: None):
        yield


def state_unchanged():
    from repro_torch.optim import adamw

    def wrap(orig):
        def apply_updates(c, params, grads, state, gnorm=None):
            _, _, metrics = orig(c, params, grads, state, gnorm)
            return params, state, metrics
        return apply_updates
    return _patched(adamw, "apply_updates", wrap)


def half_batch():
    from repro_torch.models import transformer

    def wrap(orig):
        def loss_fn(cfg, params, batch, use_kernel=True):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return orig(cfg, params, half, use_kernel)
        return loss_fn
    return _patched(transformer, "loss_fn", wrap)


FAULTS = {"token": token, "kv_unwritten": kv_unwritten,
          "state_unchanged": state_unchanged, "half_batch": half_batch}
