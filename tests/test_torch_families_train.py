"""Port vs JAX: training the other arch families.

For the six archs (phi3.5-moe, qwen3-moe, mamba2-780m, recurrentgemma-9b,
seamless-m4t-medium, phi-3-vision) at their reduced configs in fp32,
weights drawn by JAX: the loss, the MoE aux loss and every gradient leaf
of the port's ``loss_fn`` against ``jax.value_and_grad`` of JAX's, on
``make_batch``'s batch with its stub modality inputs, within 1e-4 abs +
1e-4 rel (``test_torch_archs.py``'s tolerance); remat ``"none"`` and
``"dots"`` give the same gradients bit for bit; one AdamW step with
gradient accumulation over the extras; and ``python -m
repro_torch.launch.train --reduced --device cpu`` for each arch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import transformer as JT
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import loop

FAMILIES = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-780m",
            "recurrentgemma-9b", "seamless-m4t-medium", "phi-3-vision-4.2b")
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@functools.lru_cache(maxsize=None)
def model(arch: str):
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    jparams = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(cfg, to_np(jparams),
                                                 device="cpu")


def port_grads(cfg, params, batch):
    """(total, metrics, grads) of the port's ``loss_fn`` by autograd."""
    flat = [t.detach().clone().requires_grad_() for t in
            adamw.leaves(params)]
    total, metrics = T.loss_fn(cfg, adamw.unflatten(params, flat), batch)
    grads = torch.autograd.grad(total, flat)
    return total, metrics, adamw.unflatten(params, list(grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_grad_leaf_match_jax(arch):
    """One batch of 2 x 16 tokens (and the family's stub inputs) under
    remat "block": the total, the loss, the aux loss, the token count and
    every gradient leaf against ``jax.value_and_grad``."""
    jcfg, jparams, cfg, params = model(arch)
    jbatch = jmake_batch(jcfg, 16, 2, 0)
    batch = make_batch(cfg, 16, 2, 0, device="cpu")

    @functools.partial(jax.jit, static_argnums=0)
    def jgrad(c, p, b):
        return jax.value_and_grad(lambda q: JT.loss_fn(c, q, b),
                                  has_aux=True)(p)
    (total, metrics), jgrads = jgrad(jcfg, jparams, jbatch)
    t_total, t_metrics, grads = port_grads(cfg, params, batch)
    np.testing.assert_allclose(t_total.item(), float(total), **MODEL_TOL)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(t_metrics[key].detach().item(),
                                   float(metrics[key]), **MODEL_TOL)
    if cfg.n_experts:
        assert t_metrics["aux"].item() > 0
    want = params_from_numpy(cfg, to_np(jgrads), device="cpu")
    got_leaves, want_leaves = adamw.leaves(grads), adamw.leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(adamw.leaves(params))
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.float().numpy(), **MODEL_TOL)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-780m",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_dots_remat_gives_the_gradients_of_none(arch):
    """``"dots"`` saves the projections' outputs and recomputes the rest
    (the MoE's batched products, SSD's einsums and the RG-LRU scan
    among them): the same gradients as ``"none"``, bit for bit."""
    _, _, cfg, params = model(arch)
    batch = make_batch(cfg, 16, 2, 1, device="cpu")
    runs = [port_grads(dataclasses.replace(cfg, remat=r), params, batch)[2]
            for r in ("none", "dots")]
    for a, b in zip(*map(adamw.leaves, runs)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "seamless-m4t-medium",
                                  "phi-3-vision-4.2b"])
def test_train_step_with_accumulation_carries_the_extras(arch):
    """``make_train_step`` with ``grad_accum=2`` over a batch of 4 splits
    the stub inputs with the tokens: its update equals the step on the
    mean of the two halves' gradients, and its metrics carry the mean
    loss and aux."""
    _, _, cfg, params = model(arch)
    batch = make_batch(cfg, 8, 4, 2, device="cpu")
    tc = loop.TrainConfig(grad_accum=2)
    new, _, metrics = loop.make_train_step(cfg, tc)(
        params, adamw.init_state(params), batch)
    halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    res = [port_grads(cfg, params, h) for h in halves]
    mean = adamw.unflatten(params, [
        (a + b) / 2 for a, b in zip(adamw.leaves(res[0][2]),
                                    adamw.leaves(res[1][2]))])
    want, _, _ = adamw.apply_updates(tc.opt, params, mean,
                                     adamw.init_state(params))
    for a, b in zip(adamw.leaves(new), adamw.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)
    np.testing.assert_allclose(
        metrics["loss"].item(),
        (res[0][0].item() + res[1][0].item()) / 2, rtol=1e-6)
    np.testing.assert_allclose(
        metrics["aux"].item(),
        (res[0][1]["aux"].item() + res[1][1]["aux"].item()) / 2, rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_runs_each_family(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --reduced
    --device cpu``: two steps, finite losses, the aux loss in the log."""
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--dtype", "float32", "--steps", "2", "--seq-len",
                       "16", "--batch", "2"])
    text = capsys.readouterr().out
    assert "final loss" in text and " aux " in text
    final = float(text.split("final loss: ")[1].split()[0])
    assert np.isfinite(final)
