"""Port vs JAX: training the three dense archs added beside granite-3-8b,
and ``remat="dots"``.

glm4-9b (GQA kv 2), granite-34b (MQA, gelu MLP) and gemma2-9b (local and
global layers, window 8, attention and final logit caps, head_dim 16
apart from d_model) at their reduced configs in fp32, weights drawn by
JAX: the loss and every gradient leaf against ``jax.value_and_grad`` of
JAX's ``loss_fn`` within 1e-4 abs + 1e-4 rel (the same tolerance as
``test_torch_train.py``), under each remat mode JAX has.

``remat="dots"`` is JAX's ``dots_with_no_batch_dims_saveable``: the
outputs of the batch-free matrix products are saved and everything else
is recomputed.  Its gradients equal ``"none"``'s bit for bit, and a
``TorchDispatchMode`` over the backward counts as many ``aten.mm`` calls
as ``"none"`` does (the gradients' own products: nothing recomputed)
while ``"block"`` counts the forward's products again.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import transformer as JT
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ARCHS = ("glm4-9b", "granite-34b", "gemma2-9b")
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@functools.lru_cache(maxsize=None)
def model(arch: str):
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    return jcfg, jparams, cfg, params_from_numpy(cfg, tree, device="cpu")


def leaves(tree):
    return [t.detach().float().numpy() for t in adamw.leaves(tree)]


def port_grads(cfg, params, batch):
    """(loss, metrics, grads) of the port's ``loss_fn`` by autograd."""
    flat = [t.detach().clone().requires_grad_() for t in
            adamw.leaves(params)]
    total, metrics = T.loss_fn(cfg, adamw.unflatten(params, flat), batch)
    grads = torch.autograd.grad(total, flat)
    return total, metrics, adamw.unflatten(params, list(grads))


class CountMM(TorchDispatchMode):
    """Counts the ``aten.mm``/``aten.addmm`` calls made under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in MM
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax(arch, remat):
    """One batch of 2 x 16 tokens: the total, the loss, the token count
    and every gradient leaf against ``jax.value_and_grad``, both under
    the same remat mode."""
    jcfg, jparams, cfg, params = model(arch)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    jbatch = jmake_batch(jcfg, 16, 2, 0)
    batch = make_batch(cfg, 16, 2, 0, device="cpu")
    (total, metrics), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jbatch), has_aux=True)(jparams)
    t_total, t_metrics, grads = port_grads(cfg, params, batch)
    np.testing.assert_allclose(t_total.item(), float(total), **MODEL_TOL)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(t_metrics[key].detach().item(),
                                   float(metrics[key]), **MODEL_TOL)
    want = params_from_numpy(
        cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), jgrads),
        device="cpu")
    got_leaves, want_leaves = leaves(grads), leaves(want)
    mats = 4 + (3 if cfg.mlp_kind == "swiglu" else 2)
    assert len(got_leaves) == len(want_leaves) == \
        2 + (mats + 2) * cfg.n_layers
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


def backward_mm(cfg, params, batch) -> tuple[list, int]:
    """The gradient leaves and the ``aten.mm`` calls of the backward."""
    flat = [t.detach().clone().requires_grad_() for t in
            adamw.leaves(params)]
    total, _ = T.loss_fn(cfg, adamw.unflatten(params, flat), batch)
    with CountMM() as count:
        grads = torch.autograd.grad(total, flat)
    return [g.numpy() for g in grads], count.n


@pytest.mark.parametrize("arch", ARCHS + ("granite-3-8b",))
def test_dots_recomputes_no_mm(arch):
    """The backward under ``"dots"`` calls ``aten.mm`` exactly as often
    as under ``"none"`` (the products of the gradients only) and gives
    the same bits; under ``"block"`` it calls it more often: each block's
    forward products again, up to the last one whose output the backward
    needs (the non-reentrant recompute stops there), at least one a
    layer."""
    cfg, params = (model(arch)[2:] if arch in ARCHS
                   else model_granite())
    batch = make_batch(cfg, 16, 2, 1, device="cpu")
    runs = {r: backward_mm(dataclasses.replace(cfg, remat=r), params, batch)
            for r in ("none", "block", "dots")}
    assert runs["dots"][1] == runs["none"][1]
    assert runs["block"][1] >= runs["none"][1] + cfg.n_layers
    for a, b in zip(runs["none"][0], runs["dots"][0]):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def model_granite():
    cfg = dataclasses.replace(get_reduced("granite-3-8b"),
                              dtype=torch.float32)
    return cfg, T.init_params(cfg, seed=0, device="cpu")
