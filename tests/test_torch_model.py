"""Port vs JAX: config, parameters, prefill and paged decode of the dense
decoder.

JAX ``init_params`` on the reduced granite-3-8b at fp32 is mapped to
numpy and converted with ``params_from_numpy``; the same token inputs go
through both packages.  Tolerance 1e-4: XLA's CPU and torch's CPU sum
in different orders, and two layers plus an LM head compound that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import kv_cache as JKV
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KV

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "granite-3-8b"


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("getter", ["full", "reduced"])
def test_config_matches_jax(getter):
    j = (jget_config if getter == "full" else jget_reduced)(ARCH)
    t = (get_config if getter == "full" else get_reduced)(ARCH)
    for f in dataclasses.fields(t):
        if f.name not in ("dtype", "kv_cache_dtype"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count()


def test_unported_arch_raises_with_roadmap_pointer():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("gemma2-9b")


def test_param_tree_matches_jax_shapes(model):
    jcfg, jparams, cfg, params = model
    fresh = T.init_params(cfg, seed=0, device="cpu")
    assert len(fresh["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jparams["layers"][0])
        for group in ("norm1", "mixer", "norm2", "ffn"):
            for name, w in fresh["layers"][i][group].items():
                assert tuple(w.shape) == jl[group][name].shape
                np.testing.assert_array_equal(
                    params["layers"][i][group][name].numpy(),
                    np.asarray(jl[group][name]))
    assert tuple(fresh["embed"]["embedding"].shape) == \
        jparams["embed"]["embedding"].shape


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": torch.from_numpy(scale)},
                  torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        **TOL)


@pytest.mark.parametrize("logits_at", [None, 9])
def test_prefill_logits_and_kv_match_jax(model, logits_at):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
    jlog, jcache = JT.prefill(jcfg, jparams, jnp.asarray(tokens), max_seq=24,
                              full_kv=True, logits_at=logits_at)
    logits, cache = T.prefill(cfg, params, torch.from_numpy(tokens),
                              max_seq=24, full_kv=True, logits_at=logits_at)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
    for i, c in enumerate(cache["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                c[key].numpy(), np.asarray(jcache["layers"][0][key][i]),
                **TOL)


def _paged_state(cfg, seed, b=2, page=4, nb=4):
    rng = np.random.default_rng(seed)
    n_pages = b * nb + 1
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    bt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    return kp, vp, bt, page


@pytest.mark.parametrize("span", [None, 3])
def test_paged_decode_step_matches_jax(model, span):
    """Single-token and span decode over the same paged pools: logits and
    the pools the step wrote match."""
    jcfg, jparams, cfg, params = model
    kp, vp, bt, page = _paged_state(cfg, seed=2)
    rng = np.random.default_rng(3)
    pos = np.array([5, 9], np.int32)
    shape = (2,) if span is None else (2, span)
    tok = rng.integers(0, cfg.vocab, shape, dtype=np.int32)
    max_seq = bt.shape[1] * page
    jbt = jnp.asarray(bt)
    jstep = (JKV.make_paged_attn_step(jcfg, jbt, page) if span is None
             else JKV.make_paged_span_step(jcfg, jbt, page, max_seq))
    jcache = {"layers": [{"k_pages": jnp.asarray(kp),
                          "v_pages": jnp.asarray(vp)}], "tail": []}
    jlog, jnew = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                jnp.asarray(pos), attn_step=jstep)
    tbt = torch.from_numpy(bt)
    step = (KV.make_paged_attn_step(cfg, tbt, page) if span is None
            else KV.make_paged_span_step(cfg, tbt, page, max_seq))
    cache = {"k_pages": torch.from_numpy(kp.copy()),
             "v_pages": torch.from_numpy(vp.copy())}
    logits, cache = T.decode_step(cfg, params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(pos), step)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jnew["layers"][0][key]), **TOL)


def test_init_params_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(get_reduced(ARCH))


def test_init_params_is_seeded():
    cfg = get_reduced(ARCH)
    a = T.init_params(cfg, seed=3, device="cpu")
    b = T.init_params(cfg, seed=3, device="cpu")
    c = T.init_params(cfg, seed=4, device="cpu")
    wa, wb, wc = (p["layers"][1]["mixer"]["wq"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.bfloat16
    assert float(wa.float().abs().max()) <= 3 * cfg.d_model ** -0.5 + 1e-2
