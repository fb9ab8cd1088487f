"""Port vs JAX: the sharded route of the SSD, RG-LRU, encoder-decoder and
vision-prefix families on gloo ranks.

The four reduced configs (mamba2-780m, recurrentgemma-9b,
seamless-m4t-medium, phi-3-vision-4.2b) in fp32, weights drawn by JAX
(``convert.params_from_numpy``), on the ranks of
``tests/test_torch_distributed.py`` (``torch_dist_ranks.family_cases``:
one spawn a mesh shape runs every family's case).  The reference is
JAX's single-device step (its sharded step fails under JAX 0.9):

* one step of ``make_train_step`` under ``tp_fsdp`` on (2, 1), (1, 2)
  and (2, 2), and ``fsdp`` on (2, 2), a batch of 4 x 16 tokens with the
  family's stub inputs: the loss, every gradient leaf (gathered) and
  the params after AdamW against ``jax.value_and_grad`` and JAX's
  ``make_train_step``, within 1e-4 abs + 1e-4 rel elementwise
  (``test_torch_families_train.py``'s bound, set by the RG-LRU scan's
  association order); a weight whose gradient is near AdamW's eps gets
  what the gradients' bound moves its first update by
  (``torch_dist_ranks._adam_excess``);
* ``prefill`` and 4 ``decode_step`` s on (1, 2) and (2, 2) against JAX's
  unsharded ones (1e-4 relative): mamba2's replicated state,
  recurrentgemma's width-split state with its ring (window 8) sharded
  over the sequence (max_seq 24) and replicated (max_seq 7), seamless's
  replicated cross K/V, phi-3-vision's 16-row prefix.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as R
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from test_torch_distributed import OPT, flat, jcfg_of, save_cases, spawn

FAMILIES = {"mamba2": "mamba2-780m", "rg": "recurrentgemma-9b",
            "seamless": "seamless-m4t-medium", "phi3v": "phi-3-vision-4.2b"}
TOL = (1e-4, 1e-4)                       # atol, rtol
PARS = {(2, 1): ["tp_fsdp"], (1, 2): ["tp_fsdp"],
        (2, 2): ["tp_fsdp", "fsdp"]}
SERVE_CASES = {"mamba2": {"arch": "mamba2-780m", "max_seq": 24},
               "rg_seq": {"arch": "recurrentgemma-9b", "max_seq": 24},
               "rg_rep": {"arch": "recurrentgemma-9b", "max_seq": 7},
               "seamless": {"arch": "seamless-m4t-medium", "max_seq": 24},
               "phi3v": {"arch": "phi-3-vision-4.2b", "max_seq": 32}}
SERVE_LAYOUTS = {"mamba2": [], "rg_seq": ["seq"], "rg_rep": ["replicated"],
                 "seamless": ["heads"], "phi3v": ["heads"]}
DECODE_STEPS = 4


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@functools.lru_cache(maxsize=None)
def jax_model(arch: str):
    jcfg = jcfg_of(arch)
    return jcfg, jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=1)
def jax_train_arrays() -> dict:
    arrays = {}
    for name, arch in FAMILIES.items():
        jcfg, jparams = jax_model(arch)
        jbatch = dict(jmake_batch(jcfg, 16, 4, 0))
        tc = jloop.TrainConfig(opt=jadamw.AdamWConfig(**OPT))
        (_, _), grads = jax.jit(jax.value_and_grad(
            jloop.make_loss(jcfg, tc), has_aux=True))(jparams, jbatch)
        new, _, m = jax.jit(jloop.make_train_step(jcfg, tc))(
            jparams, jadamw.init_state(jparams), jbatch)
        flat(jparams, f"{name}/params", arrays)
        flat(grads, f"{name}/grads", arrays)
        flat(new, f"{name}/new", arrays)
        for k, v in jbatch.items():
            arrays[f"{name}/batch/{k}"] = np.asarray(v)
        arrays[f"{name}/loss"] = np.asarray(m["loss"], np.float32)
        arrays[f"{name}/grad_norm"] = np.asarray(m["grad_norm"], np.float32)
    return arrays


@functools.lru_cache(maxsize=1)
def jax_serve_arrays() -> dict:
    arrays = {}
    for name, case in SERVE_CASES.items():
        jcfg, jparams = jax_model(case["arch"])
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, jcfg.vocab, (4, 10)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab, (4, DECODE_STEPS)).astype(
            np.int32)
        extra = {}
        if jcfg.is_encdec:
            extra["enc_embeds"] = rng.standard_normal(
                (4, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
        if jcfg.prefix_tokens:
            extra["prefix_embeds"] = rng.standard_normal(
                (4, jcfg.prefix_tokens, jcfg.d_model)).astype(np.float32)
        prefill = jax.jit(functools.partial(JT.prefill, jcfg),
                          static_argnums=(2,))
        logits, cache = prefill(jparams, jnp.asarray(tokens),
                                case["max_seq"],
                                **{k: jnp.asarray(v) for k, v in
                                   extra.items()})
        step = jax.jit(functools.partial(JT.decode_step, jcfg))
        s = tokens.shape[1] + jcfg.prefix_tokens
        dec = []
        for j in range(DECODE_STEPS):
            out, cache = step(jparams, jnp.asarray(nxt[:, j]), cache,
                              jnp.int32(s + j))
            dec.append(np.asarray(out, np.float32))
        flat(jparams, f"{name}/params", arrays)
        arrays[f"{name}/tokens"] = tokens
        arrays[f"{name}/next"] = nxt
        for k, v in extra.items():
            arrays[f"{name}/extra/{k}"] = v
        arrays[f"{name}/prefill"] = np.asarray(logits, np.float32)
        arrays[f"{name}/decode"] = np.stack(dec, axis=1)
    return arrays


@pytest.mark.parametrize("shape", list(PARS))
def test_sharded_families_match_jax(tmp_path, shape):
    cases = {name: {"arch": arch, "opt": OPT, "tol": TOL,
                    "pars": PARS[shape]} for name, arch in FAMILIES.items()}
    train = save_cases(tmp_path, "train", cases, jax_train_arrays())
    serve = save_cases(tmp_path, "serve", SERVE_CASES, jax_serve_arrays()) \
        if shape[1] > 1 else None
    out = tmp_path / "families.json"
    spawn(R.family_cases, shape[0] * shape[1], tmp_path, shape, train, serve,
          str(out))
    result = json.loads(out.read_text())
    assert set(result["train"]) == {f"{n}/{p}" for n in FAMILIES
                                    for p in PARS[shape]}
    for key, r in result["train"].items():
        assert set(r) == {"loss", "grad_norm", "params_in_bound",
                          "loss_first", "grads"}, (key, r)
        for metric, err in r.items():     # in units of the bound
            assert err <= 1, (shape, key, metric, err)
    if serve is None:
        assert "serve" not in result
        return
    assert set(result["serve"]) == set(SERVE_CASES)
    for name, r in result["serve"].items():
        assert r["layouts"] == SERVE_LAYOUTS[name], (name, r)
        assert r["prefill"] <= 1e-4 and r["decode"] <= 1e-4, (name, r)
