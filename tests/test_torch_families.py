"""Port vs JAX: the other arch families' model (MoE, Mamba-2 SSD, the
RG-LRU hybrid, encoder-decoder and vision prefix).

The six archs' configs field for field and their parameter counts; the
layers (``moe_apply`` against JAX's off-mesh ``_moe_apply_ref`` where
capacity drops tokens and where router probabilities tie, the aux loss;
``ssd_apply`` at S 1, 7, 8, 13 and 24 over chunk 8, the ragged snap;
``rglru_apply`` at S 1 to 33; ``_causal_conv1d``; a one-token decode
chain against the forward for SSD and RG-LRU); then each arch's
``forward``, ``loss_fn`` (loss and aux) and ``decode_step`` after
``prefill`` (with ``prefix_embeds`` and ``enc_embeds`` from numpy), all
at the reduced configs in fp32 with weights drawn by JAX and carried
over by ``params_from_numpy``.

Tolerances: 1e-5 abs + 1e-5 rel where both frameworks compute the same
products in the same order (the MoE layer, the convolution); 1e-4 abs +
1e-4 rel where the order differs: SSD's einsums contract in another
order, the RG-LRU's doubling scan associates h_t = a_t h_{t-1} + b_t
otherwise than ``lax.associative_scan``, and the models stack them (the
same tolerance as ``test_torch_train.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import QuantizedTensor as JQuantizedTensor
from repro.quant import quantize_params as j_quantize_params
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import QuantizedTensor, quantize_params

FAMILIES = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-780m",
            "recurrentgemma-9b", "seamless-m4t-medium", "phi-3-vision-4.2b")
EXACT = dict(atol=1e-5, rtol=1e-5)
ORDER = dict(atol=1e-4, rtol=1e-4)
FP32_LEAVES = {"A_log", "D", "dt_bias", "lam"}


def jit(fn, *static, **kw):
    """``fn`` jitted with its config (and ``static``) static: one XLA
    program a shape instead of op-by-op dispatch."""
    return jax.jit(fn, static_argnums=(0,) + static, **kw)


def to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@functools.lru_cache(maxsize=None)
def model(arch: str):
    """(jcfg, jparams, cfg, params) at the reduced config in fp32."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    jparams = jit(JT.init_params)(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(cfg, to_np(jparams),
                                                 device="cpu")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def first_layer(jparams, part: str = "mixer"):
    """Layer 0's ``part`` of the JAX tree (group 0 of pattern entry 0)."""
    return jax.tree.map(lambda a: a[0], jparams["layers"][0][part])


def port_tree(tree) -> dict:
    return jax.tree.map(t, tree)


# --------------------------------- configs -----------------------------------


@pytest.mark.parametrize("getter", ["full", "reduced"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_and_counts_match_jax(arch, getter):
    """``CONFIG`` and ``reduced()`` field for field the reference's (dtypes
    aside), the derived widths and flags, and ``param_count``,
    ``active_param_count`` and ``model_flops_per_token``."""
    j = (jget_config if getter == "full" else jget_reduced)(arch)
    c = (get_config if getter == "full" else get_reduced)(arch)
    for f in dataclasses.fields(c):
        if f.name not in ("dtype", "kv_cache_dtype"):
            assert getattr(c, f.name) == getattr(j, f.name), f.name
    assert {f.name for f in dataclasses.fields(c)} == \
        {f.name for f in dataclasses.fields(j)}
    for prop in ("d_inner", "ssm_heads", "is_attention_free",
                 "supports_long_context", "is_encdec"):
        assert getattr(c, prop) == getattr(j, prop), prop
    assert c.param_count() == j.param_count()
    assert c.active_param_count() == j.active_param_count()
    assert c.model_flops_per_token() == j.model_flops_per_token()


def test_every_reference_arch_resolves():
    from repro.configs import ARCHS as JARCHS
    assert sorted(PORT_ARCHS) == sorted(JARCHS)
    for arch in JARCHS:
        assert get_config(arch).name == jget_config(arch).name
        assert get_reduced(arch).name == jget_reduced(arch).name


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_tree_holds_jax_leaves(arch):
    """``init_params``' tree has JAX's leaves, one entry per layer (and per
    encoder layer), each the shape of JAX's, and ``params_from_numpy``
    carries JAX's values into it unchanged."""
    jcfg, jparams, cfg, params = model(arch)
    fresh = T.init_params(cfg, seed=0, device="cpu")
    got = {k: tuple(v.shape) for k, v in flat(fresh).items()}
    conv = {k: tuple(v.shape) for k, v in flat(params).items()}
    assert got == conv
    assert len(fresh["layers"]) == cfg.n_layers
    if cfg.is_encdec:
        assert len(fresh["encoder"]["layers"]) == cfg.encoder_layers
    assert sum(v.numel() for v in flat(fresh).values()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(jparams))
    np.testing.assert_array_equal(
        params["layers"][0]["mixer"][next(iter(fresh["layers"][0]["mixer"]))]
        .numpy(),
        np.asarray(first_layer(jparams)[next(iter(
            fresh["layers"][0]["mixer"]))]))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_bf16_params_keep_fp32_leaves(arch):
    """A bf16 config through ``params_from_numpy``: ``A_log``, ``D``,
    ``dt_bias`` and ``lam`` stay fp32 (as JAX's ``retype_defs`` leaves
    them, and as ``init_params`` makes them), every other leaf bf16."""
    jcfg = jget_reduced(arch)                        # bf16, as JAX's
    cfg = get_reduced(arch)
    jparams = jax.eval_shape(functools.partial(JT.init_params, jcfg),
                             jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, to_np(model(arch)[1]), device="cpu")
    fresh = T.init_params(cfg, seed=0, device="cpu")
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): leaf.dtype
             for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    seen = set()
    for tree in (params, fresh):
        for name, leaf in flat(tree).items():
            key = name.rsplit("/", 1)[-1]
            want = torch.float32 if key in FP32_LEAVES else torch.bfloat16
            assert leaf.dtype == want, name
            if key in FP32_LEAVES:
                seen.add(key)
    assert seen, "no fp32 leaf in the tree"
    for name, dt in jflat.items():
        key = name.rsplit("/", 1)[-1]
        assert (dt == jnp.float32) == (key in FP32_LEAVES), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_quantize_params_keeps_families_wide_as_jax(arch):
    """``quantize_params`` over the ported tree quantizes exactly the leaves
    JAX's does: attention and dense MLP projections; the MoE banks (and
    router), the RG-LRU and SSD mixers and the cross-attention stay
    wide."""
    jcfg, jparams, cfg, params = model(arch)
    jq = jax.eval_shape(j_quantize_params, jparams)
    want = {"/".join(str(getattr(k, "key", k)) for k in path
                     if hasattr(k, "key"))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jq, is_leaf=lambda x: isinstance(x, JQuantizedTensor))
            if isinstance(leaf, JQuantizedTensor)}
    q = quantize_params(params)
    got = set()

    def walk(node, keys):
        if isinstance(node, QuantizedTensor):
            got.add("/".join(k for k in keys if not k.isdigit()))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + [k])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, keys + [str(i)])
    walk(q, [])
    assert got == want
    for wide in ("router", "in_proj", "in_x", "w_r", "cross"):
        assert not any(wide in k.split("/") for k in got), wide


# ---------------------------------- MoE --------------------------------------


def moe_case(arch, tokens, seed, tie=False, pull=0.0):
    """JAX's and the port's MoE on the same (2, tokens / 2, D) input.
    ``tie``: experts 1 and 2 get the same router column (their
    probabilities tie exactly); ``pull``: every token's router logits are
    pulled toward experts 0 and 1 (they overflow their capacity)."""
    jcfg, jparams, cfg, params = model(arch)
    jp = dict(first_layer(jparams, "ffn"))
    router = np.array(jp["router"])
    if tie:
        router[:, 2] = router[:, 1]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, tokens // 2, cfg.d_model)).astype(
        np.float32)
    if pull:
        x += pull * np.sign(router[:, 0] + router[:, 1])[None, None]
    jp["router"] = jnp.asarray(router)
    want, jaux = jit(JL._moe_apply_ref)(jcfg, jp, jnp.asarray(x))
    got, aux = L.moe_apply(cfg, port_tree(jp), t(x))
    return cfg, np.asarray(want), float(jaux), got.numpy(), aux.item(), x, \
        router


@pytest.mark.parametrize("arch", FAMILIES[:2])
def test_moe_matches_jax_with_dropped_tokens(arch):
    """Tokens pulled toward experts 0 and 1 overflow their capacity
    (``moe_capacity``: max(8, ceil8(ceil(T k / E * 1.25)))): the pairs
    past it are dropped in both, the output and the aux loss equal."""
    cfg, want, jaux, got, aux, x, router = moe_case(arch, 64, 0, pull=3.0)
    probs = torch.softmax(t(x.reshape(64, -1)) @ t(router), -1)
    top = L._top_k(probs, cfg.experts_per_token)[1]
    per_expert = np.bincount(top.reshape(-1).numpy(),
                             minlength=cfg.n_experts)
    assert per_expert.max() > L.moe_capacity(cfg, 64), per_expert
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(aux, jaux, **EXACT)


@pytest.mark.parametrize("arch", FAMILIES[:2])
def test_moe_ties_pick_the_lower_expert_as_jax(arch):
    """Two experts with one router column tie exactly on every token:
    ``_top_k`` picks the lower index, as ``lax.top_k`` does, and the
    layer equals JAX's."""
    cfg, want, jaux, got, aux, x, router = moe_case(arch, 16, 1, tie=True)
    probs = torch.softmax(t(x.reshape(16, -1)) @ t(router), -1)
    assert torch.equal(probs[:, 1], probs[:, 2])
    vals, idx = L._top_k(probs, cfg.experts_per_token)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()),
                                cfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert not ((idx == 2).any(dim=1) & ~(idx == 1).any(dim=1)).any()
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(aux, jaux, **EXACT)


@pytest.mark.parametrize("tokens", [1, 8, 40])
def test_moe_aux_and_capacity_match_jax(tokens):
    """The Switch aux loss and the capacity at token counts around the
    floor of 8 slots."""
    arch = FAMILIES[1]
    cfg, want, jaux, got, aux, *_ = moe_case(arch, max(tokens, 2), 2)
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(aux, jaux, **EXACT)
    import math
    cap = int(math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                        * cfg.capacity_factor))
    assert L.moe_capacity(cfg, tokens) == max(8, ((cap + 7) // 8) * 8)


# ----------------------------- SSD and RG-LRU -------------------------------


@pytest.mark.parametrize("s", [1, 7, 8, 13, 24])
def test_ssd_apply_matches_jax(s):
    """mamba2's SSD at chunk 8: the chunk snaps to the largest divisor of
    S up to min(8, S) (S 1 and 13: chunks of 1; S 7: one chunk of 7),
    S 8 is one chunk, S 24 three; the output and the decode state (the
    conv tail, zero-padded when S < 3, and the fp32 final state)."""
    jcfg, jparams, cfg, params = model("mamba2-780m")
    jp = first_layer(jparams)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want, jc = jit(JL.ssd_apply, 3)(jcfg, jp, jnp.asarray(x), True)
    got, c = L.ssd_apply(cfg, port_tree(jp), t(x), return_cache=True)
    assert L.ssd_chunk(cfg, s) == {1: 1, 7: 7, 8: 8, 13: 1, 24: 8}[s]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ORDER)
    np.testing.assert_allclose(c["conv"].numpy(), np.asarray(jc["conv"]),
                               **EXACT)
    np.testing.assert_allclose(c["state"].numpy(), np.asarray(jc["state"]),
                               **ORDER)
    assert c["state"].dtype == torch.float32


@functools.lru_cache(maxsize=None)
def rglru_reference():
    """JAX's RG-LRU over a 33-token input (2 rows): the input and the
    output.  The layer is causal, so its first S outputs are the outputs
    of the input's first S tokens."""
    jcfg, jparams, cfg, params = model("recurrentgemma-9b")
    x = np.random.default_rng(33).standard_normal(
        (2, 33, cfg.d_model)).astype(np.float32)
    return x, np.asarray(jit(JL.rglru_apply)(jcfg, first_layer(jparams),
                                             jnp.asarray(x)))


@pytest.mark.parametrize("s", range(1, 34))
def test_rglru_apply_matches_jax(s):
    """recurrentgemma's RG-LRU at S 1 to 33 (the doubling scan's passes
    from 0 to 6, full and ragged): the output against JAX's on the same
    tokens, and at S 1, 2, 7, 16 and 33 the decode state (the last
    hidden state, fp32, and the conv tail) against JAX's run at that
    S."""
    jcfg, jparams, cfg, params = model("recurrentgemma-9b")
    jp = first_layer(jparams)
    x, want = rglru_reference()
    got, c = L.rglru_apply(cfg, port_tree(jp), t(x[:, :s]),
                           return_cache=True)
    np.testing.assert_allclose(got.numpy(), want[:, :s], **ORDER)
    assert c["h"].dtype == torch.float32 and c["h"].shape == (2, 64)
    if s in (1, 2, 7, 16, 33):
        _, jc = jit(JL.rglru_apply, 3)(jcfg, jp, jnp.asarray(x[:, :s]), True)
        np.testing.assert_allclose(c["h"].numpy(), np.asarray(jc["h"]),
                                   **ORDER)
        np.testing.assert_allclose(c["conv"].numpy(),
                                   np.asarray(jc["conv"]), **EXACT)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 16, 33])
def test_linear_scan_equals_the_sequential_recurrence(s):
    """``linear_scan`` against h_t = a_t h_{t-1} + b_t in a loop, fp32,
    within 1e-6 (the association order only)."""
    rng = np.random.default_rng(s)
    a = t(rng.uniform(0.2, 1.0, (3, s, 5)))
    b = t(rng.standard_normal((3, s, 5)))
    h, want = torch.zeros(3, 5), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    np.testing.assert_allclose(L.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv1d_matches_jax(s, width):
    rng = np.random.default_rng(s * 10 + width)
    x = rng.standard_normal((2, s, 6)).astype(np.float32)
    w = rng.standard_normal((width, 6)).astype(np.float32)
    np.testing.assert_allclose(
        L._causal_conv1d(t(x), t(w)).numpy(),
        np.asarray(jax.jit(JL._causal_conv1d)(jnp.asarray(x),
                                              jnp.asarray(w))),
        **EXACT)


@pytest.mark.parametrize("mixer", ["ssd", "recurrent"])
def test_decode_chain_equals_the_forward(mixer):
    """A prefill of 5 tokens then 7 one-token decode steps gives the
    full 12-token forward's outputs at every later position (the port),
    and JAX's decode steps' outputs (the same chain in JAX)."""
    arch = "mamba2-780m" if mixer == "ssd" else "recurrentgemma-9b"
    jcfg, jparams, cfg, params = model(arch)
    jp = first_layer(jparams)
    p = port_tree(jp)
    apply_, decode_ = ((L.ssd_apply, L.ssd_decode) if mixer == "ssd"
                       else (L.rglru_apply, L.rglru_decode))
    japply, jdecode = ((JL.ssd_apply, JL.ssd_decode) if mixer == "ssd"
                       else (JL.rglru_apply, JL.rglru_decode))
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    full = apply_(cfg, p, t(x)).numpy()
    _, cache = apply_(cfg, p, t(x[:, :5]), return_cache=True)
    _, jcache = jit(japply, 3)(jcfg, jp, jnp.asarray(x[:, :5]), True)
    jdecode = jit(jdecode)
    for i in range(5, 12):
        out, cache = decode_(cfg, p, t(x[:, i:i + 1]), cache)
        jout, jcache = jdecode(jcfg, jp, jnp.asarray(x[:, i:i + 1]), jcache)
        np.testing.assert_allclose(out.numpy()[:, 0], full[:, i], **ORDER)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **ORDER)


# ------------------------------- the models ----------------------------------


def extras(jcfg, batch: int, seed: int = 5) -> dict:
    """The stub modality inputs as numpy, for both packages."""
    rng = np.random.default_rng(seed)
    out = {}
    if jcfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal(
            (batch, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32) * 0.1
    if jcfg.prefix_tokens:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, jcfg.prefix_tokens, jcfg.d_model)).astype(
                np.float32) * 0.1
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match_jax(arch):
    """``forward``'s aux loss and the hidden states' shape (the prefix
    positions ahead of the text), and ``loss_fn``'s total, loss, aux and
    token count, on ``make_batch``'s 2 x 16 tokens (with its stub
    inputs: equal to JAX's byte for byte)."""
    jcfg, jparams, cfg, params = model(arch)
    jbatch = jmake_batch(jcfg, 16, 2, 0)
    batch = make_batch(cfg, 16, 2, 0, device="cpu")
    assert sorted(batch) == sorted(jbatch)
    for key, v in batch.items():
        assert v.numpy().tobytes() == np.asarray(jbatch[key]).tobytes(), key
    kw = {k: batch[k] for k in ("prefix_embeds", "enc_embeds")
          if k in batch}
    jtotal, jm = jit(JT.loss_fn)(jcfg, jparams, jbatch)
    with torch.no_grad():
        h, aux = T.forward(cfg, params, batch["tokens"], **kw)
        total, m = T.loss_fn(cfg, params, batch)
    assert tuple(h.shape) == (2, 16 + cfg.prefix_tokens, cfg.d_model)
    np.testing.assert_allclose(aux.item(), float(jm["aux"]), **ORDER)
    np.testing.assert_allclose(total.item(), float(jtotal), **ORDER)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), **ORDER)
    assert (aux.item() > 0) == bool(cfg.n_experts)


def per_layer_cache(jcfg, jcache) -> list:
    """JAX's cache tree as one numpy entry per layer, in execution
    order."""
    pattern = jcfg.layer_pattern
    groups = jcfg.n_layers // len(pattern)
    out = [jax.tree.map(lambda a: np.asarray(a[g]), jcache["layers"][j])
           for g in range(groups) for j in range(len(pattern))]
    return out + [jax.tree.map(np.asarray, c) for c in jcache["tail"]]


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_steps_match_jax(arch):
    """``prefill`` of 2 x 6 tokens (after the prefix, beside the encoder
    input) at max_seq 32: the logits and every cache leaf (attention K/V,
    the RG-LRU and SSD states, the cross K/V); then 4 ``decode_step`` s
    over the dense cache at the positions after the prefix: the logits
    each step, and the caches after the last."""
    jcfg, jparams, cfg, params = model(arch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 6), dtype=np.int32)
    ex = extras(jcfg, 2)
    jlog, jcache = jit(JT.prefill, 3)(
        jcfg, jparams, jnp.asarray(tokens), 32,
        **{k: jnp.asarray(v) for k, v in ex.items()})
    with torch.no_grad():
        logits, cache = T.prefill(cfg, params, torch.from_numpy(tokens), 32,
                                  **{k: t(v) for k, v in ex.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **ORDER)
    for got, want in zip(cache["layers"], per_layer_cache(jcfg, jcache)):
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == (torch.float32), k
            np.testing.assert_allclose(got[k].numpy(), want[k], **ORDER)
    pos = 6 + cfg.prefix_tokens
    jdecode = jit(JT.decode_step)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, (2,), dtype=np.int32)
        jlog, jcache = jdecode(jcfg, jparams, jnp.asarray(tok), jcache,
                               jnp.int32(pos + step))
        with torch.no_grad():
            logits, cache = T.decode_step(cfg, params, torch.from_numpy(tok),
                                          cache, pos + step)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **ORDER)
    for got, want in zip(cache["layers"], per_layer_cache(jcfg, jcache)):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k], **ORDER)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_span_decode_refuses_recurrent_stacks_as_jax(arch):
    """The span form of ``decode_step`` is attention-only, as in JAX."""
    _, _, cfg, params = model(arch)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        T.decode_step(cfg, params, torch.zeros((2, 3), dtype=torch.int32),
                      cache, torch.zeros(2, dtype=torch.int32),
                      attn_step=lambda *a: None)


def test_cache_defs_and_cross_cache_match_jax():
    """The encoder-decoder's dense cache: every layer's leaves JAX's
    shapes with the cross K/V at enc_seq; ``prefill_cross_cache`` writes
    JAX's cross K/V; the hybrid's states shaped as JAX's."""
    for arch in ("seamless-m4t-medium", "recurrentgemma-9b", "mamba2-780m"):
        jcfg, jparams, cfg, params = model(arch)
        shapes = JT.cache_shapes(jcfg, 3, 16, enc_seq=5)
        groups = cfg.n_layers // len(cfg.layer_pattern)
        jshapes = [{k: v.shape[1:] for k, v in shapes["layers"][j].items()}
                   for _ in range(groups)
                   for j in range(len(cfg.layer_pattern))]
        jshapes += [{k: v.shape for k, v in c.items()}
                    for c in shapes["tail"]]
        got = T.init_cache(cfg, 3, 16, device="cpu", enc_seq=5)["layers"]
        assert len(got) == len(jshapes) == cfg.n_layers
        for g, w in zip(got, jshapes):
            assert {k: tuple(v.shape) for k, v in g.items()} == \
                {k: tuple(v) for k, v in w.items()}
    jcfg, jparams, cfg, params = model("seamless-m4t-medium")
    enc = extras(jcfg, 3)["enc_embeds"]
    jc = jit(JT.prefill_cross_cache)(
        jcfg, jparams, JT.init_cache(jcfg, 3, 16, enc_seq=jcfg.encoder_seq),
        jnp.asarray(enc))
    c = T.prefill_cross_cache(
        cfg, params, T.init_cache(cfg, 3, 16, device="cpu",
                                  enc_seq=cfg.encoder_seq), t(enc))
    for g, w in zip(c["layers"], per_layer_cache(jcfg, jc)):
        for k in ("cross_k", "cross_v"):
            np.testing.assert_allclose(g[k].numpy(), w[k], **ORDER)
