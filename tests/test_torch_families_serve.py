"""Port vs JAX: serving the other arch families.

``DecodeEngine`` (the static batch) token-identical to JAX's for all six
new archs, the encoder-decoder and vision-prefix families with their stub
inputs from numpy; ``PagedEngine`` token-identical to JAX's for the four
decoder-only ones (phi3.5-moe, qwen3-moe, mamba2-780m, recurrentgemma-9b),
plain and with chunked prefill, speculative decode and the prefix cache
asked for (gated off for the stacks with RG-LRU or SSD mixers, as in
JAX); the paged state's layout (pools over the attention layers, O(1)
states per slot) against JAX's; the port's counterparts of JAX's four
exactness tests (``tests/test_serve_invariants.py``: chunked prefill,
speculative decode, the prefix cache and preempt-restore, each with its
gating asserts) over JAX's own ``ARCHS``; ``default_buckets`` as JAX's;
and ``python -m repro_torch.launch.serve`` for each new arch.  All at the
reduced configs in fp32, weights drawn by JAX with the embedding scaled
by 1/10 (as in ``test_torch_serve.py``: the blocks then steer the
argmax, so every step carries information).  Greedy streams must be
equal token for token.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serve_invariants import ARCHS as JAX_ARCHS

from repro.configs import ARCHS as JCONFIGS
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve import kv_cache as JKV
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import PagedServeConfig as JPagedServeConfig
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import default_buckets as jdefault_buckets
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KV
from repro_torch.serve.engine import (DecodeEngine, PagedEngine,
                                      PagedServeConfig, ServeConfig,
                                      default_buckets)
from repro_torch.serve.lifecycle import RequestStatus

FAMILIES = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-780m",
            "recurrentgemma-9b", "seamless-m4t-medium", "phi-3-vision-4.2b")
DECODER_ONLY = FAMILIES[:4]
SETTINGS = dict(max_seq=64, max_batch=2, page_size=8, decode_chunk=4)


@functools.lru_cache(maxsize=None)
def model(arch: str):
    """(jcfg, jparams, cfg, params) at the reduced config in fp32, the
    embedding scaled by 1/10."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1)))
    tree["embed"] = {"embedding": tree["embed"]["embedding"] / 10}
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(cfg, tree, device="cpu"))


def prompts_for(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lens]


def stub_inputs(cfg, batch: int, seed: int = 9) -> dict:
    """The frontend stubs' inputs as numpy: normal draws times 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.prefix_tokens:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.prefix_tokens, cfg.d_model)).astype(np.float32) * 0.1
    return out


# ----------------------------- the static batch ------------------------------


@pytest.mark.parametrize("arch,fuse", [(a, False) for a in FAMILIES] + [
    ("recurrentgemma-9b", True)])
def test_decode_engine_token_identical_to_jax(arch, fuse):
    """3 prompts of 7 tokens, 10 new ones (the vision prefix's 16
    positions ahead of them, the encoder's 16 beside them): the port's
    static engine gives JAX's greedy tokens; fused too for the hybrid
    (its dense MLP and local attention fused beside the RG-LRU)."""
    jcfg, jparams, cfg, params = model(arch)
    prompts = np.stack(prompts_for(cfg, 3, (7, 7, 7)))
    ex = stub_inputs(cfg, 3)
    want = JDecodeEngine(jcfg, jparams, JServeConfig(max_seq=48, fuse=fuse)
                         ).generate(prompts, 10, **{k: jnp.asarray(v)
                                                    for k, v in ex.items()})
    got = DecodeEngine(cfg, params, ServeConfig(max_seq=48, fuse=fuse,
                                                device="cpu")
                       ).generate(prompts, 10, **ex)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len({tuple(r) for r in got.tolist()}) > 1


# ------------------------------ the paged engine -----------------------------


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_paged_engine_token_identical_to_jax(arch):
    """Prompts of 6, 11, 11 and 6 tokens through 2 slots, 8 new tokens
    each, chunked prefill (8), speculative decode (k = 2) and the prefix
    cache asked for: the port's paged engine gives JAX's tokens and
    stats, with the same page, chunk, buckets and gates -- the MoE stacks
    keep the three features, the RG-LRU and SSD stacks join whole
    prompts at exact lengths (buckets None) with the features off."""
    jcfg, jparams, cfg, params = model(arch)
    kw = dict(prefill_chunk=8, spec_decode=2, prefix_cache=True)
    prompts = prompts_for(cfg, 4, (6, 11, 11, 6))
    jeng = JPagedEngine(jcfg, jparams, JPagedServeConfig(**SETTINGS, **kw))
    eng = PagedEngine(cfg, params, PagedServeConfig(**SETTINGS, **kw,
                                                    device="cpu"))
    want = jeng.generate(prompts, 8)
    got = eng.generate(prompts, 8)
    np.testing.assert_array_equal(got, want)
    for attr in ("prefill_chunk", "spec", "prefix_caching", "buckets",
                 "page_size"):
        assert getattr(eng, attr) == getattr(jeng, attr), attr
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert (eng.spec == 2) == T.attention_only(cfg)


def test_attention_free_page_size_equals_jax():
    """mamba2-780m has no attention layer: no page key is resolved, the
    page is min(max_seq, 128) and the pools are empty, as in JAX."""
    jcfg, jparams, cfg, params = model("mamba2-780m")
    for max_seq in (64, 512):
        sc = dict(SETTINGS, max_seq=max_seq, page_size=None)
        jeng = JPagedEngine(jcfg, jparams, JPagedServeConfig(**sc))
        eng = PagedEngine(cfg, params, PagedServeConfig(**sc, device="cpu"))
        assert eng.page_size == jeng.page_size == min(max_seq, 128)
        assert eng.cache["k_pages"].shape[0] == 0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-780m"])
def test_paged_state_layout_and_join_equal_jax(arch):
    """``init_paged_cache``: the attention layers' pools stacked in layer
    order, the RG-LRU and SSD states one row a slot, each JAX's
    ``paged_cache_defs`` shape; ``write_prefill`` of a batch-1 prefill
    puts the request's states at its slot and its K/V in its pages,
    equal to JAX's."""
    jcfg, jparams, cfg, params = model(arch)
    page, n_pages, batch, slot = 8, 6, 3, 1
    cache = KV.init_paged_cache(cfg, batch, n_pages, page,
                                torch.device("cpu"))
    jcache = JKV.init_paged_cache(jcfg, batch, n_pages, page)
    pattern, groups = cfg.layer_pattern, cfg.n_layers // len(cfg.layer_pattern)
    jlayers = [jax.tree.map(lambda a: a[g], jcache["layers"][j])
               for g in range(groups) for j in range(len(pattern))]
    jlayers += list(jcache["tail"])
    attn = T.attention_layers(cfg)
    assert cache["k_pages"].shape[0] == len(attn)
    tokens = np.asarray(prompts_for(cfg, 6, (13,))[0])[None]
    _, dense = T.prefill(cfg, params, torch.from_numpy(tokens), 16,
                         full_kv=True)
    _, jdense = jax.jit(JT.prefill, static_argnums=(0, 3),
                        static_argnames="full_kv")(
        jcfg, jparams, jnp.asarray(tokens), 16, full_kv=True)
    pages = np.array([3, 5], np.int64)
    KV.write_prefill(cfg, cache, dense, slot, torch.from_numpy(pages), page)
    jcache = JKV.write_prefill(jcfg, jcache, jdense, jnp.int32(slot),
                               jnp.asarray(pages, jnp.int32), page)
    jlayers = [jax.tree.map(lambda a: np.asarray(a[g]), jcache["layers"][j])
               for g in range(groups) for j in range(len(pattern))]
    jlayers += [jax.tree.map(np.asarray, c) for c in jcache["tail"]]
    for i, (got, want) in enumerate(zip(cache["layers"], jlayers)):
        if i in attn:
            a = attn.index(i)
            assert got == {}
            for key in ("k_pages", "v_pages"):
                assert tuple(cache[key][a].shape) == want[key].shape
                np.testing.assert_allclose(cache[key][a].numpy(), want[key],
                                           atol=1e-4, rtol=1e-4)
        else:
            assert sorted(got) == sorted(want)
            for key, v in got.items():
                assert tuple(v.shape) == want[key].shape
                assert v.dtype == torch.float32
                np.testing.assert_allclose(v.numpy(), want[key], atol=1e-4,
                                           rtol=1e-4)
                assert v[slot].any() and not v[0].any()


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "phi-3-vision-4.2b"])
def test_paged_engine_refuses_encoder_and_prefix_families_as_jax(arch):
    jcfg, jparams, cfg, params = model(arch)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        JPagedEngine(jcfg, jparams, JPagedServeConfig(**SETTINGS))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        PagedEngine(cfg, params, PagedServeConfig(**SETTINGS, device="cpu"))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        KV.init_paged_cache(cfg, 2, 4, 8, torch.device("cpu"))


@pytest.mark.parametrize("max_seq", [64, 1000])
def test_default_buckets_equal_jax(max_seq):
    """Powers of two from 8 for attention-only stacks, None (exact
    lengths) for stacks with RG-LRU or SSD mixers, for every arch."""
    for arch in JCONFIGS:
        assert default_buckets(get_config(arch), max_seq) == \
            jdefault_buckets(JCONFIGS[arch], max_seq), arch


# ---------------- the exactness tests over JAX's ARCHS, ported ---------------


@functools.lru_cache(maxsize=None)
def port_model(arch: str, seed: int):
    """The reduced config in fp32 and the port's own weights from JAX's
    seed for the test (these tests hold the port against itself, as
    JAX's hold JAX)."""
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    return cfg, T.init_params(cfg, seed=seed, device="cpu")


def generate(cfg, params, prompts, gen=8, **kw):
    eng = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=64, max_batch=2, page_size=8, decode_chunk=4, device="cpu",
        **kw))
    return eng.generate(prompts, gen), eng


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_chunked_prefill_token_exact(arch):
    """Chunked prefill == whole-prompt joins, token for token (hybrid
    stacks gate chunking off and agree trivially)."""
    cfg, params = port_model(arch, 1)
    prompts = prompts_for(cfg, 1, (5, 11, 9))
    ref, _ = generate(cfg, params, prompts, prefill_chunk=0)
    out, eng = generate(cfg, params, prompts, prefill_chunk=8)
    np.testing.assert_array_equal(ref, out)
    assert (eng.prefill_chunk == 8) == T.attention_only(cfg)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_speculative_decode_token_exact(arch):
    """Draft-verify speculative decode == plain greedy decode, token for
    token (hybrid stacks gate speculation off)."""
    cfg, params = port_model(arch, 2)
    prompts = prompts_for(cfg, 2, (5, 11, 9))
    ref, _ = generate(cfg, params, prompts, prefill_chunk=0, spec_decode=0)
    out, eng = generate(cfg, params, prompts, prefill_chunk=8,
                        spec_decode=3)
    np.testing.assert_array_equal(ref, out)
    attn_only = T.attention_only(cfg)
    assert (eng.spec == 3) == attn_only
    if attn_only:
        st = eng.spec_stats()
        assert st["verify_calls"] > 0
        assert st["tokens"] >= st["verify_calls"]


def reuse_prompts(cfg, seed=7):
    """A 16-token shared prefix with distinct tails, and two prompts of
    exactly that prefix (the second forks its last page)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab, (16,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab, (k,)).astype(np.int32)
             for k in (5, 3, 7)]
    return [np.concatenate([pre, t]) for t in tails] + [pre.copy(),
                                                        pre.copy()]


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_prefix_cache_token_exact(arch):
    """Shared-prefix generation with ``prefix_cache=True`` == the
    unshared engine, byte for byte (hybrid stacks gate the cache off)."""
    cfg, params = port_model(arch, 7)
    prompts = reuse_prompts(cfg)
    ref, _ = generate(cfg, params, prompts, prefill_chunk=8)
    out, eng = generate(cfg, params, prompts, prefill_chunk=8,
                        prefix_cache=True)
    np.testing.assert_array_equal(ref, out)
    attn_only = T.attention_only(cfg)
    assert eng.prefix_caching == attn_only
    if attn_only:
        st = eng.prefix_stats()
        assert st["hits"] > 0 and st["tokens_saved"] > 0


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_preempt_restore_token_exact(arch):
    """Forced preempt-at-step-k + restore == the undisturbed run, byte
    for byte; attention stacks replay only the victim's unshared tail
    through the prefix cache, hybrid stacks (the cache gated off) replay
    it in full."""
    cfg, params = port_model(arch, 11)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (11, 7, 14)]
    ref, _ = generate(cfg, params, prompts, gen=10)
    eng = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=64, max_batch=2, page_size=8, decode_chunk=4, preempt=True,
        prefix_cache=True, device="cpu"))
    for k in (1, 2, 3):
        rids = [eng.submit(p, 10) for p in prompts]
        done, steps, target = {}, 0, None
        while eng.has_work:
            steps += 1
            for r in eng.step():
                done[r.rid] = r
            if steps >= k and target is None:
                cands = [r for r in eng.scheduler.running.values()
                         if r.max_new_tokens - r.generated > 0]
                if cands:
                    target = max(cands, key=lambda r: r.rid).rid
                    assert eng.preempt(target)
            assert steps < 300, "preempt schedule failed to drain"
        assert target is not None, "no preemption candidate ever ran"
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(done[rid].output, ref[i])
        assert done[target].status is RequestStatus.PREEMPTED_RETRIED
        assert done[target].preempt_count >= 1
        assert eng.scheduler.allocator.in_use() == \
            (len(eng.prefix_cache) if eng.prefix_caching else 0)


# -------------------------------- the launcher --------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_runs_each_family(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu``: the paged engine for the decoder-only archs, the
    static one (its default there) with the stub inputs for the
    encoder-decoder and vision-prefix families."""
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--dtype", "float32", "--batch", "2", "--requests",
                       "3", "--prompt-len", "10", "--gen", "4", "--max-seq",
                       "48"])
    text = capsys.readouterr().out
    static = arch in ("seamless-m4t-medium", "phi-3-vision-4.2b")
    assert ("static engine (cpu)" if static else "paged engine (cpu)") in text
    assert "sample:" in text and get_reduced(arch).name in text
