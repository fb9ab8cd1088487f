"""Port vs JAX: the static-batch engine and its dense cache.

``DecodeEngine`` (one prefill of the batch, then a loop of
``transformer.decode_step`` over the dense per-layer caches), the ring
buffer of a local layer's cache (slot ``p % window`` holds position p),
``layers.attention_decode`` and the launcher's ``--engine static``, on
the reduced configs of the four ported archs (granite-3-8b, glm4-9b,
granite-34b, gemma2-9b) in fp32 with weights drawn by JAX and carried
over by ``params_from_numpy``.  gemma2-9b's reduced window is 8, so
prompts of 6 tokens and 12 new ones run the ring past its wrap.  Greedy
streams must be token-identical; tensors hold within the tolerance each
test states.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import QuantizedTensor as JQuantizedTensor
from repro.quant import quantize_params as j_quantize_params
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (DecodeEngine, PagedEngine,
                                      PagedServeConfig, ServeConfig)

ARCHS = ("granite-3-8b", "glm4-9b", "granite-34b", "gemma2-9b")
FP8 = torch.float8_e4m3fn


def numpy_tree(tree):
    """A JAX param tree as numpy, each ``QuantizedTensor`` as the ``{"q",
    "scale"}`` leaf ``params_from_numpy`` takes."""
    def leaf(x):
        if isinstance(x, JQuantizedTensor):
            return {"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JQuantizedTensor))


@functools.lru_cache(maxsize=None)
def model(arch: str, quant: str = "none"):
    """(jcfg, jparams, cfg, params) at the reduced config in fp32.  A
    smaller embedding lets the blocks steer the argmax (as in
    ``test_torch_serve.py``), so the decode steps carry information.
    ``quant``: ``"w8"`` int8 projections (JAX's ``quantize_params``),
    ``"fp8kv"`` an e4m3 cache."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tree["embed"] = {"embedding": tree["embed"]["embedding"] / 10}
    jparams = jax.tree.map(jnp.asarray, tree)
    if quant == "w8":
        jparams = j_quantize_params(jparams)
        tree = numpy_tree(jparams)
    if quant == "fp8kv":
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=jnp.float8_e4m3fn)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=FP8)
    return jcfg, jparams, cfg, params_from_numpy(cfg, tree, device="cpu")


def per_layer(cfg, jtree: dict) -> list:
    """The JAX cache tree's stacked groups as one entry per layer, in
    execution order (the port's layout)."""
    pattern = cfg.layer_pattern
    groups = cfg.n_layers // len(pattern)
    out = [jax.tree.map(lambda a: np.asarray(a[g]), jtree["layers"][j])
           for g in range(groups) for j in range(len(pattern))]
    return out + [jax.tree.map(np.asarray, t) for t in jtree["tail"]]


def prompts_for(cfg, b=3, s0=6, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s0), dtype=np.int32)


# --------------------------- the dense cache --------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_seq", [4, 32])
def test_cache_defs_equal_jax(arch, max_seq):
    """``init_cache`` holds one ``{k, v}`` per layer in execution order,
    each JAX's ``cache_shapes`` entry for that layer: (B, L, Hkv, D) in
    the cache dtype, L the window (capped by max_seq) for a local layer,
    max_seq otherwise; zeros."""
    jcfg, _, cfg, _ = model(arch)
    shapes = JT.cache_shapes(jcfg, 3, max_seq)
    pattern = cfg.layer_pattern
    want = [{n: s.shape[1:] for n, s in shapes["layers"][j].items()}
            for _ in range(cfg.n_layers // len(pattern))
            for j in range(len(pattern))]
    want += [{n: s.shape for n, s in t.items()} for t in shapes["tail"]]
    got = T.init_cache(cfg, 3, max_seq, device="cpu")["layers"]
    assert len(got) == len(want) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == tuple(w[name])
            assert g[name].dtype == torch.float32
            assert not g[name].any()
        window = cfg.window if cfg.mixer_for_layer(i) == "local" else None
        defs = L.attention_cache_defs(cfg, 3, max_seq, window)
        assert defs["k"].shape == tuple(g["k"].shape)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=FP8)
    assert T.init_cache(cfg8, 1, max_seq, device="cpu")["layers"][0][
        "k"].dtype == FP8


@pytest.mark.parametrize("s", [5, 8, 13])
def test_ring_prefill_cache_equals_jax(s):
    """gemma2-9b reduced (window 8, local then global): ``prefill``'s
    caches against JAX's at prompts shorter than, equal to and longer
    than the window.  The local layer's ring holds position p at slot p
    % 8 and zeros where no position landed, the global layer's K/V
    zero-padded to max_seq; the values within 1e-5 (the projections and
    rope in two frameworks' fp32), the zero slots exactly zero in
    both."""
    jcfg, jparams, cfg, params = model("gemma2-9b")
    tokens = prompts_for(cfg, 2, s, seed=s)
    _, jcache = JT.prefill(jcfg, jparams, jnp.asarray(tokens), max_seq=24)
    _, cache = T.prefill(cfg, params, torch.from_numpy(tokens), max_seq=24,
                         use_kernel=False)
    for i, (g, w) in enumerate(zip(cache["layers"],
                                   per_layer(cfg, jcache))):
        local = cfg.mixer_for_layer(i) == "local"
        assert tuple(g["k"].shape) == w["k"].shape == \
            (2, 8 if local else 24, 2, 16)
        for name in ("k", "v"):
            got, want = g[name].numpy(), w[name]
            np.testing.assert_array_equal(got == 0, want == 0)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        if local:
            _, full = T.prefill(cfg, params, torch.from_numpy(tokens),
                                max_seq=24, full_kv=True, use_kernel=False)
            pos = np.arange(max(0, s - 8), s)
            np.testing.assert_array_equal(
                g["k"].numpy()[:, pos % 8],
                full["layers"][i]["k"].numpy()[:, pos])


@pytest.mark.parametrize("kv", ["float32", "float8_e4m3fn"])
@pytest.mark.parametrize("s", [5, 8, 13])
def test_ring_layout_byte_equal_to_jax(s, kv):
    """The ring itself, byte for byte: ``attention_apply``'s local-layer
    cache against JAX's where K and V are exact in both frameworks
    (small-integer x and weights, every position 0 so rope is the
    identity), in fp32 and e4m3 (the cast after the placement)."""
    jcfg, _, cfg, _ = model("gemma2-9b")
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=getattr(jnp, kv))
    cfg = dataclasses.replace(cfg, kv_cache_dtype=getattr(torch, kv))
    rng = np.random.default_rng(s)

    def ints(*shape):
        return rng.integers(-2, 3, shape).astype(np.float32)
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    w = {"wq": ints(d, hd), "wk": ints(d, kvd), "wv": ints(d, kvd),
         "wo": ints(hd, d)}
    x = ints(2, s, d) / 8
    pos = np.zeros((2, s), np.int32)
    _, want = JL.attention_apply(
        jcfg, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jnp.asarray(pos), window=cfg.window, return_cache=24)
    _, got = L.attention_apply(
        cfg, {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x), torch.from_numpy(pos), window=cfg.window,
        return_cache=24, use_kernel=False)
    for name in ("k", "v"):
        g = got[name]
        assert g.dtype == getattr(torch, kv) and tuple(g.shape) == \
            (2, 8, 2, 16)
        np.testing.assert_array_equal(
            g.view(torch.uint8).numpy(),
            np.asarray(want[name]).view(np.uint8))


def test_attention_decode_matches_jax_across_the_wrap():
    """``attention_decode`` of gemma2-9b's local layer (window 8) and
    global layer, step by step from a 6-token prefill through positions
    6 to 13, so the ring wraps at 8: each step's output and both caches
    against JAX's within 1e-5 abs + 1e-5 rel (fp32 einsums over at most
    24 keys)."""
    jcfg, jparams, cfg, params = model("gemma2-9b")
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    for i in range(cfg.n_layers):
        window = cfg.window if cfg.mixer_for_layer(i) == "local" else None
        jp = jax.tree.map(lambda a: a[0], jparams["layers"][i])["mixer"]
        p = params["layers"][i]["mixer"]
        pos0 = jnp.broadcast_to(jnp.arange(6), (2, 6))
        _, jc = JL.attention_apply(jcfg, jp, jnp.asarray(x0), pos0,
                                   window=window, return_cache=24)
        _, c = L.attention_apply(cfg, p, torch.from_numpy(x0),
                                 torch.arange(6).expand(2, 6),
                                 window=window, return_cache=24,
                                 use_kernel=False)
        for pos in range(6, 14):
            x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            want, jc = JL.attention_decode(jcfg, jp, jnp.asarray(x), jc,
                                           jnp.int32(pos), window=window)
            got, c = L.attention_decode(cfg, p, torch.from_numpy(x), c, pos,
                                        window=window, use_kernel=False)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
            for name in ("k", "v"):
                np.testing.assert_allclose(c[name].numpy(),
                                           np.asarray(jc[name]),
                                           atol=1e-5, rtol=1e-5)


# ------------------------------ the engine ----------------------------------


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_token_identical_to_jax(arch, fuse):
    """3 prompts of 6 tokens, 12 new ones (gemma2-9b's ring wraps at
    position 8): the port's ``DecodeEngine`` against JAX's, greedy,
    unfused and under ``fuse`` (``qkv_fused`` and ``matmul_fused``'s
    plain versions), token for token; the counters count B * S0 prefill
    and B * n decode tokens."""
    jcfg, jparams, cfg, params = model(arch)
    prompts = prompts_for(cfg)
    want = JDecodeEngine(jcfg, jparams, JServeConfig(
        max_seq=32, fuse=fuse)).generate(prompts, 12)
    eng = DecodeEngine(cfg, params, ServeConfig(max_seq=32, fuse=fuse,
                                                device="cpu"))
    got = eng.generate(prompts, 12)
    assert got.shape == (3, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(got.ravel().tolist())) > 3
    snap = eng.metrics.snapshot()["engine"]
    assert snap == {"prefill_tokens": 18, "decode_tokens": 36}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("quant", ["w8", "fp8kv"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-34b"])
def test_quantized_decode_engine_token_identical_to_jax(arch, quant, fuse):
    """The same under int8 projections (``matmul_w8``'s plain version;
    under ``fuse`` the MLP through the int8 ``matmul_fused``) and under
    an e4m3 dense cache (the ring too), which ``attention_decode`` widens
    to fp32."""
    jcfg, jparams, cfg, params = model(arch, quant)
    prompts = prompts_for(cfg, seed=2)
    want = JDecodeEngine(jcfg, jparams, JServeConfig(
        max_seq=32, fuse=fuse)).generate(prompts, 12)
    got = DecodeEngine(cfg, params, ServeConfig(
        max_seq=32, fuse=fuse, device="cpu")).generate(prompts, 12)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_matches_paged_engine(arch, fuse):
    """As JAX's ``test_paged_generate_matches_dense_engine``: ragged
    prompts, each through the static engine alone, against the paged
    engine with 2 slots for 3 requests (an eviction and a re-admission),
    page 8 and chunk 8 (a whole-prompt join and a chunked prefill),
    token for token."""
    _, _, cfg, params = model(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 9, 12)]
    dense = DecodeEngine(cfg, params, ServeConfig(max_seq=64, fuse=fuse,
                                                  device="cpu"))
    want = [dense.generate(p[None, :], 10)[0] for p in prompts]
    paged = PagedEngine(cfg, params, PagedServeConfig(
        max_seq=64, max_batch=2, page_size=8, prefill_chunk=8,
        decode_chunk=4, fuse=fuse, device="cpu"))
    got = paged.generate(prompts, 10)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_dense_decode_step_refuses_a_span():
    """The dense cache is one-token: the span form needs an
    ``attn_step``, as in JAX."""
    _, _, cfg, params = model("gemma2-9b")
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="span-capable"):
        T.decode_step(cfg, params, torch.zeros((2, 3), dtype=torch.int32),
                      cache, 0)


def test_generate_refuses_what_the_cache_cannot_hold():
    """S0 + n - 1 positions past max_seq raise before any model call
    (JAX's dynamic update would clamp the slot and overwrite the last
    one); at exactly max_seq it runs."""
    _, _, cfg, params = model("granite-3-8b")
    eng = DecodeEngine(cfg, params, ServeConfig(max_seq=16, device="cpu"))
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts_for(cfg, 1, 10), 8)
    assert eng.generate(prompts_for(cfg, 1, 10), 7).shape == (1, 7)
    assert eng.metrics.snapshot()["engine"]["decode_tokens"] == 7


def test_decode_engine_needs_a_gpu_unless_asked_for_the_cpu():
    """``ServeConfig`` defaults to ``device="cuda"``: without a GPU the
    engine raises instead of running on the CPU; ``device="cpu"`` runs
    the plain versions.  Params on another device than the engine's
    raise."""
    _, _, cfg, params = model("granite-3-8b")
    assert ServeConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(cfg, params, ServeConfig())
    meta = {"embed": {"embedding": torch.zeros(1, device="meta")}}
    with pytest.raises(ValueError, match="params are on"):
        DecodeEngine(cfg, meta, ServeConfig(device="cpu"))
    DecodeEngine(cfg, params, ServeConfig(device="cpu"))


# ------------------------------ the launcher --------------------------------


@pytest.mark.parametrize("extra", [[], ["--fuse", "--quantize", "w8fp8"]],
                         ids=["wide", "fused-w8fp8"])
def test_launch_static_on_cpu(tmp_path, capsys, extra):
    """``--engine static`` on the CPU: a (batch, gen) stream, the
    counters printed and written by ``--metrics-out`` (the metrics
    snapshot: the registry, whose schedule-cache counters the DRAM ledger
    keeps, and the ledger's report)."""
    out = tmp_path / "m.json"
    launch_serve.main(["--arch", "gemma2-9b", "--reduced", "--engine",
                       "static", "--device", "cpu", "--dtype", "float32",
                       "--batch", "2", "--prompt-len", "10", "--gen", "6",
                       "--max-seq", "32", "--metrics-out", str(out),
                       *extra])
    text = capsys.readouterr().out
    assert "static engine (cpu)" in text and "generated (2, 6)" in text
    snap = json.loads(out.read_text())
    assert snap["engine"] == {"prefill_tokens": 20, "decode_tokens": 12}
    assert set(snap) == {"engine", "schedule_cache", "dram"}
    assert snap["dram"]["per_step"]["steps"] == 1


def test_launch_paged_writes_metrics(tmp_path, capsys):
    """``--metrics-out`` for the paged engine: the registry snapshot,
    every request's tokens counted."""
    out = tmp_path / "m.json"
    launch_serve.main(["--arch", "glm4-9b", "--reduced", "--device", "cpu",
                       "--dtype", "float32", "--batch", "2", "--requests",
                       "3", "--prompt-len", "9", "--gen", "5",
                       "--max-seq", "32", "--metrics-out", str(out)])
    assert "metrics snapshot" in capsys.readouterr().out
    snap = json.loads(out.read_text())["engine"]
    assert snap["prefill_tokens"] == 27 and snap["decode_tokens"] == 3 * 4
