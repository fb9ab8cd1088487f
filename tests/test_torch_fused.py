"""Port vs JAX: the fused serving path (``fuse=True``).

Each op's plain version (what the port runs on CPU tensors) against the
JAX package's Pallas kernel in interpret mode at tiles that divide, and
against the JAX oracle; the fused layers against the JAX layers under
``fused_ops``; and the fused ``PagedEngine`` token for token against the
JAX ``PagedEngine(fuse=True)``.  Inputs are drawn with numpy from a seed
and handed to both packages, in fp32 on the CPU.

Tolerances: fp32 ops differ only in summation order.  A single product
is held within 1e-5 abs + 1e-4 rel; a sum over K terms within
``max(1e-5, 2e-6 * sqrt(K))`` abs + 1e-4 rel (a random walk of fp32
roundings of O(1) partial sums, with margin).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.kernels.flash_decode import flash_decode_oproj as j_oproj
from repro.kernels.flash_decode import \
    paged_attention_oproj_ref as j_oproj_ref
from repro.kernels.matmul_fused import matmul_fused as j_matmul_fused
from repro.kernels.matmul_fused import matmul_fused_ref as j_matmul_fused_ref
from repro.kernels.qkv_fused import qkv_fused as j_qkv_fused
from repro.kernels.qkv_fused import qkv_fused_ref as j_qkv_fused_ref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import PagedServeConfig as JPagedServeConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (flash_decode_oproj,
                                              paged_attention_oproj_ref)
from repro_torch.kernels.matmul_fused import matmul_fused, matmul_fused_ref
from repro_torch.kernels.qkv_fused import qkv_fused, qkv_fused_ref
from repro_torch.models import layers as L
from repro_torch.quant import quantize
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from repro_torch.serve.lifecycle import RequestStatus

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
SETTINGS = dict(max_seq=64, max_batch=4, page_size=8, prefill_chunk=8)


def tol(k: int) -> dict:
    return dict(atol=max(1e-5, 2e-6 * k ** 0.5), rtol=1e-4)


def close(got: torch.Tensor, want, k: int = 1) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol(k))


def t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------- matmul_fused ------------------------------

EPILOGUES = [dict(), dict(bias=True), dict(mul=True), dict(residual=True),
             dict(bias=True, mul=True, residual=True)]


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("epi", EPILOGUES,
                         ids=["plain", "bias", "mul", "residual", "all"])
def test_matmul_fused_matches_jax_kernel(act, epi):
    """Every activation with each epilogue operand alone and all of them
    together: the port's plain version (the CPU path of its wrapper and
    of ``ops.matmul_fused``) against JAX's Pallas kernel in interpret
    mode at dividing tiles, and against JAX's oracle."""
    rng = np.random.default_rng(0)
    m, k, n = 32, 64, 48
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / 8).astype(np.float32)
    kw = {name: rng.standard_normal(shape).astype(np.float32)
          for name, shape in (("bias", (n,)), ("mul", (m, n)),
                              ("residual", (m, n))) if epi.get(name)}
    want = j_matmul_fused(jnp.asarray(a), jnp.asarray(w), act=act, bm=16,
                          bk=32, bn=16, interpret=True,
                          **{x: jnp.asarray(v) for x, v in kw.items()})
    oracle = j_matmul_fused_ref(jnp.asarray(a), jnp.asarray(w), act=act,
                                **{x: jnp.asarray(v) for x, v in kw.items()})
    tkw = {x: t(v) for x, v in kw.items()}
    got = matmul_fused(t(a), t(w), act=act, bm=16, bk=32, bn=16, **tkw)
    close(got, want, k)
    close(got, oracle, k)
    close(ops.matmul_fused(t(a), t(w), act=act, **tkw), want, k)
    close(matmul_fused_ref(t(a), t(w), act=act, **tkw), oracle, k)


def test_matmul_fused_ragged_and_leading_dims_match_jax():
    """A ragged shape (no tile divides it: JAX's op takes its oracle, the
    port's kernel masks) with leading dims, gelu and a residual."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 15, 52)).astype(np.float32)
    w = (rng.standard_normal((52, 37)) / 8).astype(np.float32)
    res = rng.standard_normal((2, 15, 37)).astype(np.float32)
    want = jops.matmul_fused(jnp.asarray(x), jnp.asarray(w), act="gelu",
                             residual=jnp.asarray(res), use_kernel=True,
                             interpret=True)
    got = ops.matmul_fused(t(x), t(w), act="gelu", residual=t(res))
    assert got.shape == (2, 15, 37)
    close(got, want, 52)


def test_matmul_fused_scale_matches_jax_kernel():
    """The per-column fp32 scale (the slot the int8 variant uses) on a
    wide weight, before the bias."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = j_matmul_fused(jnp.asarray(a), jnp.asarray(w),
                          scale=jnp.asarray(scale), bias=jnp.asarray(bias),
                          act="silu", bm=16, bk=32, bn=16, interpret=True)
    got = matmul_fused(t(a), t(w), t(scale), t(bias), act="silu", bm=16,
                       bk=32, bn=16)
    close(got, want, 64)


def test_matmul_fused_refuses_unknown_activation_and_int8_weights():
    """An unknown activation is refused.  An int8 weight (a
    ``QuantizedTensor``) is no longer refused: ``ops.matmul_fused`` runs
    the kernel's int8 variant (its plain version on the CPU), the
    product of the payload with the scale in the epilogue."""
    a, w = torch.zeros(2, 4), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="activation"):
        matmul_fused(a, w, act="tanh", bm=16, bk=64, bn=64)
    rng = np.random.default_rng(1)
    a = t(rng.standard_normal((2, 5, 32)).astype(np.float32))
    qw = quantize(t((rng.standard_normal((32, 16)) / 8).astype(np.float32)))
    got = ops.matmul_fused(a, qw, act="silu")
    want = matmul_fused_ref(a.reshape(10, 32), qw.q, qw.scale.reshape(-1),
                            act="silu")
    assert got.shape == (2, 5, 16)
    torch.testing.assert_close(got.reshape(10, 16), want, rtol=0, atol=0)
    close(got.reshape(10, 16), torch.nn.functional.silu(
        a.reshape(10, 32) @ qw.dequant()), 32)


# -------------------------------- qkv_fused --------------------------------


@pytest.mark.parametrize("g", [1, 4])
def test_qkv_fused_matches_jax_kernel(g):
    rng = np.random.default_rng(4 + g)
    m, k, nkv = 24, 64, 32
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, wk, wv = ((rng.standard_normal((k, c)) / 8).astype(np.float32)
                  for c in (g * nkv, nkv, nkv))
    jargs = [jnp.asarray(v) for v in (x, wq, wk, wv)]
    want = j_qkv_fused(*jargs, bm=8, bk=32, bn=16, interpret=True)
    oracle = j_qkv_fused_ref(*jargs)
    targs = [t(v) for v in (x, wq, wk, wv)]
    for got in (qkv_fused(*targs, bm=8, bk=32, bn=16), qkv_fused_ref(*targs),
                ops.qkv_fused(*targs)):
        assert [tuple(o.shape) for o in got] == [(m, g * nkv), (m, nkv),
                                                 (m, nkv)]
        for o, w_, o_ in zip(got, want, oracle):
            close(o, w_, k)
            close(o, o_, k)


def test_qkv_fused_ragged_with_leading_dims_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    wq, wk, wv = ((rng.standard_normal((48, c)) / 8).astype(np.float32)
                  for c in (36, 12, 12))
    want = jops.qkv_fused(*[jnp.asarray(v) for v in (x, wq, wk, wv)],
                          use_kernel=True, interpret=True)
    got = ops.qkv_fused(*[t(v) for v in (x, wq, wk, wv)])
    for o, w_ in zip(got, want):
        assert tuple(o.shape) == w_.shape
        close(o, w_, 48)


# ---------------------------- flash_decode_oproj ---------------------------


def oproj_case(seed=6):
    rng = np.random.default_rng(seed)
    b, hkv, g, d, page, nb, e = 3, 2, 3, 16, 8, 4, 40
    n_pages = b * nb + 1
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb).reshape(b, nb)).astype(np.int32)
    lengths = np.array([1, 13, 32], np.int32)
    wo = (rng.standard_normal((hkv * g * d, e)) / 10).astype(np.float32)
    return q, kp, vp, bt, lengths, wo


@pytest.mark.parametrize("window,cap", [(None, None), (7, None),
                                        (None, 30.0), (5, 20.0)])
def test_flash_decode_oproj_matches_jax_kernel(window, cap):
    q, kp, vp, bt, lengths, wo = oproj_case()
    b, hkv, g, d = q.shape
    wo3 = wo.reshape(hkv, g * d, -1)
    jargs = [jnp.asarray(v) for v in (q, kp, vp, bt, lengths, wo3)]
    want = j_oproj(*jargs, window=window, logit_cap=cap, interpret=True)
    oracle = j_oproj_ref(*jargs, window=window, logit_cap=cap)
    targs = [t(v) for v in (q, kp, vp, bt, lengths, wo3)]
    for got in (flash_decode_oproj(*targs, window=window, logit_cap=cap),
                paged_attention_oproj_ref(*targs, window=window,
                                          logit_cap=cap)):
        assert tuple(got.shape) == (b, wo.shape[1])
        close(got, want, hkv * g * d)
        close(got, oracle, hkv * g * d)


def test_paged_attention_oproj_views_the_dense_wo_per_head():
    """``ops.paged_attention_oproj`` takes q (B, Hq, D) and the dense
    (Hq*D, E) wo, as the model holds it after ``params_from_numpy``, and
    views it per kv head inside the op, as JAX's op does."""
    q, kp, vp, bt, lengths, wo = oproj_case(seed=7)
    b, hkv, g, d = q.shape
    q3 = q.reshape(b, hkv * g, d)
    want = jops.paged_attention_oproj(
        *[jnp.asarray(v) for v in (q3, kp, vp, bt, lengths, wo)],
        window=9, logit_cap=25.0, use_kernel=True, interpret=True)
    got = ops.paged_attention_oproj(
        *[t(v) for v in (q3, kp, vp, bt, lengths, wo)], window=9,
        logit_cap=25.0)
    close(got, want, hkv * g * d)
    unfused = ops.paged_attention(*[t(v) for v in (q3, kp, vp, bt, lengths)],
                                  window=9, logit_cap=25.0)
    close(got, unfused.reshape(b, -1) @ t(wo), hkv * g * d)


# ------------------------------ fused layers --------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    # a smaller embedding lets the blocks steer the argmax (as in
    # test_torch_serve.py), so every decode step carries information
    tree["embed"] = {"embedding": tree["embed"]["embedding"] / 10}
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(cfg, tree, device="cpu")
    return jcfg, jparams, cfg, params


def test_fused_layers_match_jax_fused_layers(model):
    """``qkv_span_proj`` and ``mlp_apply`` under ``fused_ops`` against
    the JAX layers under theirs, on layer 0's weights."""
    jcfg, _, cfg, params = model
    p = params["layers"][0]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 11), (2, 8)).astype(np.int32)
    jmix = {k_: jnp.asarray(v.numpy()) for k_, v in p["mixer"].items()}
    jffn = {k_: jnp.asarray(v.numpy()) for k_, v in p["ffn"].items()}
    with jops.fused_ops(True):
        jq = JL.qkv_span_proj(jcfg, jmix, jnp.asarray(x), jnp.asarray(pos))
        jm = JL.mlp_apply(jffn, jnp.asarray(x), residual=jnp.asarray(h))
    with ops.fused_ops(True):
        assert ops.fused_ops_enabled()
        q = L.qkv_span_proj(cfg, p["mixer"], t(x), t(pos))
        m = L.mlp_apply(p["ffn"], t(x), residual=t(h))
    for a, b in zip(q, jq):
        close(a, b, cfg.d_model)
    close(m, jm, cfg.d_ff)
    assert not ops.fused_ops_enabled()


def test_fused_ops_switch_nests_and_reads_the_environment(monkeypatch):
    assert not ops.fused_ops_enabled()
    with ops.fused_ops(True):
        with ops.fused_ops(False):
            assert not ops.fused_ops_enabled()
        assert ops.fused_ops_enabled()
    monkeypatch.setenv("REPRO_FUSED_OPS", "1")
    assert ops.fused_ops_enabled()
    with ops.fused_ops(False):
        assert not ops.fused_ops_enabled()


# ------------------------------- the engine ---------------------------------


def make_workload(vocab, n_requests=6, prompt_len=16, gen=12, seed=0):
    """``benchmarks/serve_bench.py::make_workload``, restated (as in
    test_torch_serve.py)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, prompt_len // 2), prompt_len + 1, n_requests)
    short = rng.integers(2, max(3, gen // 8), n_requests)
    long = rng.integers(max(2, gen // 2), gen + 1, n_requests)
    gens = np.where(rng.random(n_requests) < 0.75, short, long)
    prompts = [rng.integers(0, vocab, (int(n),), dtype=np.int32)
               for n in lens]
    return prompts, [int(g) for g in gens]


def run(engine, prompts, gens):
    rids = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    done = {}
    while engine.has_work:
        for req in engine.step():
            done[req.rid] = req
    return [done[r] for r in rids]


@pytest.mark.parametrize("prefill_chunk", [8, 0],
                         ids=["joins_and_chunks", "whole_prompt_joins"])
def test_fused_engine_token_identical_to_jax(model, prefill_chunk):
    """Port ``PagedEngine(fuse=True)`` against the JAX one on the recipe
    of ``test_engine_token_identical_to_jax``: page 8, with chunked
    prefill (chunk 8) and with whole-prompt joins only."""
    jcfg, jparams, cfg, params = model
    prompts, gens = make_workload(cfg.vocab)
    kw = {**SETTINGS, "prefill_chunk": prefill_chunk}
    want = run(JPagedEngine(jcfg, jparams, JPagedServeConfig(
        **kw, spec_decode=0, fuse=True)), prompts, gens)
    eng = PagedEngine(cfg, params, PagedServeConfig(**kw, device="cpu",
                                                    fuse=True))
    got = run(eng, prompts, gens)
    snap = eng.metrics.snapshot()["engine"]
    assert snap["decode_steps"] > 0 and snap["joins"] > 0
    assert (snap["prefill_chunks"] > 0) == bool(prefill_chunk)
    for w, g, n in zip(want, got, gens):
        assert g.status is RequestStatus.OK and len(g.output) == n
        np.testing.assert_array_equal(g.output, w.output)
    assert len({int(x) for r in got for x in r.output}) > len(got)


def test_fused_engine_matches_unfused_engine(model):
    """At fp32 the fused path changes no greedy token: the fused and
    unfused port engines give the same streams."""
    _, _, cfg, params = model
    prompts, gens = make_workload(cfg.vocab, seed=1)
    fused = run(PagedEngine(cfg, params, PagedServeConfig(
        **SETTINGS, device="cpu", fuse=True)), prompts, gens)
    plain = run(PagedEngine(cfg, params, PagedServeConfig(
        **SETTINGS, device="cpu")), prompts, gens)
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a.output, b.output)


def test_fused_engine_sizes_its_page_under_the_oproj_key(model, capsys):
    """Left unset, a fused engine's page comes from the
    ``"flash_decode_oproj"`` key and matches JAX's engine given it."""
    from repro_torch.serve.kv_cache import choose_page_size
    jcfg, jparams, cfg, params = model
    eng = PagedEngine(cfg, params, PagedServeConfig(
        **{**SETTINGS, "page_size": None}, device="cpu", fuse=True))
    assert "fused" in capsys.readouterr().out
    assert eng.page_size == choose_page_size(cfg, SETTINGS["max_seq"],
                                             fused=True)
    prompts, gens = make_workload(cfg.vocab, seed=4)
    want = run(JPagedEngine(jcfg, jparams, JPagedServeConfig(
        **{**SETTINGS, "page_size": eng.page_size}, spec_decode=0,
        fuse=True)), prompts, gens)
    for w, g in zip(want, run(eng, prompts, gens)):
        np.testing.assert_array_equal(g.output, w.output)


def test_serve_cli_runs_fused():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--dtype", "float32", "--fuse",
         "--requests", "3", "--prompt-len", "12", "--gen", "4",
         "--max-seq", "64", "--batch", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    from repro_torch.serve.kv_cache import (choose_page_size,
                                            choose_prefill_chunk)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    page = choose_page_size(cfg, 64, fused=True)
    chunk = choose_prefill_chunk(cfg, 64, page)
    assert (f"page {page}, prefill chunk {chunk} (blocking model, max_seq "
            f"64, fused)") in res.stdout
    assert f"page={page} chunk={chunk} " in res.stdout
    assert "fused=True" in res.stdout and "statuses: ok" in res.stdout
