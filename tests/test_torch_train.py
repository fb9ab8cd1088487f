"""Port vs JAX: the training path.

The same numpy inputs go through the JAX function and the port's, on the
CPU, where the port's kernel wrappers run their plain versions and the
JAX kernels run in Pallas interpret mode:

* the data pipeline, byte for byte;
* AdamW and the int8 gradient compression on the same numpy grads, within
  1e-6 (fp32 arithmetic in another order);
* the dgrad GEMMs' plain versions against JAX's dgrad kernels, and the
  flash-attention backward's plain version and autograd Function against
  JAX's backward kernels and ``jax.grad``, within 2e-4 abs / 2e-3 rel
  (``tests/test_gradients.py``'s tolerance for attention);
* the reduced granite-3-8b at fp32: loss and every gradient leaf against
  ``jax.value_and_grad(loss_fn)`` within 1e-4, blocked linears off and on,
  and a 3-step loss trajectory within 1e-4.  Parameters are not compared
  after an AdamW step: at step 1 the update is about ``lr * sign(g)``, so
  summation-order noise in a near-zero gradient could move a weight by
  2 lr; gradients are compared before the optimizer, and the optimizer on
  identical gradients.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.kernels import ops as jops
from repro.kernels.flash_attention import _flash_forward as jflash_forward
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jbwd
from repro.kernels.matmul_bwd import matmul_dgrad_a as jdgrad_a
from repro.kernels.matmul_bwd import matmul_dgrad_b as jdgrad_b
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim.compress import compress_tree as jcompress_tree
from repro.train import loop as jloop
from repro_torch.configs import get_reduced
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FB
from repro_torch.kernels import matmul_bwd as MB
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.compress import compress_tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop

ARCH = "granite-3-8b"
ATTN_TOL = dict(atol=2e-4, rtol=2e-3)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def port_leaves(tree):
    return [t.detach().float().numpy() for t in adamw.leaves(tree)]


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, to_np(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def batch_pair(jcfg, cfg, step, seq=16, b=2):
    return (jmake_batch(jcfg, seq, b, step),
            make_batch(cfg, seq, b, step, device="cpu"))


# ------------------------------- data --------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (7, 1), (7, 17)])
def test_make_batch_byte_equal_to_jax(seed, step):
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    want = jmake_batch(jcfg, 24, 3, step, seed=seed)
    got = make_batch(cfg, 24, 3, step, seed=seed, device="cpu")
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        assert got[key].numpy().tobytes() == np.asarray(want[key]).tobytes()


def test_make_batch_refuses_unported_families():
    cfg = dataclasses.replace(get_reduced(ARCH), encoder_layers=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        make_batch(cfg, 8, 2, 0, device="cpu")


# ---------------------------- optimizer ------------------------------------


def grad_tree(rng, scale=1.0):
    """A tree shaped like a small model's, with the port's nesting."""
    return {"embed": {"embedding": rng.standard_normal((8, 4)) * scale},
            "layers": [{"w": rng.standard_normal((4, 6)) * scale,
                        "b": rng.standard_normal((6,)) * scale}
                       for _ in range(2)]}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # unclipped, clipped
def test_adamw_matches_jax_on_the_same_grads(grad_scale):
    rng = np.random.default_rng(3)
    p_np = jax.tree.map(lambda a: a.astype(np.float32), grad_tree(rng))
    c = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jc = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = jax.tree.map(torch.from_numpy, p_np)
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    for _ in range(4):          # warmup, then cosine
        g_np = jax.tree.map(lambda a: a.astype(np.float32),
                            grad_tree(rng, grad_scale))
        jp, js, jm = jadamw.apply_updates(jc, jp, jax.tree.map(
            jnp.asarray, g_np), js)
        tp, ts, tm = adamw.apply_updates(c, tp, jax.tree.map(
            torch.from_numpy, g_np), ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        for got, want in ((tp, jp), (ts["mu"], js["mu"]),
                          (ts["nu"], js["nu"])):
            for a, b in zip(port_leaves(got), jax.tree.leaves(
                    jax.tree.map(np.asarray, want))):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        assert all(t.dtype == torch.float32
                   for t in adamw.leaves(ts["mu"]) + adamw.leaves(ts["nu"]))


def test_adamw_keeps_param_dtype_and_fp32_moments():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    state = adamw.init_state(p)
    new, state, _ = adamw.apply_updates(
        adamw.AdamWConfig(warmup_steps=0), p,
        {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, state)
    assert new["w"].dtype == torch.bfloat16
    assert state["mu"]["w"].dtype == torch.float32


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(5)
    g_np = jax.tree.map(lambda a: a.astype(np.float32), grad_tree(rng))
    r_np = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32),
                        grad_tree(rng))
    for residual in (None, r_np):
        jd, jr = jcompress_tree(
            jax.tree.map(jnp.asarray, g_np),
            None if residual is None else jax.tree.map(jnp.asarray,
                                                       residual))
        td, tr = compress_tree(
            jax.tree.map(torch.from_numpy, g_np),
            None if residual is None else jax.tree.map(torch.from_numpy,
                                                       residual))
        for got, want in ((td, jd), (tr, jr)):
            for a, b in zip(port_leaves(got), jax.tree.leaves(
                    jax.tree.map(np.asarray, want))):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------- dgrad GEMMs ----------------------------------


@pytest.mark.parametrize("m,n,k,tiles", [
    (64, 32, 48, (32, 32, 16)), (32, 64, 64, (16, 32, 32))])
def test_dgrad_plain_versions_match_jax_kernels(m, n, k, tiles):
    rng = np.random.default_rng(m + n)
    g = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    t0, t1, t2 = tiles
    want_a = np.asarray(jdgrad_a(jnp.asarray(g), jnp.asarray(b), bm=t0,
                                 br=t1, bo=t2, interpret=True))
    want_b = np.asarray(jdgrad_b(jnp.asarray(a), jnp.asarray(g), bk=t2,
                                 br=t0, bn=t1, interpret=True))
    tg, tb, ta = map(torch.from_numpy, (g, b, a))
    for got in (MB.matmul_dgrad_a_ref(tg, tb),
                MB.matmul_dgrad_a(tg, tb, bm=t0, br=t1, bo=t2)):
        np.testing.assert_allclose(got.numpy(), want_a, rtol=1e-5,
                                   atol=1e-4)
    for got in (MB.matmul_dgrad_b_ref(ta, tg),
                MB.matmul_dgrad_b(ta, tg, bk=t2, br=t0, bn=t1)):
        np.testing.assert_allclose(got.numpy(), want_b, rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (37, 65, 33)])
def test_ops_matmul_grad_matches_jax(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    w = rng.standard_normal((m, n)).astype(np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(jops.matmul(a, b, interpret=True)
                                       * w), (0, 1))(jnp.asarray(a),
                                                     jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    (ops.matmul(ta, tb) * torch.from_numpy(w)).sum().backward()
    for got, want in ((ta.grad, jg[0]), (tb.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# ------------------------- attention backward ------------------------------

ATTN_CASES = [  # sq, skv, causal, window, cap (tests/test_gradients.py)
    (32, 32, True, None, None),
    (32, 32, False, None, None),
    (16, 64, True, None, None),      # decode-ish kv_offset
    (32, 32, True, 16, None),        # sliding window
    (32, 32, True, None, 20.0),      # gemma-2 softcap
]


def one_head(rng, sq, skv, d=16):
    return (rng.standard_normal((sq, d)).astype(np.float32),
            rng.standard_normal((skv, d)).astype(np.float32),
            rng.standard_normal((skv, d)).astype(np.float32),
            rng.standard_normal((sq, d)).astype(np.float32))


@pytest.mark.parametrize("sq,skv,causal,window,cap", ATTN_CASES)
def test_flash_attention_bwd_ref_matches_jax_kernels(sq, skv, causal, window,
                                                     cap):
    rng = np.random.default_rng(sq + skv)
    q, k, v, g = one_head(rng, sq, skv)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jflash_forward(jq, jk, jv, block_q=8, block_kv=16,
                            interpret=True, return_lse=True, **kw)
    want = jbwd(jq, jk, jv, o, lse, jg, block_q=8, block_kv=16,
                interpret=True, **kw)
    head = lambda a: torch.from_numpy(np.array(a))[None, :, None]  # noqa
    tq, tk, tv, tg = map(head, (q, k, v, g))
    t_lse = FA.flash_attention_lse_ref(tq, tk, **kw)
    np.testing.assert_allclose(t_lse[0, 0].numpy(),
                               np.asarray(lse)[:, 0], **ATTN_TOL)
    got = FB.flash_attention_bwd(tq, tk, tv, head(o), t_lse, tg, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[0, :, 0].numpy(), np.asarray(b),
                                   **ATTN_TOL)


@pytest.mark.parametrize("sq,skv,causal,window,cap", ATTN_CASES)
def test_flash_attention_function_grads_match_jax_grad(sq, skv, causal,
                                                       window, cap):
    rng = np.random.default_rng(2 * sq + skv)
    q, k, v, w = one_head(rng, sq, skv)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    want = jax.grad(lambda q, k, v: jnp.sum(jflash(
        q, k, v, block_q=8, block_kv=16, interpret=True, **kw) * w),
        (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a)[None, :, None].requires_grad_()
              for a in (q, k, v)]
    out = FA.flash_attention(*leaves, **kw)
    (out * torch.from_numpy(w)[None, :, None]).sum().backward()
    for t, b in zip(leaves, want):
        np.testing.assert_allclose(t.grad[0, :, 0].numpy(), np.asarray(b),
                                   **ATTN_TOL)


@pytest.mark.parametrize("sq,skv", [(16, 16), (8, 24)])   # GQA; kv_offset
def test_ops_attention_grads_gqa_match_jax(sq, skv):
    rng = np.random.default_rng(sq * skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jops.attention(
        q, k, v, tiles=(8, 8), interpret=True) * w), (0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (ops.attention(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, b in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), **ATTN_TOL)


# ------------------------------- model -------------------------------------


def jax_value_and_grad(jcfg, jparams, jbatch, blocked):
    def loss(p):
        with jops.blocked_linear(blocked):
            return JT.loss_fn(jcfg, p, jbatch)
    (total, metrics), grads = jax.value_and_grad(loss, has_aux=True)(
        jparams)
    return total, metrics, grads


@pytest.mark.parametrize("blocked", [False, True])
def test_loss_and_every_grad_leaf_match_jax(model, blocked):
    jcfg, jparams, cfg, params = model
    jbatch, batch = batch_pair(jcfg, cfg, step=0)
    total, metrics, jgrads = jax_value_and_grad(jcfg, jparams, jbatch,
                                                blocked)
    tc = loop.TrainConfig(blocked_linear=blocked)
    (t_total, t_metrics), grads = loop._value_and_grad(
        loop.make_loss(cfg, tc), params, batch)
    np.testing.assert_allclose(float(t_total), float(total), **MODEL_TOL)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(t_metrics[key]),
                                   float(metrics[key]), **MODEL_TOL)
    want = params_from_numpy(cfg, to_np(jgrads), device="cpu")
    got_leaves, want_leaves = port_leaves(grads), port_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 2 + 9 * cfg.n_layers
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_modes_give_the_same_grads(model, remat):
    _, _, cfg, params = model
    batch = make_batch(cfg, 16, 2, 1, device="cpu")
    runs = []
    for c in (cfg, dataclasses.replace(cfg, remat=remat)):
        (_, m), g = loop._value_and_grad(loop.make_loss(c), params, batch)
        runs.append((float(m["loss"]), port_leaves(g)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("accum,compress", [(1, False), (2, True)])
def test_train_step_metrics_match_jax(model, accum, compress):
    jcfg, jparams, cfg, params = model
    jbatch, batch = batch_pair(jcfg, cfg, step=2, b=4)
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jloop.make_train_step(jcfg, jloop.TrainConfig(
        opt=jadamw.AdamWConfig(**opt), grad_accum=accum,
        compress_grads=compress))
    _, _, jm = jax.jit(jstep)(jparams, jadamw.init_state(jparams), jbatch)
    step = loop.make_train_step(cfg, loop.TrainConfig(
        opt=adamw.AdamWConfig(**opt), grad_accum=accum,
        compress_grads=compress))
    _, state, m = step(params, adamw.init_state(params), batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   **MODEL_TOL)
    assert int(state["step"]) == 1


def test_train_trajectory_matches_jax(model):
    jcfg, jparams, cfg, params = model
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jres = jloop.train(jcfg, jloop.TrainConfig(opt=jadamw.AdamWConfig(**opt)),
                       [jmake_batch(jcfg, 16, 2, s) for s in range(3)],
                       params=jax.tree.map(jnp.array, jparams),
                       log=lambda *_: None)
    res = loop.train(cfg, loop.TrainConfig(opt=adamw.AdamWConfig(**opt)),
                     [make_batch(cfg, 16, 2, s, device="cpu")
                      for s in range(3)], params=params, device="cpu",
                     log=lambda *_: None)
    np.testing.assert_allclose(res["history"], jres["history"], **MODEL_TOL)


def test_opt_state_from_numpy_continues_a_jax_state(model):
    jcfg, jparams, _, _ = model
    bf16 = dataclasses.replace(get_reduced(ARCH), dtype=torch.bfloat16)
    rng = np.random.default_rng(9)
    jstate = jadamw.init_state(jparams)
    jstate = {"mu": jax.tree.map(lambda x: jnp.asarray(
                  rng.standard_normal(x.shape), jnp.float32), jstate["mu"]),
              "nu": jax.tree.map(lambda x: jnp.asarray(
                  rng.uniform(0, 1, x.shape), jnp.float32), jstate["nu"]),
              "step": jnp.asarray(5, jnp.int32)}
    state = opt_state_from_numpy(bf16, to_np(jstate), device="cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 5
    for t in adamw.leaves(state["mu"]) + adamw.leaves(state["nu"]):
        assert t.dtype == torch.float32
    # the converted state drives the port's next step like JAX's
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    state = opt_state_from_numpy(fp32, to_np(jstate), device="cpu")
    grads_np = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 0.01, to_np(jparams))
    c = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jp, js, _ = jadamw.apply_updates(jadamw.AdamWConfig(**c), jparams,
                                     jax.tree.map(jnp.asarray, grads_np),
                                     jstate)
    tp, ts, _ = adamw.apply_updates(
        adamw.AdamWConfig(**c),
        params_from_numpy(fp32, to_np(jparams), device="cpu"),
        params_from_numpy(fp32, grads_np, device="cpu"), state)
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        np.testing.assert_allclose(
            np.concatenate([a.ravel() for a in port_leaves(got)]),
            np.concatenate([a.ravel() for a in port_leaves(
                params_from_numpy(fp32, to_np(want), device="cpu"))]),
            rtol=1e-6, atol=1e-6)


# --------------------------- checkpoint, CLI -------------------------------


def test_checkpoint_restart_reproduces_trajectory(tmp_path, model):
    """Train 6 steps; save at 3; restore: steps 3-5 give the same
    losses (mirror of tests/test_substrate.py)."""
    _, _, cfg, params = model
    tc = loop.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=0,
                                                total_steps=10))
    step_fn = loop.make_train_step(cfg, tc)
    p, opt = params, adamw.init_state(params)
    losses = []
    for step in range(6):
        p, opt, m = step_fn(p, opt, make_batch(cfg, 16, 4, step,
                                               device="cpu"))
        losses.append(float(m["loss"]))
        if step == 2:
            ckpt.save(str(tmp_path), 3, {"params": p, "opt": opt})
    state, start = ckpt.restore(str(tmp_path), {"params": p, "opt": opt})
    assert start == 3 and state["opt"]["step"].dtype == torch.int32
    p2, opt2 = state["params"], state["opt"]
    for step in range(start, 6):
        p2, opt2, m = step_fn(p2, opt2, make_batch(cfg, 16, 4, step,
                                                   device="cpu"))
        assert float(m["loss"]) == pytest.approx(losses[step], abs=1e-6)


def test_checkpoint_latest_valid_skips_corrupt_and_keeps_bf16(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "step": torch.tensor(4, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save_async(str(tmp_path), 2, tree)
    ckpt.wait_async()
    with open(tmp_path / "step_00000002" / "arrays.npz", "ab") as f:
        f.write(b"\xde\xad")
    assert ckpt.latest_valid(str(tmp_path)) == 1
    back, step = ckpt.restore(str(tmp_path), tree)
    assert step == 1 and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"]) and int(back["step"]) == 4


def test_watchdog_flags_stragglers():
    w = loop.StepWatchdog(factor=3.0)
    for i in range(10):
        assert not w.observe(i, 0.1)
    assert w.observe(10, 1.0)
    assert w.flags == [10]


def test_launch_train_reduced_cpu_runs(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--dtype", "float32", "--steps", "3", "--seq-len",
                       "16", "--batch", "2", "--metrics-out", str(out),
                       "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                       "2"])
    text = capsys.readouterr().out
    assert "final loss" in text
    snap = json.loads(out.read_text())
    assert snap["train"]["steps"] == 3
    assert ckpt.latest_valid(str(tmp_path / "ck")) == 2


@pytest.mark.parametrize("flag", [["--trace", "t.json"],
                                  ["--miss-log", "m.jsonl"],
                                  ["--production-mesh"]])
def test_launch_train_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           *flag])
