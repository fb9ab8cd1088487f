"""Port vs JAX: the sharded route on gloo ranks.

The ranks are processes of ``torch.multiprocessing.spawn``
(``tests/torch_dist_ranks.py``: they import only torch, numpy and the
port), joined through a ``FileStore`` in ``tmp_path`` (no TCP port: the
suite runs under xdist), with ``OMP_NUM_THREADS=1`` and a join timeout
per test, so a hang fails the test instead of eating the suite's limit.
JAX's values are computed here, in the parent, and handed over in an
``.npz``.

* The reduced granite (d_model 64, 4/2 heads, d_ff 128, fp32) on (2, 1),
  (1, 2) and (2, 2) under ``tp_fsdp`` and ``fsdp``: one step's loss,
  every gradient leaf (gathered) and the params after AdamW against
  JAX's single-device ``make_train_step`` (and ``jax.value_and_grad``
  of its loss), within 1e-5 relative (max |port - JAX| over max |JAX|,
  per leaf); the same with ``grad_accum`` 2, with compressed gradients,
  with masked labels and with one kv head (the kv weights replicated
  over the model axis).  The params after AdamW are held to 1e-5 of the
  leaf's max plus what the gradients' 1e-5 moves AdamW's first update
  by: ``g / (|g| + eps)`` turns on the rounding of a gradient near
  ``eps`` (one weight of the one-kv-head case has |g| 7.5e-9: there the
  port's unsharded step and JAX's differ by 2.5e-4 of the leaf's max
  too), so those few weights get the propagated bound
  (``torch_dist_ranks._adam_excess``).
* ``prefill`` logits and one ``decode_step`` on (1, 2) and (2, 2)
  against JAX's unsharded ones (1e-4 relative): head-sharded,
  sequence-sharded and replicated caches, gemma2's ring, a vocab padded
  otherwise at each ``model_ax``.
* The shard-mapped MoE (reduced qwen3-moe, fp32) on (1, 2) and (2, 2): at
  capacity factor 8 against JAX's ``_moe_apply_ref`` (1e-4 abs, JAX's
  own test's bound), and at capacity factor 1, which drops tokens,
  against JAX's ``_moe_apply_shardmap`` on the same meshes (a
  subprocess with 8 forced host devices), output and aux within 1e-5.
* ``elastic.reshard_checkpoint``: a checkpoint saved on (2, 2) (vocab
  padded to 288) restored on (4, 1) and (1, 1) (272) equals JAX's
  ``checkpoint`` pad/crop of the saved arrays.
* ``launch.train`` under ``torch.distributed.run --nproc-per-node 2
  --device cpu`` gives the single-process final loss (1e-5 relative);
  ``--production-mesh`` on 2 ranks raises, naming 256.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_dist_ranks as R
from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.base import build as jbuild
from repro.models.base import retype_defs as jretype
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch.launch import elastic
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 240          # seconds a spawned group may take before it fails
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def spawn(fn, world: int, tmp_path, *args) -> None:
    """``fn(rank, world, store, *args)`` on ``world`` gloo ranks; fails
    past :data:`TIMEOUT` (the ranks killed) or when a rank raises."""
    store = tmp_path / f"store_{fn.__name__}_{world}_{time.monotonic_ns()}"
    ctx = mp.start_processes(fn, args=(world, str(store), *args),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} on {world} ranks did not finish "
                        f"in {TIMEOUT}s")


def flat(tree, prefix: str, out: dict) -> None:
    """A numpy-mapped JAX tree into ``out`` under path keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix.lstrip("/")] = np.asarray(tree, np.float32)


def save_cases(tmp_path, name: str, cases: dict, arrays: dict) -> str:
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump(cases, f)
    return path


def jcfg_of(arch: str, **over):
    return dataclasses.replace(jget_reduced(arch), dtype=jnp.float32,
                               **over)


# ------------------------------ training ----------------------------------

TRAIN_CASES = {
    "base": {"arch": "granite-3-8b"},
    "accum2": {"arch": "granite-3-8b", "accum": 2},
    "compress": {"arch": "granite-3-8b", "compress": True},
    "masked": {"arch": "granite-3-8b", "mask": True},
    "kv1": {"arch": "granite-3-8b", "cfg": {"n_kv_heads": 1}},
}


@functools.lru_cache(maxsize=1)
def jax_train_arrays() -> dict:
    arrays = {}
    for name, case in TRAIN_CASES.items():
        jcfg = jcfg_of(case["arch"], **case.get("cfg", {}))
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        jbatch = dict(jmake_batch(jcfg, 16, 8, 0))
        if case.get("mask"):
            labels = np.array(jbatch["labels"])
            labels[:, ::3] = -1
            jbatch["labels"] = jnp.asarray(labels)
        tc = jloop.TrainConfig(opt=jadamw.AdamWConfig(**OPT),
                               grad_accum=case.get("accum", 1),
                               compress_grads=case.get("compress", False))
        (_, _), grads = jax.jit(jax.value_and_grad(
            jloop.make_loss(jcfg, tc), has_aux=True))(jparams, jbatch)
        new, _, m = jax.jit(jloop.make_train_step(jcfg, tc))(
            jparams, jadamw.init_state(jparams), jbatch)
        flat(jparams, f"{name}/params", arrays)
        flat(grads, f"{name}/grads", arrays)
        flat(new, f"{name}/new", arrays)
        for k in ("tokens", "labels"):
            arrays[f"{name}/batch/{k}"] = np.asarray(jbatch[k])
        arrays[f"{name}/loss"] = np.asarray(m["loss"], np.float32)
        arrays[f"{name}/grad_norm"] = np.asarray(m["grad_norm"], np.float32)
    return arrays


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_sharded_train_step_matches_jax(tmp_path, shape):
    cases = {k: dict(v, opt=OPT) for k, v in TRAIN_CASES.items()}
    data = save_cases(tmp_path, "train", cases, jax_train_arrays())
    out = tmp_path / "train.json"
    spawn(R.train_cases, shape[0] * shape[1], tmp_path, shape, data,
          str(out))
    result = json.loads(out.read_text())
    assert len(result) == 2 * len(TRAIN_CASES)
    for key, r in result.items():
        assert r.pop("params_in_bound") <= 1, (shape, key)
        for metric, err in r.items():
            assert err <= 1e-5, (shape, key, metric, err)


# ------------------------------ serving -----------------------------------

SERVE_CASES = {
    "granite": {"arch": "granite-3-8b", "max_seq": 24},
    "granite_kv1_seq": {"arch": "granite-3-8b", "max_seq": 24,
                        "cfg": {"n_kv_heads": 1, "vocab": 260}},
    "granite_kv1_rep": {"arch": "granite-3-8b", "max_seq": 25,
                        "cfg": {"n_kv_heads": 1}},
    "gemma2": {"arch": "gemma2-9b", "max_seq": 24},
    "gemma2_kv1": {"arch": "gemma2-9b", "max_seq": 24,
                   "cfg": {"n_kv_heads": 1}},
}
SERVE_LAYOUTS = {"granite": ["heads"], "granite_kv1_seq": ["seq"],
                 "granite_kv1_rep": ["replicated"], "gemma2": ["heads"],
                 "gemma2_kv1": ["seq"]}


@functools.lru_cache(maxsize=1)
def jax_serve_arrays() -> dict:
    arrays = {}
    for name, case in SERVE_CASES.items():
        jcfg = jcfg_of(case["arch"], **case.get("cfg", {}))
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), 2)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, jcfg.vocab, (4, 10)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab, (4,)).astype(np.int32)
        prefill = jax.jit(functools.partial(JT.prefill, jcfg),
                          static_argnums=(2,))
        logits, cache = prefill(jparams, jnp.asarray(tokens),
                                case["max_seq"])
        dec, _ = jax.jit(functools.partial(JT.decode_step, jcfg))(
            jparams, jnp.asarray(nxt), cache, jnp.int32(10))
        flat(jparams, f"{name}/params", arrays)
        arrays[f"{name}/tokens"] = tokens
        arrays[f"{name}/next"] = nxt
        arrays[f"{name}/prefill"] = np.asarray(logits, np.float32)
        arrays[f"{name}/decode"] = np.asarray(dec, np.float32)
    return arrays


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_prefill_and_decode_match_jax(tmp_path, shape):
    data = save_cases(tmp_path, "serve", SERVE_CASES, jax_serve_arrays())
    out = tmp_path / "serve.json"
    spawn(R.serve_cases, shape[0] * shape[1], tmp_path, shape, data,
          str(out))
    result = json.loads(out.read_text())
    assert set(result) == set(SERVE_CASES)
    for name, r in result.items():
        assert r["layouts"] == SERVE_LAYOUTS[name], (name, r)
        assert r["prefill"] <= 1e-4 and r["decode"] <= 1e-4, (name, r)


# -------------------------------- MoE -------------------------------------

MOE_SHARDMAP = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.models import layers as L
    from repro.models.sharding import set_axis_mapping
    from repro.configs import get_reduced
    import dataclasses
    data = np.load(sys.argv[1])
    cfg = dataclasses.replace(get_reduced('qwen3-moe-235b-a22b'),
                              dtype=jnp.float32,
                              capacity_factor=float(sys.argv[3]))
    params = {k: jnp.asarray(data['params/' + k])
              for k in ('router', 'w_gate', 'w_up', 'w_down')}
    x = jnp.asarray(data['x'])
    set_axis_mapping({'data': ('data',), 'model': 'model'})
    out = {}
    for shape in ((1, 2), (2, 2)):
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(shape, ('data', 'model'),
                             devices=jax.devices()[:n])
        with mesh:
            y, aux = jax.jit(lambda p, x: L.moe_apply(cfg, p, x))(params, x)
        out[f'{shape[0]}x{shape[1]}/out'] = np.asarray(y)
        out[f'{shape[0]}x{shape[1]}/aux'] = np.asarray(aux)
    np.savez(sys.argv[2], **out)
"""


@functools.lru_cache(maxsize=1)
def jax_moe_arrays(tmp: str) -> dict:
    jcfg = jcfg_of("qwen3-moe-235b-a22b", capacity_factor=8.0)
    params = jbuild(jretype(JL.moe_defs(jcfg, 2), jnp.float32), "init",
                    jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, jcfg.d_model),
                          jnp.float32)
    arrays = {f"params/{k}": np.asarray(v) for k, v in params.items()}
    arrays["x"] = np.asarray(x)
    ref, _ = JL._moe_apply_ref(jcfg, params, x)
    for shape in ("1x2", "2x2"):
        arrays[f"cf8/{shape}/out"] = np.asarray(ref)
        arrays[f"cf8/{shape}/aux"] = np.float32(0)
    inputs = os.path.join(tmp, "moe_in.npz")
    np.savez(inputs, **arrays)
    got = os.path.join(tmp, "moe_jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(
        MOE_SHARDMAP), inputs, got, "1.0"], capture_output=True, text=True,
        env=env, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for k, v in np.load(got).items():
        arrays[f"cf1/{k}"] = v
    return arrays


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_shardmap_moe_matches_jax(tmp_path_factory, tmp_path, shape):
    arrays = jax_moe_arrays(str(tmp_path_factory.getbasetemp()))
    cases = {"cf8": {"capacity_factor": 8.0},
             "cf1": {"capacity_factor": 1.0}}
    data = save_cases(tmp_path, "moe", cases, arrays)
    out = tmp_path / "moe.json"
    spawn(R.moe_cases, shape[0] * shape[1], tmp_path, shape, data,
          str(out))
    result = json.loads(out.read_text())
    assert result["cf8"]["sharded"] and result["cf1"]["sharded"]
    # capacity 8: no token dropped, the dispatch is the reference's
    assert result["cf8"]["out"] < 1e-4, result
    # capacity 1 drops tokens: JAX's shard-mapped dispatch, exactly
    assert result["cf1"]["out"] <= 1e-5 and result["cf1"]["aux"] <= 1e-5, \
        result
    ref = arrays["cf8/1x2/out"]
    assert np.abs(arrays[f"cf1/{shape[0]}x{shape[1]}/out"] - ref).max() \
        > 1e-3, "capacity 1 dropped no token"


# ----------------------------- checkpoints --------------------------------


def test_reshard_checkpoint_matches_jax_pad_crop(tmp_path):
    over = {"vocab": 260}
    ck = str(tmp_path / "ck")
    spawn(R.save_checkpoint, 4, tmp_path, (2, 2), over, ck,
          str(tmp_path / "saved.json"))
    assert ckpt.latest_valid(ck) == 1
    saved = np.load(os.path.join(ck, "step_00000001", "arrays.npz"))
    cfg = R._cfg("granite-3-8b", **over)
    template = {"params": T.param_shapes(cfg, 1)}
    keys = [(k, tuple(t.shape)) for k, t in ckpt._flatten(template)]
    assert saved[keys[0][0]].shape != keys[0][1]       # the vocab changed
    want = [jckpt._reshape_like(saved[k], shape) for k, shape in keys]
    mu_keys = [k.replace("['params']", "['opt']['mu']", 1)
               for k, _ in keys]
    want_mu = [jckpt._reshape_like(saved[k], shape)
               for k, (_, shape) in zip(mu_keys, keys)]

    out = str(tmp_path / "restored41.npz")
    spawn(R.restore_checkpoint, 4, tmp_path, (4, 1), over, ck, out)
    got = np.load(out)
    assert int(got["step"]) == 1
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"params/{i}"], w)
    for i, w in enumerate(want_mu):
        np.testing.assert_array_equal(got[f"mu/{i}"], w)

    state, step = elastic.reshard_checkpoint(
        cfg, ck, elastic.plan_mesh(cfg, 1))
    assert step == 1
    for (_, t), w in zip(ckpt._flatten(state["params"]), want):
        np.testing.assert_array_equal(t.numpy(), w)


# ------------------------------ launcher ----------------------------------

LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
          "--reduced", "--device", "cpu", "--dtype", "float32", "--steps",
          "3", "--seq-len", "16", "--batch", "4"]


def run_launcher(tmp_path, torchrun: bool, *extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    pre = [sys.executable]
    if torchrun:
        pre += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"]
    return subprocess.run(pre + LAUNCH + list(extra), capture_output=True,
                          text=True, env=env, timeout=TIMEOUT,
                          cwd=str(tmp_path))


def test_launcher_under_torchrun_matches_one_process(tmp_path):
    losses = {}
    for torchrun in (False, True):
        m = tmp_path / f"m{int(torchrun)}.json"
        proc = run_launcher(tmp_path, torchrun, "--metrics-out", str(m))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.count("final loss") == 1, proc.stdout
        losses[torchrun] = json.loads(m.read_text())["train"]["loss"]
    assert abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False]), \
        losses


def test_production_mesh_needs_256_ranks(tmp_path):
    proc = run_launcher(tmp_path, True, "--production-mesh")
    assert proc.returncode != 0
    assert "--production-mesh needs 256 ranks" in proc.stderr, \
        proc.stderr[-2000:]
    assert "this world has 2" in proc.stderr
