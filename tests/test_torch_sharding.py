"""Port vs JAX: the distribution layer's pure functions, exactly.

No process group: JAX's side runs on ``jax.sharding.AbstractMesh`` (a
mesh without devices), the port's on ``launch.mesh.AbstractMesh``.

* ``param_specs`` and ``cache_specs`` of all ten archs at ``model_ax``
  1, 2 and 16, and ``param_shapes``/``cache_shapes``, leaf for leaf
  (JAX stacks each pattern entry's layers under a leading unsharded
  axis; the port keeps one entry per layer: the JAX leaf without that
  axis is the port's layer leaf);
* ``padded_vocab`` at every ``model_ax`` of those;
* ``translate_spec``/``translate_tree`` under every mapping the cells
  produce;
* ``axis_mapping`` for every cell of ``cells()`` on the 16 x 16, 2 x 16 x
  16 and 4 x 2 meshes under both parallelisms; ``data_axes`` and
  ``batch_divisor``; ``cells()``; ``batch_shapes``;
* ``plan_mesh`` for all ten archs at 1 to 512 ranks;
* the head plan of the sharded attention at the production mesh's
  ``model_ax`` (the local query heads each on their own kv head);
* ``layer_cache_defs`` of every layer (the cross K/V included, and the
  position-indexed ``full_kv`` form against JAX's ``attention_cache_defs``
  without a window) and ``serve.kv_cache.paged_cache_defs`` against
  JAX's ``cache_defs`` and ``paged_cache_defs`` (its pools JAX's
  ``paged_attention_cache_defs``), shape, spec and dtype, for all ten
  archs at ``model_ax`` 1, 2 and 16;
* ``launch.train --arch recurrentgemma-9b --reduced`` under
  ``torch.distributed.run --nproc-per-node 2 --device cpu`` gives the
  one-process final loss (1e-5 relative).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.launch import elastic as JE
from repro.launch import mesh as JM
from repro.launch import shapes as JS
from repro.models import layers as JL
from repro.models import sharding as JSH
from repro.models import transformer as JT
from repro.models.base import ParamDef as JParamDef
from repro.serve import kv_cache as JKV
from repro_torch import configs as C
from repro_torch.launch import elastic as E
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as S
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KV

ARCHS = sorted(JC.ARCHS)
MODEL_AXES = (1, 2, 16)
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")))


def norm(spec) -> tuple:
    """A spec (either package's) as a plain tuple of entries; an entry
    of one axis as that axis (JAX 0.9's ``PartitionSpec`` writes
    ``("data",)`` so, and both mean the same split)."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in tuple(spec))


def jax_layers(cfg, tree, unstack):
    """JAX's stacked ``layers``/``tail`` (and encoder) as the port's one
    entry per layer: ``unstack(leaf)`` drops the stacking axis."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return unstack(t)
    pattern = cfg.layer_pattern
    n_groups = cfg.n_layers // len(pattern)
    layers = [walk(tree["layers"][j]) for _ in range(n_groups)
              for j in range(len(pattern))]
    layers += list(tree["tail"])
    out = {k: v for k, v in tree.items() if k not in ("layers", "tail")}
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {**enc, "layers": [walk(enc["layers"])] *
                          cfg.encoder_layers}
    return out


def plain(tree):
    """A tree of specs or shapes (either package's) as nested dicts
    (sorted), lists and tuples: specs as their entries, tensors and
    ``ShapeDtypeStruct`` s as their shapes."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [plain(v) for v in tree]
    if isinstance(tree, (JP, SH.P)):
        return ("spec",) + norm(tree)
    if isinstance(tree, tuple):
        return ("shape",) + tree
    return ("shape",) + tuple(tree.shape)


def strip_spec(s):
    assert tuple(s)[0] is None
    return JP(*tuple(s)[1:])


def strip_shape(s):
    return tuple(s.shape[1:])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("model_ax", MODEL_AXES)
def test_param_specs_and_shapes_equal_jax(arch, model_ax):
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    want = jax_layers(jcfg, JT.param_specs(jcfg, model_ax), strip_spec)
    assert plain(T.param_specs(cfg, model_ax)) == plain(want)
    shapes = T.param_shapes(cfg, model_ax)
    assert plain(shapes) == plain(jax_layers(
        jcfg, JT.param_shapes(jcfg, model_ax), strip_shape))
    assert all(t.device.type == "meta" for t in spmd_leaves(shapes))


def spmd_leaves(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            [walk(v) for v in t.values()]
        elif isinstance(t, list):
            [walk(v) for v in t]
        else:
            out.append(t)
    walk(tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("model_ax", MODEL_AXES)
def test_cache_specs_and_shapes_equal_jax(arch, model_ax):
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    enc = cfg.encoder_seq
    for batch, max_seq in ((128, 32768), (4, 24), (2, 25)):
        want = JT.cache_specs(jcfg, batch, max_seq, model_ax, enc)
        got = T.cache_specs(cfg, batch, max_seq, model_ax, enc)
        assert plain(got) == plain(jax_layers(jcfg, want, strip_spec)), \
            (batch, max_seq)
        want = JT.cache_shapes(jcfg, batch, max_seq, model_ax, enc)
        got = T.cache_shapes(cfg, batch, max_seq, model_ax, enc)
        assert plain(got) == plain(jax_layers(jcfg, want, strip_shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_vocab_equals_jax(arch):
    for m in (1, 2, 4, 8, 16, 32):
        assert L.padded_vocab(C.get_config(arch), m) == \
            JL.padded_vocab(JC.get_config(arch), m)
    assert L.padded_vocab(C.get_config(arch)) == \
        JL.padded_vocab(JC.get_config(arch), 1)


@pytest.mark.parametrize("shape,names", MESHES)
def test_axis_mapping_equals_jax_on_every_cell(shape, names):
    assert C.cells() == JC.cells()
    jmesh = JAbstractMesh(shape, names)
    mesh = M.AbstractMesh(shape, names)
    assert M.data_axes(mesh) == JM.data_axes(jmesh)
    assert M.batch_divisor(mesh) == JM.batch_divisor(jmesh)
    specs = [JP("data", None), JP(None, "model"), JP("model", "data"),
             JP(("data", "model"), None), JP("data", None, "model", None),
             JP(None), JP()]
    for arch, sname in JC.cells():
        for par in ("tp_fsdp", "fsdp"):
            want = JS.axis_mapping(JC.get_config(arch), JC.SHAPES[sname],
                                   jmesh, par)
            got = S.axis_mapping(C.get_config(arch), C.SHAPES[sname], mesh,
                                 par)
            assert got == want, (arch, sname, par)
            for s in specs:
                assert norm(SH.translate_spec(SH.P(*tuple(s)), got)) == \
                    norm(JSH.translate_spec(s, want)), (s, got)


def test_shapes_and_cells_equal_jax():
    assert C.cells() == JC.cells()
    assert set(C.SHAPES) == set(JC.SHAPES)
    for name, s in JC.SHAPES.items():
        p = C.SHAPES[name]
        assert (p.name, p.seq_len, p.global_batch, p.kind) == \
            (s.name, s.seq_len, s.global_batch, s.kind)
    for arch in ARCHS:
        assert C.long_context_ok(C.get_config(arch)) == \
            JC.long_context_ok(JC.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shapes_equal_jax(arch):
    for sname in ("train_4k", "prefill_32k"):
        jsh, jsp = JS.batch_shapes(JC.get_config(arch), JC.SHAPES[sname])
        sh, sp = S.batch_shapes(C.get_config(arch), C.SHAPES[sname])
        assert set(sh) == set(jsh)
        for k in jsh:
            assert tuple(sh[k].shape) == tuple(jsh[k].shape)
            assert str(sh[k].dtype).split(".")[-1] == str(
                np.dtype(jsh[k].dtype)) or (
                sh[k].dtype == torch.bfloat16 and
                str(jsh[k].dtype) == "bfloat16"), (k, sh[k].dtype)
            assert norm(sp[k]) == norm(jsp[k])


def test_translate_tree_equals_jax():
    jcfg, cfg = JC.get_config("qwen3-moe-235b-a22b"), \
        C.get_config("qwen3-moe-235b-a22b")
    for mapping in ({"data": ("pod", "data"), "model": "model"},
                    {"data": None, "model": "model"},
                    {"data": ("data", "model"), "model": None},
                    {"data": ("data",)}):
        want = jax_layers(jcfg, JSH.translate_tree(JT.param_specs(jcfg, 16),
                                                   mapping), strip_spec)
        got = SH.translate_tree(T.param_specs(cfg, 16), mapping)
        assert plain(got) == plain(want), mapping


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_mesh_equals_jax(arch):
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    for n in range(1, 513):
        j = JE.plan_mesh(jcfg, n)
        p = E.plan_mesh(cfg, n)
        assert (p.n_devices, p.data, p.model, p.shape) == \
            (j.n_devices, j.data, j.model, j.shape), n


class _Ctx:
    """A MeshContext stand-in: ``head_plan`` reads ``model_ax`` and this
    rank's index on the model axis."""
    def __init__(self, m, r):
        self.model_ax, self.model_group, self._r = m, object(), r


@pytest.mark.parametrize("arch", ["granite-3-8b", "glm4-9b", "granite-34b",
                                  "gemma2-9b", "qwen3-moe-235b-a22b",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("m", [2, 4, 16])
def test_head_plan_maps_every_query_head_to_its_kv_head(arch, m,
                                                        monkeypatch):
    cfg = C.get_config(arch)
    g = cfg.n_heads // cfg.n_kv_heads
    seen = []
    for r in range(m):
        monkeypatch.setattr(spmd, "group_index", lambda grp, r=r: r)
        q0, hq, kv = spmd.head_plan(cfg, _Ctx(m, r))
        gl = hq // len(kv)
        assert hq % len(kv) == 0
        for i in range(hq):
            assert kv[i // gl] == (q0 + i) // g, (r, i)
        seen += list(range(q0, q0 + hq))
    sq, _ = L.attention_specs(cfg, m)
    want = list(range(cfg.n_heads)) if sq else list(range(cfg.n_heads)) * m
    assert seen == want


def test_local_shape_and_maybe_shard():
    sizes = {"data": 4, "model": 2}
    spec = SH.P("data", "model")
    assert SH.local_shape((8, 6), spec, sizes) == (2, 3)
    assert SH.local_shape((8, 6), SH.P(("data", "model"), None),
                          sizes) == (1, 6)
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shape((6, 6), spec, sizes)
    x = torch.zeros(2, 3)
    assert SH.maybe_shard(x, spec, (8, 6)) is x     # off a mesh: as is


def pdef(d) -> tuple:
    """A ParamDef (either package's) as (shape, spec entries, dtype
    name)."""
    dt = str(d.dtype).split(".")[-1] if isinstance(d.dtype, torch.dtype) \
        else np.dtype(d.dtype).name
    spec = tuple(d.spec) + (None,) * (len(d.shape) - len(tuple(d.spec)))
    return tuple(d.shape), norm(spec), dt


def unstack_def(d: JParamDef) -> JParamDef:
    assert tuple(d.spec)[0] is None
    return JParamDef(tuple(d.shape[1:]), JP(*tuple(d.spec)[1:]), d.scale,
                     d.dtype, d.init)


def defs_plain(tree):
    if isinstance(tree, dict):
        return {k: defs_plain(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [defs_plain(v) for v in tree]
    return pdef(tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("model_ax", MODEL_AXES)
def test_layer_and_paged_cache_defs_equal_jax(arch, model_ax):
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    enc = cfg.encoder_seq if cfg.is_encdec else None
    for batch, max_seq in ((128, 32768), (4, 24), (2, 7)):
        want = jax_layers(jcfg, JT.cache_defs(jcfg, batch, max_seq,
                                              model_ax, cfg.encoder_seq),
                          unstack_def)["layers"]
        for i in range(cfg.n_layers):
            got = T.layer_cache_defs(cfg, i, batch, max_seq, model_ax,
                                     enc_seq=enc)
            assert defs_plain(got) == defs_plain(want[i]), (i, batch)
            if cfg.mixer_for_layer(i) in T.ATTENTION:
                full = T.layer_cache_defs(cfg, i, batch, max_seq, model_ax,
                                          full_kv=True)
                assert defs_plain(full) == defs_plain(
                    JL.attention_cache_defs(jcfg, batch, max_seq, model_ax,
                                            None))
    if cfg.is_encdec or cfg.prefix_tokens:
        for fn, c in ((JKV.paged_cache_defs, jcfg),
                      (KV.paged_cache_defs, cfg)):
            with pytest.raises(NotImplementedError, match="decoder-only"):
                fn(c, 4, 16, 8, model_ax)
        return
    want = jax_layers(jcfg, JKV.paged_cache_defs(jcfg, 4, 16, 8, model_ax),
                      unstack_def)["layers"]
    got = KV.paged_cache_defs(cfg, 4, 16, 8, model_ax)
    attn = T.attention_layers(cfg)
    for name in ("k_pages", "v_pages"):
        assert got[name].shape[0] == len(attn) and \
            tuple(got[name].spec)[0] is None
    pool = {n: unstack_def(got[n]) for n in ("k_pages", "v_pages")}
    for i in range(cfg.n_layers):
        if i in attn:
            assert got["layers"][i] == {}
            assert defs_plain(pool) == defs_plain(want[i]), i
        else:
            assert defs_plain(got["layers"][i]) == defs_plain(want[i]), i
    skv = "model" if model_ax > 1 and cfg.n_kv_heads % model_ax == 0 \
        else None
    assert pdef(pool["k_pages"])[1] == (None, None, skv, None)


def test_launcher_under_torchrun_trains_recurrentgemma(tmp_path):
    """The RG-LRU hybrid (its width split over no model axis: the host
    mesh is data-only) through ``launch.train`` on 2 gloo ranks and in
    one process: the same final loss."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "recurrentgemma-9b",
            "--reduced", "--device", "cpu", "--dtype", "float32", "--steps",
            "3", "--seq-len", "16", "--batch", "4"]
    losses = {}
    for torchrun in (False, True):
        pre = [sys.executable] + (["-m", "torch.distributed.run",
                                   "--standalone", "--nproc-per-node", "2"]
                                  if torchrun else [])
        m = tmp_path / f"m{int(torchrun)}.json"
        proc = subprocess.run(pre + args + ["--metrics-out", str(m)],
                              capture_output=True, text=True, env=env,
                              timeout=240, cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.count("final loss") == 1, proc.stdout
        losses[torchrun] = json.loads(m.read_text())["train"]["loss"]
    assert abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False]), \
        losses
