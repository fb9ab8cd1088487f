"""The port's dry run (``repro_torch.launch.dryrun``) on the fake process
group, each cell in a subprocess of its own (a fake world per process).

JAX's own two dry-run tests fail under JAX 0.9 (its mesh axes are
Explicit, and ``with_sharding_constraint`` refuses them); their claims
are checked here on the port:

* reduced gemma2-9b, ``tiny_train`` (seq 64, batch 8) on (4, 2) with
  ``model_ax`` 2: collective bytes > 0 (the tensor-parallel
  all-reduces exist);
* reduced granite on (4, 2): ``fsdp`` moves fewer collective bytes than
  ``tp_fsdp``.

And:

* granite-3-8b ``train_4k`` on 16 x 16 under ``tp_fsdp``: the bytes of
  every collective kind equal a closed form from the config and the
  specs (:func:`closed_form`);
* the argument bytes per rank equal the local shards' bytes, counted
  here from the specs;
* the artifact (through the CLI, into a temporary directory) has JAX's
  fields;
* the 2 x 16 x 16 mesh puts the batch on ("pod", "data");
* the SSD, RG-LRU, encoder-decoder and vision-prefix families'
  ``train_4k`` cells on 16 x 16 and the two ``long_500k`` cells (batch
  1: "data" maps to None) run, their argument bytes equal to the local
  shards' bytes counted here from the specs (the fp32 leaves' moments
  and the stub inputs' rows included), with all-reduces over the model
  axis.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the fields of repro/launch/dryrun.py's artifact (run_cell)
JAX_FIELDS = {"arch", "shape", "mesh", "kind", "parallelism", "remat",
              "n_devices", "memory", "lower_s", "compile_s", "ok", "flops",
              "bytes_accessed", "collective_bytes",
              "collective_bytes_total", "analysis_compile_s",
              "analysis_method"}
JAX_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def run_py(code: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *args], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


CELL = """
    import dataclasses, json, sys
    from repro_torch.configs import SHAPES, get_config, get_reduced
    from repro_torch.launch import dryrun
    arch, reduced, shape, seq, batch, mesh, par, model_ax = sys.argv[1:]
    cfg = (get_reduced if reduced == "1" else get_config)(arch)
    shp = SHAPES[shape]
    if int(seq):
        shp = dataclasses.replace(shp, name="tiny_train", seq_len=int(seq),
                                  global_batch=int(batch))
    dims = tuple(int(x) for x in mesh.split("x"))
    names = ("pod", "data", "model")[-len(dims):]
    r = dryrun.run_cell(cfg, shp, dims, names, par,
                        model_ax=int(model_ax) or None, verbose=False)
    print(json.dumps(r))
"""


def cell(arch, shape="train_4k", mesh="16x16", par="tp_fsdp",
         reduced=False, seq=0, batch=0, model_ax=0) -> dict:
    out = run_py(CELL, arch, "1" if reduced else "0", shape, str(seq),
                 str(batch), mesh, par, str(model_ax))
    return json.loads(out.strip().splitlines()[-1])


def test_tiny_gemma2_has_collectives():
    r = cell("gemma2-9b", reduced=True, seq=64, batch=8, mesh="4x2",
             model_ax=2)
    assert r["ok"] and r["collective_bytes"]["all-reduce"] > 0, r
    assert sum(r["collective_bytes"].values()) > 0


def test_fsdp_moves_fewer_bytes_than_tp_fsdp():
    totals = {par: cell("granite-3-8b", reduced=True, seq=64, batch=8,
                        mesh="4x2", par=par)["collective_bytes_total"]
              for par in ("tp_fsdp", "fsdp")}
    assert totals["fsdp"] < totals["tp_fsdp"], totals


def closed_form(cfg, b: int, s: int, d_ax: int, m: int) -> dict:
    """Per-rank collective bytes of one ``tp_fsdp`` train step of a tied,
    dense SwiGLU decoder whose kv heads do not split over the model axis
    (granite-3-8b at m = 16), remat "block", bf16.

    Weights: every layer's leaves with a "data" dimension are
    all-gathered over ``data`` in the forward and again in the backward's
    recompute (the gathered, model-local bytes ``w``), and their
    gradients reduce-scattered (``w / d_ax``); the embedding likewise,
    once for the lookup and once for the tied logits.  Activations
    (``act`` = the rank's b/d_ax x s x d_model bf16): a layer all-reduces
    wo's and w_down's partial sums forward, wo's again in the recompute
    (non-reentrant checkpointing stops recomputing after the last saved
    tensor, before the MLP's), and the inputs' gradients of the two
    column-parallel regions backward, plus the replicated kv weights'
    gradients; the vocab-parallel lookup and the logits' input add one
    each, the loss three fp32 (b/d_ax, s) reductions, the norm scales'
    gradients their bytes, and four fp32 scalars (the token count, the
    loss, the clip norm's two axis sets)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    two = 2                                            # bf16
    w = (d * hq * hd // m * 2 + d * hkv * hd * 2 + 3 * d * f // m) * two
    emb = T.L.padded_vocab(cfg, m) // m * d * two
    act = b // d_ax * s * d * two
    return {
        "all-gather": n * 2 * w + 2 * emb,
        "reduce-scatter": n * w // d_ax + 2 * emb // d_ax,
        "all-reduce": n * (5 * act + 2 * d * hkv * hd * two) + 2 * act
        + 3 * b // d_ax * s * 4 + (2 * n + 1) * d * two + 4 * 4,
        "all-to-all": 0, "collective-permute": 0}


def local_bytes(shapes, specs, sizes, mapping) -> int:
    """Bytes of a rank's shards, each dimension over the product of its
    axes' sizes."""
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(t, dict):
            [walk(t[k], s[k]) for k in t]
        elif isinstance(t, list):
            [walk(a, b) for a, b in zip(t, s)]
        else:
            spec = SH.translate_spec(s, mapping)
            ways = math.prod(sizes[a] for e in spec
                             for a in SH.entry_axes(e))
            total += t.numel() // ways * t.element_size()
    walk(shapes, specs)
    return total


def test_granite_train_4k_bytes_equal_closed_form():
    r = cell("granite-3-8b")
    cfg = get_config("granite-3-8b")
    assert cfg.tie_embeddings and cfg.n_kv_heads % 16 and cfg.remat == \
        "block"
    want = closed_form(cfg, 256, 4096, 16, 16)
    assert r["collective_bytes"] == want, (r["collective_bytes"], want)
    # the arguments: params, fp32 moments, step, the rank's batch rows
    sizes = {"data": 16, "model": 16}
    mapping = {"data": ("data",), "model": "model"}
    pb = local_bytes(T.param_shapes(cfg, 16), T.param_specs(cfg, 16),
                     sizes, mapping)
    rows = 256 // 16 * 4096 * 4 * 2                    # tokens, labels
    assert r["memory"]["argument_size_in_bytes"] == pb + 2 * 2 * pb + 4 \
        + rows
    assert r["memory"]["output_size_in_bytes"] >= pb + 2 * 2 * pb + 4
    assert r["flops"] > 0


def test_cli_artifact_has_jax_fields(tmp_path):
    run_py("""
        import sys
        from repro_torch.launch import dryrun
        dryrun.ARTIFACT_DIR = sys.argv[1]
        dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k",
                     "--force"])
    """, str(tmp_path))
    path = tmp_path / "granite-3-8b__decode_32k__16x16.json"
    r = json.loads(path.read_text())
    assert JAX_FIELDS <= set(r), JAX_FIELDS - set(r)
    assert set(r["memory"]) == JAX_MEMORY
    assert set(r["collective_bytes"]) == set(KINDS)
    assert r["ok"] and r["kind"] == "decode" and r["n_devices"] == 256
    for k in ("temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes"):
        assert r["memory"][k] is None
    cfg, shape = get_config("granite-3-8b"), SHAPES["decode_32k"]
    sizes = {"data": 16, "model": 16}
    mapping = {"data": ("data",), "model": "model"}
    b, L = shape.global_batch, shape.seq_len
    want = local_bytes(T.param_shapes(cfg, 16), T.param_specs(cfg, 16),
                       sizes, mapping) + local_bytes(
        T.cache_shapes(cfg, b, L, 16), T.cache_specs(cfg, b, L, 16), sizes,
        mapping) + b // 16 * 4
    assert r["memory"]["argument_size_in_bytes"] == want


def test_multi_pod_puts_the_batch_on_pod_and_data():
    r = cell("granite-3-8b", mesh="2x16x16")
    assert r["mapping"] == {"model": "model", "data": ["pod", "data"]}
    assert r["n_devices"] == 512 and r["ok"]
    cfg = get_config("granite-3-8b")
    sizes = {"pod": 2, "data": 16, "model": 16}
    mapping = {"data": ("pod", "data"), "model": "model"}
    pb = local_bytes(T.param_shapes(cfg, 16), T.param_specs(cfg, 16),
                     sizes, mapping)
    rows = 256 // 32 * 4096 * 4 * 2
    assert r["memory"]["argument_size_in_bytes"] == 5 * pb + 4 + rows


def fp32(tree):
    """The meta tensors of a tree as fp32 (AdamW's moments)."""
    if isinstance(tree, dict):
        return {k: fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-780m", "train_4k"), ("recurrentgemma-9b", "train_4k"),
    ("seamless-m4t-medium", "train_4k"), ("phi-3-vision-4.2b", "train_4k"),
    ("mamba2-780m", "long_500k"), ("recurrentgemma-9b", "long_500k")])
def test_family_cells_run_on_their_shards(arch, shape):
    r = cell(arch, shape)
    cfg, shp = get_config(arch), SHAPES[shape]
    sizes = {"data": 16, "model": 16}
    mapping = S.axis_mapping(cfg, shp, AbstractMesh((16, 16),
                                                    ("data", "model")))
    assert r["ok"] and r["mapping"] == {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in mapping.items()}, r
    assert mapping["data"] == (None if shp.global_batch == 1
                               else ("data",))
    pshapes, pspecs = T.param_shapes(cfg, 16), T.param_specs(cfg, 16)
    pb = local_bytes(pshapes, pspecs, sizes, mapping)
    if shp.kind == "train":
        bshapes, bspecs = S.batch_shapes(cfg, shp)
        assert ("enc_embeds" in bshapes) == cfg.is_encdec
        assert ("prefix_embeds" in bshapes) == bool(cfg.prefix_tokens)
        want = pb + 2 * local_bytes(fp32(pshapes), pspecs, sizes, mapping) \
            + 4 + local_bytes(bshapes, bspecs, sizes, mapping)
    else:
        b, n = shp.global_batch, shp.seq_len
        want = pb + local_bytes(T.cache_shapes(cfg, b, n, 16),
                                T.cache_specs(cfg, b, n, 16), sizes,
                                mapping) + b * 4
    assert r["memory"]["argument_size_in_bytes"] == want, (r["memory"], want)
    assert r["collective_bytes"]["all-reduce"] > 0, r["collective_bytes"]
    assert r["flops"] > 0
