"""Port vs JAX: the paged serving engine, and the port's boundaries.

The workload restates ``benchmarks/serve_bench.py::make_workload`` (no
test imports ``benchmarks/``): 6 requests, prompt lengths in [8, 16],
heavy-tailed budgets up to 12 tokens, on the reduced granite-3-8b at
fp32 with page 8 and prefill chunk 8, so both whole-prompt joins and
chunked prefill occur.  Greedy streams must be token-identical.
"""

import ast
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
from repro.models import transformer as JT
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import PagedServeConfig as JPagedServeConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from repro_torch.serve.kv_cache import (SCRATCH_PAGE, PageAllocator,
                                        choose_page_size,
                                        choose_prefill_chunk)
from repro_torch.serve.lifecycle import RequestStatus

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
SETTINGS = dict(max_seq=64, max_batch=4, page_size=8, prefill_chunk=8)


def make_workload(vocab, n_requests=6, prompt_len=16, gen=12, seed=0):
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


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    # a random model with tied embeddings repeats its first token: the
    # residual stream is dominated by the token's own embedding.  A
    # smaller embedding lets the blocks steer the argmax, so every decode
    # step of the streams below carries information.
    tree["embed"] = {"embedding": tree["embed"]["embedding"] / 10}
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(cfg, tree, device="cpu")
    return jcfg, jparams, cfg, params


def port_engine(cfg, params, **kw):
    return PagedEngine(cfg, params, PagedServeConfig(
        **{**SETTINGS, **kw}, device="cpu"))


def test_engine_token_identical_to_jax(model):
    jcfg, jparams, cfg, params = model
    prompts, gens = make_workload(cfg.vocab)
    assert min(map(len, prompts)) <= 8 < max(map(len, prompts))
    jeng = JPagedEngine(jcfg, jparams, JPagedServeConfig(**SETTINGS,
                                                         spec_decode=0))
    eng = port_engine(cfg, params)
    want = run(jeng, prompts, gens)
    got = run(eng, prompts, gens)
    for w, g, n in zip(want, got, gens):
        assert g.status is RequestStatus.OK and len(g.output) == n
        np.testing.assert_array_equal(g.output, w.output)
    assert len({int(t) for r in got for t in r.output}) > len(got)


def test_final_chunk_spilling_past_max_seq_matches_jax(model):
    """max_seq 60 with 16-token chunks: the last chunk of a 57-token
    prompt is 9 tokens padded to a 16-wide span, whose positions 60..63
    write into the scratch page."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in (57, 30)]
    gens = [3, 4]
    kw = dict(max_seq=60, max_batch=2, page_size=8, prefill_chunk=16)
    want = run(JPagedEngine(jcfg, jparams, JPagedServeConfig(
        **kw, spec_decode=0)), prompts, gens)
    got = run(PagedEngine(cfg, params, PagedServeConfig(**kw, device="cpu")),
              prompts, gens)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.output, w.output)


def test_chunked_prefill_matches_whole_prompt_joins(model):
    _, _, cfg, params = model
    prompts, gens = make_workload(cfg.vocab, seed=1)
    chunked = run(port_engine(cfg, params, prefill_chunk=8), prompts, gens)
    whole = run(port_engine(cfg, params, prefill_chunk=0), prompts, gens)
    for a, b in zip(chunked, whole):
        np.testing.assert_array_equal(a.output, b.output)


@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_generate_frees_every_page(model, prefill_chunk):
    _, _, cfg, params = model
    eng = port_engine(cfg, params, prefill_chunk=prefill_chunk)
    prompts, _ = make_workload(cfg.vocab, seed=2)
    out = eng.generate(prompts, 5)
    assert out.shape == (len(prompts), 5)
    assert eng.scheduler.allocator.in_use() == 0
    assert not eng.scheduler.running and not eng.scheduler.waiting


def test_allocator_scratch_page_and_double_free():
    a = PageAllocator(4)
    pages = a.alloc_many(3)
    assert SCRATCH_PAGE not in pages and a.available() == 0
    with pytest.raises(MemoryError):
        a.alloc()
    a.free_many(pages)
    with pytest.raises(ValueError):
        a.free(pages[0])
    assert a.in_use() == 0


@pytest.mark.parametrize("option", [
    dict(spec_decode=2), dict(prefix_cache=True),
    dict(nan_guard=True), dict(preempt=True), dict(degrade=True)])
def test_serving_options_construct_and_serve(model, option):
    """Each serving feature of JAX's ``PagedServeConfig`` constructs and
    serves the workload on the CPU, token-identical to the engine
    without it (``test_torch_serve_features.py`` holds each to JAX)."""
    _, _, cfg, params = model
    prompts, gens = make_workload(cfg.vocab, seed=5)
    eng = port_engine(cfg, params, **option)
    got = run(eng, prompts, gens)
    want = run(port_engine(cfg, params), prompts, gens)
    for g, w, n in zip(got, want, gens):
        assert g.status is RequestStatus.OK and len(g.output) == n
        np.testing.assert_array_equal(g.output, w.output)
    assert eng.scheduler.allocator.in_use() == \
        (len(eng.prefix_cache) if eng.prefix_caching else 0)


@pytest.mark.parametrize("unset", ["page_size", "prefill_chunk", "both"])
def test_model_chosen_page_and_chunk_match_jax(model, unset, capsys):
    """Left unset, the page and the chunk come from the blocking model:
    the page tiles max_seq in whole pages, the chunk is a power-of-two
    number of pages within max_seq, and the engine is token-identical to
    the JAX PagedEngine given those values explicitly."""
    jcfg, jparams, cfg, params = model
    kw = dict(page_size=None, prefill_chunk=None) if unset == "both" \
        else {unset: None}
    eng = port_engine(cfg, params, **kw)
    assert "blocking model" in capsys.readouterr().out
    page, chunk = eng.page_size, eng.prefill_chunk
    snap = eng.metrics.snapshot()["engine"]
    assert (snap["page_size"], snap["prefill_chunk"]) == (page, chunk)
    if unset != "prefill_chunk":
        assert page == choose_page_size(cfg, SETTINGS["max_seq"])
        assert SETTINGS["max_seq"] % page == 0
    if unset != "page_size":
        assert chunk == choose_prefill_chunk(cfg, SETTINGS["max_seq"], page)
        blocks = chunk // page
        assert chunk % page == 0 and blocks & (blocks - 1) == 0
        assert chunk <= SETTINGS["max_seq"]
    prompts, gens = make_workload(cfg.vocab, seed=4)
    jeng = JPagedEngine(jcfg, jparams, JPagedServeConfig(
        **{**SETTINGS, "page_size": page, "prefill_chunk": chunk},
        spec_decode=0))
    for w, g in zip(run(jeng, prompts, gens), run(eng, prompts, gens)):
        np.testing.assert_array_equal(g.output, w.output)


def test_serve_cli_runs_without_page_size_or_chunk():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--dtype", "float32",
         "--requests", "3", "--prompt-len", "12", "--gen", "4",
         "--max-seq", "64", "--batch", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    page = choose_page_size(get_reduced(ARCH), 64)
    assert f"page={page} " in res.stdout
    assert "statuses: ok" in res.stdout


def test_engine_defaults_to_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, cfg, params = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(cfg, params, PagedServeConfig(**SETTINGS))


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_importing_every_port_module_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
