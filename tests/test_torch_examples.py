"""The port's four examples (``examples/*_torch.py``) on the CPU.

Each runs as a user would run it, in a subprocess with ``PYTHONPATH=src``
and the schedule cache pointed at a temporary file; all of them start
together when the first test asks for them:

* ``quickstart_torch.py`` prints the same lines as JAX's
  ``quickstart.py`` in its sections 1-3 (Conv4's exhaustive 2-level
  search, the energy breakdown, direct blocking against im2col+GEMM on
  the Xeon hierarchy), then the H100's tiles in section 4;
* ``serve_lm_torch.py --device cpu`` serves the three reduced archs with
  the paged engine agreeing with the static one (``matches-static``);
* ``train_lm_torch.py --device cpu`` passes its own convergence assert
  (the last loss below 0.8x the first) and the restart drill from the
  checkpoint taken every 50 steps, as JAX's example takes it (54 steps
  of 4 x 64 tokens; about 11 s);
* ``schedule_search_torch.py --hopper`` (no ``--measure``) prints Conv4's
  ranked tile candidates and persists the analytic winner; the default
  mode's co-design sweep is left to the quickstart's search.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import flash_tiles, matmul_tiles
from repro_torch.tune import OpSpec, ScheduleCache, candidates

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "recurrentgemma-9b", "mamba2-780m")
RUNS = {
    "quickstart": ("quickstart.py",),
    "quickstart_torch": ("quickstart_torch.py",),
    "serve": ("serve_lm_torch.py", "--device", "cpu"),
    "train": ("train_lm_torch.py", "--device", "cpu", "--steps", "54",
              "--batch", "4", "--seq-len", "64"),
    "search": ("schedule_search_torch.py", "--layer", "Conv4", "--hopper",
               "--cache", "conv4.json"),
    "train_tpu": ("train_lm_torch.py", "--device", "tpu"),
    "serve_lm_torch.py": ("serve_lm_torch.py",),
    "train_lm_torch.py": ("train_lm_torch.py",),
}
NO_CARD = {"serve_lm_torch.py", "train_lm_torch.py"}


def start(name: str, cwd: Path) -> subprocess.Popen:
    script, *args = RUNS[name]
    cwd.mkdir()
    extra = {"CUDA_VISIBLE_DEVICES": ""} if name in NO_CARD else {}
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "PYTHONDONTWRITEBYTECODE": "1", "OMP_NUM_THREADS": "2",
             "REPRO_TORCH_TUNE_CACHE": str(cwd / "torch.json"),
             "REPRO_TUNE_CACHE": str(cwd / "jax.json"), **extra},
        cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory) -> Path:
    return tmp_path_factory.mktemp("examples")


@pytest.fixture(scope="module")
def runs(run_dir):
    """Every run of this file, each in a directory of its own under
    ``run_dir``, started at once on first use: the file then takes about
    as long as its longest run, and no more CPU."""
    procs = {name: start(name, run_dir / name) for name in RUNS}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish(proc: subprocess.Popen, timeout: int = 300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    return out


def test_quickstart_sections_1_to_3_equal_jax(runs):
    """Every line before section 4 is the same, and section 4 names the
    H100 with the Hopper adapter's tiles."""
    want, got = (finish(runs[name]).splitlines()
                 for name in ("quickstart", "quickstart_torch"))
    cut_j = next(i for i, x in enumerate(want) if x.startswith("TPU"))
    cut_t = next(i for i, x in enumerate(got) if x.startswith("H100"))
    assert cut_t == cut_j > 10
    assert got[:cut_t] == want[:cut_j]
    assert any("pJ/MAC" in x for x in got[:cut_t])
    assert got[cut_t:] == [
        "H100 (SXM) tiles from the same blocking model:",
        "  4096x4096x4096 GEMM  (bm,bk,bn) = "
        f"{matmul_tiles(4096, 4096, 4096, 2)}",
        "  32k-context attention (block_q, block_kv) = "
        f"{flash_tiles(32768, 32768, 128, 2)}"]


def test_serve_lm_matches_static_on_cpu(runs):
    out = finish(runs["serve"])
    lines = [x for x in out.splitlines() if "matches-static=" in x]
    assert [x.split()[0] for x in lines] == list(ARCHS)
    for line in lines:
        assert "matches-static=True" in line, line
        assert "sampled[0]=[" in line and "greedy[0]=[" in line


def test_train_lm_converges_and_restarts_on_cpu(runs):
    """54 steps: the checkpoint every 50 steps (JAX's interval) is taken,
    and the drill resumes from it for the last 4."""
    out = finish(runs["train"])
    assert "training granite-3-8b-mini for 54 steps on cpu" in out
    first, last = (float(v) for v in
                   out.split("loss: ")[1].split()[0:3:2])
    assert last < 0.8 * first
    assert "restored checkpoint at step 50" in out
    assert out.rstrip().endswith("resumed OK")


def test_train_lm_refuses_an_unknown_device(runs):
    proc = runs["train_tpu"]
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 2 and "invalid choice: 'tpu'" in err


def test_schedule_search_hopper_lists_conv4_candidates(runs, run_dir):
    out = finish(runs["search"])
    cache = run_dir / "search" / "conv4.json"
    spec = OpSpec("conv2d", (56, 56, 128, 256, 3, 3), "bfloat16")
    ranked = candidates(spec)
    assert "Conv4 as conv2d(56, 56, 128, 256, 3, 3)" in out
    for i, s in enumerate(ranked):
        assert f"#{i}: tiles={s.tiles}" in out
    assert f"winner (analytic): tiles={ranked[0].tiles}" in out
    stored = ScheduleCache(str(cache)).lookup(spec, device="cpu")
    assert stored is not None and stored.tiles == ranked[0].tiles
    assert not (run_dir / "search" / "torch.json").exists()


@pytest.mark.parametrize("script", ["serve_lm_torch.py",
                                    "train_lm_torch.py"])
def test_examples_run_on_the_card_by_default(script, runs):
    """Without ``--device cpu`` the examples ask for the card: with none
    visible they raise before serving or training anything."""
    proc = runs[script]
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in err
    assert "matches-static" not in out and "loss:" not in out
