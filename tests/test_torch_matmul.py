"""Port vs JAX: the blocked GEMM and the blocked-linear model path.

On CPU tensors the port's ``matmul_blocked`` runs its plain version,
``matmul_ref``; it is held against the JAX ``ops.matmul`` with the
Pallas kernel in interpret mode at dividing tiles.  Tolerances: fp32
within 1e-4 of the largest |output| (summation order); bf16 within 1e-2
relative, one rounding of the output.  The reduced granite-3-8b at fp32
with blocked linears on in both packages must give the same prefill
logits within 1e-4 (the JAX model's unblocked tolerance).  The CUDA
kernel itself is held against ``matmul_ref`` on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import matmul_blocked as MB
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.tune import set_schedule_observer

ARCH = "granite-3-8b"


def operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32))


@pytest.mark.parametrize("m,n,k,tiles", [
    (8, 256, 128, (8, 128, 128)), (32, 128, 256, (16, 128, 128)),
    (64, 384, 256, (32, 256, 128))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ref_matches_jax_blocked_kernel(m, n, k, tiles, dtype):
    a, b = operands(m, n, k, seed=m + n)
    want = np.asarray(jops.matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                                  tiles=tiles, interpret=True),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = MB.matmul_blocked(torch.from_numpy(a).to(tdt),
                            torch.from_numpy(b).to(tdt), bm=tiles[0],
                            bk=tiles[1], bn=tiles[2])
    assert got.dtype == tdt and got.shape == (m, n)
    got = got.float().numpy()
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * scale)


def test_ops_matmul_resolves_model_tiles_on_cpu():
    a, b = operands(48, 192, 320, seed=1)     # ragged for every tile
    seen = []
    prev = set_schedule_observer(lambda spec, s: seen.append((spec, s)))
    try:
        out = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    finally:
        set_schedule_observer(prev)
    assert [(s.op, s.dims, s.dtype) for s, _ in seen] == \
        [("matmul", (48, 192, 320), "float32")]
    torch.testing.assert_close(out, torch.from_numpy(a @ b), rtol=1e-5,
                               atol=1e-5)


def test_blocked_linear_switch(monkeypatch):
    monkeypatch.delenv("REPRO_BLOCKED_LINEAR", raising=False)
    assert not ops.blocked_linear_enabled()
    with ops.blocked_linear():
        assert ops.blocked_linear_enabled()
        with ops.blocked_linear(False):
            assert not ops.blocked_linear_enabled()
    monkeypatch.setenv("REPRO_BLOCKED_LINEAR", "1")
    assert ops.blocked_linear_enabled()
    x = torch.randn(2, 3, 16)
    w = torch.randn(16, 24)
    seen = []
    prev = set_schedule_observer(lambda spec, s: seen.append(spec.dims))
    try:
        y = ops.linear(x, w)
    finally:
        set_schedule_observer(prev)
    assert y.shape == (2, 3, 24) and seen == [(6, 24, 16)]


def test_footprints_and_traffic():
    assert MB.smem_bytes_required(128, 64, 128, 2) == 2 * (2 * 128 * 64) * 2
    assert MB.accumulators_per_thread(128, 128) == 64     # 8 x 32 threads
    assert MB.accumulators_per_thread(8, 64) == 4         # 16 thread-rows
    assert MB.accumulators_per_thread(16, 640) == 64      # 160 groups, 1 row
    assert MB.accumulators_per_thread(8, 2048) > 64       # wider than 256x4
    # A read once per grid column, B once per grid row, C written once
    assert MB.hbm_bytes(8, 4096, 4096, 8, 256, 64, 2) == \
        (8 * 4096 * 64 + 4096 * 4096 + 8 * 4096) * 2
    assert MB.hbm_bytes(20, 100, 30, 16, 64, 64, 4) == \
        (20 * 30 * 2 + 30 * 100 * 2 + 20 * 100) * 4


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def test_blocked_prefill_logits_match_jax(model):
    """Every projection of the 2-layer reduced model through the blocked
    GEMM in both packages (the JAX one in interpret mode)."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16),
                                               dtype=np.int32)
    with jops.blocked_linear(True):
        jlog, _ = JT.prefill(jcfg, jparams, jnp.asarray(tokens), max_seq=16)
    seen = []
    prev = set_schedule_observer(lambda spec, s: seen.append(spec.op))
    try:
        with ops.blocked_linear():
            logits, _ = T.prefill(cfg, params, torch.from_numpy(tokens),
                                  max_seq=16)
    finally:
        set_schedule_observer(prev)
    assert seen == ["matmul"] * 7 * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
