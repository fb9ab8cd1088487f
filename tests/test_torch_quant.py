"""Port vs JAX: the quantized serving path (``--quantize w8 | fp8kv |
w8fp8``).

``quantize`` and the fp32 -> e4m3 cast byte for byte; ``quantize_params``
through ``params_from_numpy``; each quantized op's plain version (what
the port runs on CPU tensors) against the JAX package's Pallas kernel in
interpret mode and against its oracle; the routing of ``ops``; the fp8
page key; and the quantized ``PagedEngine`` token for token against the
JAX one.  Inputs are drawn with numpy from a seed and handed to both
packages, in fp32 on the CPU.

Tolerances: a single product is held within 1e-5 abs + 1e-4 rel; a sum
over K terms within ``max(1e-5, 2e-6 * sqrt(K))`` abs + 1e-4 rel (a random
walk of fp32 roundings of O(1) partial sums, with margin), as in
``test_torch_fused.py``.  The port's int8 product is ``(a @ q) * s``, JAX's
CPU ``linear`` ``a @ (q * s)``: at fp32 the two agree far inside that.
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
from repro.kernels.flash_decode import flash_decode_fp8 as j_decode_fp8
from repro.kernels.flash_decode import \
    paged_attention_fp8_ref as j_decode_fp8_ref
from repro.kernels.matmul_fused import matmul_fused as j_matmul_fused
from repro.kernels.matmul_q import matmul_w8 as j_matmul_w8
from repro.kernels.matmul_q import matmul_w8_ref as j_matmul_w8_ref
from repro.models import transformer as JT
from repro.quant import QuantizedTensor as JQuantizedTensor
from repro.quant import quantize as j_quantize
from repro.quant import quantize_params as j_quantize_params
from repro.quant import quantized_bytes as j_quantized_bytes
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import PagedServeConfig as JPagedServeConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (flash_decode_fp8,
                                              paged_attention_fp8_ref)
from repro_torch.kernels.matmul_fused import matmul_fused, matmul_fused_ref
from repro_torch.kernels.matmul_q import matmul_w8, matmul_w8_ref
from repro_torch.models import transformer as T
from repro_torch.quant import (QuantizedTensor, dequantize_params,
                               fake_quant, quantize, quantize_params,
                               quantized_bytes)
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from repro_torch.serve.lifecycle import RequestStatus

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
SETTINGS = dict(max_seq=64, max_batch=4, page_size=8, prefill_chunk=8)
FP8 = torch.float8_e4m3fn


def tol(k: int) -> dict:
    return dict(atol=max(1e-5, 2e-6 * k ** 0.5), rtol=1e-4)


def close(got: torch.Tensor, want, k: int = 1) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(k))


def t(a):
    return torch.from_numpy(np.array(a))


def fp8_bytes(x) -> np.ndarray:
    """The bytes of an fp8 torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def numpy_tree(tree):
    """A JAX param tree as numpy, each JAX ``QuantizedTensor`` as the
    ``{"q", "scale"}`` leaf ``params_from_numpy`` takes."""
    def leaf(x):
        if isinstance(x, JQuantizedTensor):
            return {"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JQuantizedTensor))


# ------------------------------- quantize -----------------------------------


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("reduce_axis", [-2, None],
                         ids=["per_channel", "per_tensor"])
def test_quantize_bytes_and_scales_equal_jax(dtype, reduce_axis):
    """The same fp32 input gives the same payload bytes and fp32 scales:
    ``absmax / qmax + eps``, ``x / scale``, round half to even (int8) or
    the e4m3 cast (fp8).  Exact ties (x / scale = k + 0.5) are included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 48, 40)).astype(np.float32)
    x[0, 0, :] = np.arange(40) - 20.5       # column absmax 20.5: ties
    got = quantize(t(x), dtype, reduce_axis)
    want = j_quantize(jnp.asarray(x), dtype, reduce_axis)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale.dtype == torch.float32
    if dtype == "int8":
        assert got.q.dtype == torch.int8
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    else:
        assert got.q.dtype == FP8
        np.testing.assert_array_equal(fp8_bytes(got.q), fp8_bytes(want.q))
    np.testing.assert_array_equal(got.dequant().numpy(),
                                  np.asarray(want.dequant()))
    close(fake_quant(t(x), dtype, reduce_axis),
          np.asarray(want.dequant(jnp.float32)))


def test_fp32_to_e4m3_cast_is_byte_equal_to_jax():
    """Both frameworks round to nearest even and neither saturates inside
    the finite range: the cast every fp8 page write makes.  Values cover
    the normal and subnormal range of e4m3 (smallest subnormal 2^-9),
    exact midpoints between neighbours, signed zeros and the largest
    finite value."""
    rng = np.random.default_rng(1)
    e4m3 = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn)
    grid = np.sort(e4m3[np.isfinite(e4m3.astype(np.float32))]
                   .astype(np.float32))
    mids = (grid[:-1] + grid[1:]) / 2
    x = np.concatenate([
        grid, mids, np.float32([0.0, -0.0, 448.0, -448.0, 2.0 ** -10]),
        rng.standard_normal(2000).astype(np.float32) * 50,
        rng.standard_normal(2000).astype(np.float32) * 1e-2]).astype(
            np.float32)
    x = x[np.abs(x) <= 448]
    got = t(x).to(FP8)
    want = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(fp8_bytes(got), fp8_bytes(want))


# ---------------------------- quantized params ------------------------------


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
    jq = j_quantize_params(jparams)
    qparams = params_from_numpy(cfg, numpy_tree(jq), device="cpu")
    return jcfg, jparams, jq, cfg, params, qparams


def test_quantize_params_equals_jax_layer_by_layer(model):
    """``quantize_params`` on the port's per-layer tree gives JAX's int8
    payloads and fp32 scales, layer by layer, and ``params_from_numpy``
    carries JAX's quantized tree over unchanged (payload kept int8, the
    stacked (G, 1, N) scale unstacked to each layer's (1, N), neither
    cast to the model dtype); ``quantized_bytes`` agrees too."""
    _, _, jq, cfg, params, qparams = model
    mine = quantize_params(params)
    for i in range(cfg.n_layers):
        for node in ("mixer", "ffn"):
            for key, leaf in mine["layers"][i][node].items():
                conv = qparams["layers"][i][node][key]
                jleaf = jq["layers"][0][node][key]
                assert isinstance(leaf, QuantizedTensor)
                assert isinstance(conv, QuantizedTensor)
                assert leaf.dtype == conv.dtype == torch.int8
                assert conv.scale.dtype == torch.float32
                assert tuple(conv.scale.shape) == (1, leaf.shape[1])
                np.testing.assert_array_equal(leaf.q.numpy(),
                                              np.asarray(jleaf.q[i]))
                np.testing.assert_array_equal(leaf.scale.numpy(),
                                              np.asarray(jleaf.scale[i]))
                np.testing.assert_array_equal(conv.q.numpy(),
                                              leaf.q.numpy())
                np.testing.assert_array_equal(conv.scale.numpy(),
                                              leaf.scale.numpy())
        for norm in ("norm1", "norm2"):
            assert isinstance(mine["layers"][i][norm]["scale"],
                              torch.Tensor)
    assert isinstance(mine["embed"]["embedding"], torch.Tensor)
    assert quantized_bytes(mine) == j_quantized_bytes(jq)
    assert quantized_bytes(qparams) == j_quantized_bytes(jq)
    wide = dequantize_params(mine)
    np.testing.assert_array_equal(
        wide["layers"][1]["ffn"]["w_up"].numpy(),
        np.asarray(jq["layers"][0]["ffn"]["w_up"].dequant())[1])


def test_quantize_params_keeps_router_and_cross_nodes_wide():
    """JAX's rules, though granite has neither: a node with a ``router``
    leaf (an MoE expert bank) and a ``cross`` node stay as they are."""
    w = torch.ones(4, 8)
    tree = {"moe": {"router": w, "w_up": w}, "cross": {"wq": w},
            "mixer": {"wq": w, "bias": torch.ones(8)}}
    out = quantize_params(tree)
    assert out["moe"]["w_up"] is w and out["cross"]["wq"] is w
    assert isinstance(out["mixer"]["wq"], QuantizedTensor)
    assert out["mixer"]["bias"] is tree["mixer"]["bias"]


# ------------------------------- matmul_w8 ----------------------------------


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (8, 128, 48)])
def test_matmul_w8_matches_jax_kernel(per_channel, m, k, n):
    """The plain version (the CPU path of the wrapper and of
    ``ops.matmul_w8``) against JAX's Pallas kernel in interpret mode at
    dividing tiles, and against JAX's oracle."""
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.uniform(0.005, 0.05, n if per_channel else 1)
             * k ** -0.5).astype(np.float32)
    s = scale if per_channel else scale[0]
    want = j_matmul_w8(jnp.asarray(a), jnp.asarray(w_q), jnp.asarray(s),
                       bm=8, bk=32, bn=16, interpret=True)
    oracle = j_matmul_w8_ref(jnp.asarray(a), jnp.asarray(w_q),
                             jnp.asarray(s))
    for got in (matmul_w8(t(a), t(w_q), t(s), bm=8, bk=32, bn=16),
                matmul_w8_ref(t(a), t(w_q), t(s)),
                ops.matmul_w8(t(a), t(w_q), t(s))):
        assert got.shape == (m, n) and got.dtype == torch.float32
        close(got, want, k)
        close(got, oracle, k)


def test_quantized_linear_matches_jax_linear():
    """``ops.linear`` over a 2-D int8 ``QuantizedTensor`` with leading
    dims: the port's int8 GEMM, ``(a @ q) * s``, against JAX's CPU
    ``linear``, ``a @ (q * s)``; and an fp8 payload, which both take as
    the dequantized product."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    for dtype in ("int8", "fp8"):
        jw = j_quantize(jnp.asarray(w), dtype)
        mw = quantize(t(w), dtype)
        want = jops.linear(jnp.asarray(x), jw)
        for use_kernel in (True, False):
            got = ops.linear(t(x), mw, use_kernel)
            assert got.shape == (2, 5, 48)
            close(got, want, 64)


# ------------------------------ matmul_fused --------------------------------


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("epi", [dict(), dict(bias=True, mul=True,
                                              residual=True)],
                         ids=["scale_only", "all"])
def test_int8_matmul_fused_matches_jax_kernel(act, epi):
    """The int8 variant: JAX's fused kernel with an int8 W and its scale
    in interpret mode, against the port's plain version and the CPU paths
    of the wrapper and of ``ops.matmul_fused`` with a QuantizedTensor."""
    rng = np.random.default_rng(4)
    m, k, n = 16, 64, 32
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / 8).astype(np.float32)
    qw = quantize(t(w))
    scale = qw.scale.reshape(-1).numpy()
    kw = {name: rng.standard_normal(shape).astype(np.float32)
          for name, shape in (("bias", (n,)), ("mul", (m, n)),
                              ("residual", (m, n))) if epi.get(name)}
    want = j_matmul_fused(jnp.asarray(a), jnp.asarray(qw.q.numpy()),
                          scale=jnp.asarray(scale), act=act, bm=8, bk=32,
                          bn=16, interpret=True,
                          **{x: jnp.asarray(v) for x, v in kw.items()})
    tkw = {x: t(v) for x, v in kw.items()}
    for got in (matmul_fused_ref(a=t(a), w=qw.q, scale=t(scale), act=act,
                                 **tkw),
                matmul_fused(t(a), qw.q, t(scale), act=act, bm=8, bk=32,
                             bn=16, **tkw),
                ops.matmul_fused(t(a), qw, act=act, **tkw)):
        close(got, want, k)


def test_ops_quantized_fused_ops_take_jax_routes():
    """``qkv_fused`` over quantized weights is three ``linear`` calls and
    ``matmul_fused`` over an fp8 payload the dequantized product, as in
    JAX (whose CPU ops give the reference)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ws = [(rng.standard_normal((64, c)) / 8).astype(np.float32)
          for c in (64, 32, 32)]
    got = ops.qkv_fused(t(x), *[quantize(t(w)) for w in ws])
    want = jops.qkv_fused(jnp.asarray(x),
                          *[j_quantize(jnp.asarray(w)) for w in ws])
    for o, w_ in zip(got, want):
        close(o, w_, 64)
    w8 = ws[0]
    got = ops.matmul_fused(t(x), quantize(t(w8), "fp8"), act="silu")
    want = jops.matmul_fused(jnp.asarray(x),
                             j_quantize(jnp.asarray(w8), "fp8"), act="silu")
    close(got, want, 64)


# ---------------------------- flash_decode_fp8 ------------------------------


def fp8_case(q_span=1, seed=6):
    rng = np.random.default_rng(seed)
    b, hkv, g, d, page, nb = 3, 2, 3, 16, 8, 5
    n_pages = b * nb + 1
    q = rng.standard_normal((b, hkv, q_span * g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb).reshape(b, nb)).astype(np.int32)
    lengths = np.array([1, 13, 40 - q_span + 1], np.int32)
    ks = rng.uniform(0.5, 2.0, hkv).astype(np.float32)
    vs = rng.uniform(0.5, 2.0, hkv).astype(np.float32)
    kp8 = jnp.asarray(kp).astype(jnp.float8_e4m3fn)
    vp8 = jnp.asarray(vp).astype(jnp.float8_e4m3fn)
    tk8 = t(fp8_bytes(kp8)).view(FP8)
    tv8 = t(fp8_bytes(vp8)).view(FP8)
    return ((jnp.asarray(q), kp8, vp8, jnp.asarray(ks), jnp.asarray(vs),
             jnp.asarray(bt), jnp.asarray(lengths)),
            (t(q), tk8, tv8, t(ks), t(vs), t(bt), t(lengths)))


@pytest.mark.parametrize("q_span", [1, 4])
@pytest.mark.parametrize("window,cap", [(None, None), (7, None),
                                        (None, 30.0), (5, 20.0)])
def test_flash_decode_fp8_matches_jax_kernel(q_span, window, cap):
    """Non-unit per-head scales, window, logit cap and a multi-position
    span: the plain version against JAX's fp8 Pallas kernel in interpret
    mode and against JAX's oracle."""
    jargs, targs = fp8_case(q_span)
    kw = dict(window=window, logit_cap=cap, q_span=q_span)
    want = j_decode_fp8(*jargs, **kw, interpret=True)
    oracle = j_decode_fp8_ref(*jargs, **kw)
    for got in (flash_decode_fp8(*targs, **kw),
                paged_attention_fp8_ref(*targs, **kw)):
        assert tuple(got.shape) == want.shape
        close(got, want, 40)
        close(got, oracle, 40)


def test_paged_attention_routes_fp8_pools_and_refuses_wide_scales():
    """A 1-byte pool takes the fp8 path with unit scales by default, the
    same as JAX's op (4-D q: the multi-position fold); scales on a wide
    pool raise ``ValueError``, as in JAX."""
    jargs, targs = fp8_case(q_span=2, seed=7)
    jq, jk8, jv8, jks, jvs, jbt, jln = jargs
    q, k8, v8, ks, vs, bt, ln = targs
    b, hkv, gtot, d = q.shape
    q4 = q.reshape(b, hkv, 2, 3, d).permute(0, 2, 1, 3, 4).reshape(
        b, 2, hkv * 3, d)
    jq4 = jnp.asarray(q4.numpy())
    for scales, jscales in (({}, {}),
                            (dict(k_scale=ks, v_scale=vs),
                             dict(k_scale=jks, v_scale=jvs))):
        want = jops.paged_attention(jq4, jk8, jv8, jbt, jln, window=9,
                                    **jscales)
        for use_kernel in (True, False):
            got = ops.paged_attention(q4, k8, v8, bt, ln, window=9,
                                      use_kernel=use_kernel, **scales)
            assert got.shape == (b, 2, hkv * 3, d)
            close(got, want, 40)
    wide = k8.float()
    with pytest.raises(ValueError, match="fp8"):
        ops.paged_attention(q4, wide, wide, bt, ln, k_scale=ks)
    with pytest.raises(ValueError, match="fp8"):
        jops.paged_attention(jq4, jnp.asarray(wide.numpy()),
                             jnp.asarray(wide.numpy()), jbt, jln,
                             k_scale=jks)


def test_paged_attention_oproj_falls_back_for_fp8_pools_and_int8_wo():
    """An fp8 pool, or a quantized ``wo``, takes the unfused pair in both
    packages: ``paged_attention`` then ``linear``."""
    jargs, targs = fp8_case(seed=8)
    jq, jk8, jv8, _, _, jbt, jln = jargs
    q, k8, v8, _, _, bt, ln = targs
    b, hkv, g, d = q.shape
    rng = np.random.default_rng(8)
    wo = (rng.standard_normal((hkv * g * d, 24)) / 10).astype(np.float32)
    q3, jq3 = q.reshape(b, hkv * g, d), jq.reshape(b, hkv * g, d)
    wide_k, wide_v = k8.float(), v8.float()
    cases = [((k8, v8, t(wo)), (jk8, jv8, jnp.asarray(wo))),
             ((wide_k, wide_v, quantize(t(wo))),
              (jnp.asarray(wide_k.numpy()), jnp.asarray(wide_v.numpy()),
               j_quantize(jnp.asarray(wo)))),
             ((k8, v8, quantize(t(wo))),
              (jk8, jv8, j_quantize(jnp.asarray(wo))))]
    for (kp, vp, w), (jkp, jvp, jw) in cases:
        want = jops.paged_attention_oproj(jq3, jkp, jvp, jbt, jln, jw,
                                          logit_cap=25.0)
        got = ops.paged_attention_oproj(q3, kp, vp, bt, ln, w,
                                        logit_cap=25.0)
        assert got.shape == (b, 24)
        close(got, want, hkv * g * d)
        unfused = ops.paged_attention(q3, kp, vp, bt, ln, logit_cap=25.0)
        close(got, ops.linear(unfused.reshape(b, -1), w), hkv * g * d)


# ------------------------- fp8 pages and the config -------------------------


def test_choose_page_size_uses_the_fp8_schedule_key(tmp_path):
    """An fp8 pool sizes its pages under "flash_decode_fp8", named by the
    model dtype, ahead of the fused key: a tuned fp8 entry dictates the
    page while the wide keys' entries are ignored (JAX's
    ``test_choose_page_size_uses_fp8_schedule_key``, and the same answers
    from JAX's chooser)."""
    from repro.serve import kv_cache as JKV
    from repro.tune import OpSpec as JOpSpec
    from repro.tune import Schedule as JSchedule
    from repro.tune import ScheduleCache as JScheduleCache
    from repro_torch.serve.kv_cache import choose_page_size
    from repro_torch.tune import OpSpec, Schedule, ScheduleCache
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=jnp.float32)
    g = cfg.n_heads // cfg.n_kv_heads
    dims = (g, 64, cfg.head_dim)
    cache = ScheduleCache(str(tmp_path / "port.json"))
    jcache = JScheduleCache(str(tmp_path / "jax.json"))
    for op, page in (("flash_decode", 16), ("flash_decode_fp8", 32)):
        cache.store(Schedule(OpSpec(op, dims, "float32"), (page,),
                             source="measured"))
        jcache.store(JSchedule(JOpSpec(op, dims, "float32"), (page,),
                               source="measured"))
    cache.store(Schedule(OpSpec("flash_decode_oproj",
                                (*dims, cfg.d_model), "float32"), (8,),
                         source="measured"))
    assert choose_page_size(cfg, 64, cache=cache) == 16
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=FP8)
    jcfg8 = dataclasses.replace(jcfg, kv_cache_dtype=jnp.float8_e4m3fn)
    assert choose_page_size(cfg8, 64, cache=cache) == 32
    assert choose_page_size(cfg8, 64, cache=cache, fused=True) == 32
    assert JKV.choose_page_size(jcfg8, 64, cache=jcache) == 32
    assert choose_page_size(cfg, 64, cache=cache, fused=True) == 8


def test_fp8_page_and_chunk_fit_the_fp8_kernel():
    """At granite's widths the model's fp8 page (1-byte pages, bf16 q
    rows) is a divisor of max_seq whose fp8 footprint fits the budget it
    was sized under, and the prefill chunk is priced the same way."""
    from repro_torch.configs import get_config
    from repro_torch.core.hopper_adapter import default_smem_budget
    from repro_torch.kernels.flash_decode import (ROWS_PER_BLOCK,
                                                  largest_page,
                                                  smem_bytes_required)
    from repro_torch.serve.kv_cache import (choose_page_size,
                                            choose_prefill_chunk)
    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype=FP8)
    page = choose_page_size(cfg, 512)
    assert 512 % page == 0
    assert smem_bytes_required(page, ROWS_PER_BLOCK, 128, 2, 1) <= \
        default_smem_budget()
    assert largest_page(128, 2, default_smem_budget(), kv_bytes=1) == 217
    assert largest_page(128, 2, default_smem_budget()) == 110
    assert choose_prefill_chunk(cfg, 512, page) == 512


def test_kv_cache_dtype_validated_at_construction():
    """JAX's ``test_kv_cache_dtype_validated_at_construction``, in torch
    dtypes: int dtypes, float64, non-dtypes and strings raise
    ``ValueError`` naming ``kv_cache_dtype``."""
    cfg = get_reduced(ARCH)
    ok = dataclasses.replace(cfg, kv_cache_dtype=FP8)
    assert ok.kv_cache_dtype.itemsize == 1
    for good in (torch.float8_e5m2, torch.bfloat16, torch.float16,
                 torch.float32):
        dataclasses.replace(cfg, kv_cache_dtype=good)
    for bad in (torch.int8, torch.int32, torch.float64, "not-a-dtype",
                "float8_e4m3fn", object()):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            dataclasses.replace(cfg, kv_cache_dtype=bad)


def test_fp8_pool_scatter_writes_the_cast_bytes():
    """The paged steps scatter K/V into an fp8 pool through its uint8
    view: the pool holds exactly the bytes of the cast values, and the
    pool stays fp8."""
    from repro_torch.serve.kv_cache import _scatter
    rng = np.random.default_rng(9)
    pool = torch.zeros((4, 8, 2, 16), dtype=FP8)
    vals = t(rng.standard_normal((3, 2, 16)).astype(np.float32))
    pages, slots = torch.tensor([1, 3, 1]), torch.tensor([0, 7, 5])
    _scatter(pool, (pages, slots), vals)
    assert pool.dtype == FP8
    want = torch.zeros((4, 8, 2, 16))
    want[pages, slots] = vals
    np.testing.assert_array_equal(fp8_bytes(pool), fp8_bytes(want.to(FP8)))


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


def quantized(model, mode):
    """Both packages' (cfg, params) for a ``--quantize`` mode."""
    jcfg, jparams, jq, cfg, params, qparams = model
    if mode in ("fp8kv", "w8fp8"):
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=jnp.float8_e4m3fn)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=FP8)
    if mode in ("w8", "w8fp8"):
        return jcfg, jq, cfg, qparams
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", ["w8", "fp8kv", "w8fp8"])
def test_quantized_engine_token_identical_to_jax(model, mode, fuse):
    """Port ``PagedEngine`` against the JAX one on the recipe of
    ``test_engine_token_identical_to_jax`` (page 8, chunk 8: whole-prompt
    joins and chunked prefill) for each quantize mode, unfused and
    fused."""
    jcfg, jp, cfg, p = quantized(model, mode)
    prompts, gens = make_workload(cfg.vocab)
    want = run(JPagedEngine(jcfg, jp, JPagedServeConfig(
        **SETTINGS, spec_decode=0, fuse=fuse)), prompts, gens)
    eng = PagedEngine(cfg, p, PagedServeConfig(**SETTINGS, device="cpu",
                                               fuse=fuse))
    assert eng.cache["k_pages"].dtype == (cfg.kv_cache_dtype or cfg.dtype)
    got = run(eng, prompts, gens)
    snap = eng.metrics.snapshot()["engine"]
    assert snap["decode_steps"] > 0 and snap["joins"] > 0
    assert snap["prefill_chunks"] > 0
    for w, g, n in zip(want, got, gens):
        assert g.status is RequestStatus.OK and len(g.output) == n
        np.testing.assert_array_equal(g.output, w.output)
    assert len({int(x) for r in got for x in r.output}) > len(got)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_w8_prefill_logits_match_jax(model, fuse):
    """Full-prompt prefill over int8 weights: the port's logits within
    1e-4 of JAX's, unfused and under ``fused_ops``; and the plain path
    (``use_kernel=False``) gives the same logits on the CPU."""
    jcfg, jq, cfg, qparams = quantized(model, "w8")
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    with jops.fused_ops(fuse):
        want, _ = JT.prefill(jcfg, jq, jnp.asarray(tokens), 16)
    with ops.fused_ops(fuse):
        got, cache = T.prefill(cfg, qparams, t(tokens), 16)
        plain, _ = T.prefill(cfg, qparams, t(tokens), 16, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_serve_cli_runs_quantized_and_fused():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--dtype", "float32",
         "--quantize", "w8fp8", "--fuse", "--requests", "3",
         "--prompt-len", "12", "--gen", "4", "--max-seq", "64",
         "--batch", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    from repro_torch.serve.kv_cache import (choose_page_size,
                                            choose_prefill_chunk)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32,
                              kv_cache_dtype=FP8)
    page = choose_page_size(cfg, 64, fused=True)
    chunk = choose_prefill_chunk(cfg, 64, page)
    qp = quantize_params(T.init_params(cfg, seed=0, device="cpu"))
    qb, db = quantized_bytes(qp)
    assert (f"quantized projection weights: {qb / 1e6:.1f} MB (same "
            f"projections at bf16: {db / 1e6:.1f} MB)") in res.stdout
    assert f"page={page} chunk={chunk} kv=float8_e4m3fn " in res.stdout
    assert "fused=True quantize=w8fp8" in res.stdout
    assert "statuses: ok" in res.stdout
