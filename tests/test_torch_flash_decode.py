"""Port vs JAX: paged flash-decode.

The port's ``flash_decode`` on CPU tensors runs its plain version; it is
held against the JAX oracle ``paged_attention_ref`` and against the
Pallas kernel in interpret mode, in fp32 with atol = rtol = 1e-5 (the
three sum in different orders).  Inputs come from numpy with a fixed
seed.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(q_span, seed=0, b=3, hkv=2, g=2, d=16, page=4, nb=6):
    """Ragged lengths (one inside the first page), shuffled block tables,
    scratch-page entries past each request's span."""
    rng = np.random.default_rng(seed)
    lengths = np.array([1, 7, 17], np.int32)[:b]
    n_pages = b * nb + 1
    q = rng.standard_normal((b, hkv, q_span * g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    for i, n in enumerate(lengths):
        bt[i, -(-(n + q_span - 1) // page):] = 0
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("q_span", [1, 4])
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_plain_flash_decode_matches_jax(q_span, window, cap):
    arrs = _case(q_span)
    kw = dict(window=window, logit_cap=cap, q_span=q_span)
    port = tfd.flash_decode(*map(torch.from_numpy, arrs), **kw).numpy()
    jarrs = list(map(jnp.asarray, arrs))
    oracle = np.asarray(jfd.paged_attention_ref(*jarrs, **kw))
    kernel = np.asarray(jfd.flash_decode(*jarrs, interpret=True, **kw))
    np.testing.assert_allclose(port, oracle, **TOL)
    np.testing.assert_allclose(port, kernel, **TOL)


@pytest.mark.parametrize("span", [None, 3])
def test_ops_paged_attention_matches_jax(span):
    """The op's (B, Hq, D) and 4-D (B, S, Hq, D) folds match the JAX op."""
    q_span = span or 1
    _, kp, vp, bt, lengths = _case(q_span, seed=1)
    rng = np.random.default_rng(2)
    shape = (3, 4, 16) if span is None else (3, span, 4, 16)
    q = rng.standard_normal(shape).astype(np.float32)
    port = tops.paged_attention(*map(torch.from_numpy,
                                     (q, kp, vp, bt, lengths))).numpy()
    ref = np.asarray(jops.paged_attention(
        *map(jnp.asarray, (q, kp, vp, bt, lengths)), use_kernel=False))
    np.testing.assert_allclose(port, ref, **TOL)


def test_use_kernel_false_is_the_plain_version():
    arrs = list(map(torch.from_numpy, _case(1, seed=3)))
    q = arrs[0].reshape(3, 4, 16)
    a = tops.paged_attention(q, *arrs[1:], use_kernel=False)
    b = tops.paged_attention(q, *arrs[1:])
    torch.testing.assert_close(a, b, atol=0, rtol=0)
