"""Port vs JAX: flash-attention forward.

The port's ``flash_attention`` on CPU tensors runs its plain version; it
is held against the Pallas ``_flash_forward`` in interpret mode and the
JAX ``ref.attention_ref``, one head at a time, in fp32 with 1e-5.  The
op in the ``(B, S, H, D)`` GQA layout is held against the JAX op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [  # sq, skv, causal, window, cap
    (16, 16, True, None, None),
    (8, 24, True, None, None),        # Sq < Skv: kv_offset = 16
    (16, 16, True, 5, None),
    (16, 16, True, None, 30.0),
    (12, 12, False, None, None),
]


@pytest.mark.parametrize("sq,skv,causal,window,cap", CASES)
def test_plain_flash_attention_matches_jax(sq, skv, causal, window, cap):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((n, 16)).astype(np.float32)
               for n in (sq, skv, skv))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    port = tfa.flash_attention(*(torch.from_numpy(a)[None, :, None]
                                 for a in (q, k, v)), **kw)[0, :, 0].numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = np.asarray(jfa._flash_forward(jq, jk, jv, interpret=True, **kw))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal,
                                           logit_cap=cap, window=window))
    np.testing.assert_allclose(port, kernel, **TOL)
    np.testing.assert_allclose(port, oracle, **TOL)
    ported_oracle = tref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, logit_cap=cap,
                                       window=window).numpy()
    np.testing.assert_allclose(ported_oracle, oracle, **TOL)


@pytest.mark.parametrize("sq,skv", [(8, 8), (8, 16)])
def test_ops_attention_gqa_matches_jax(sq, skv):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    port = tops.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(jops.attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(port, ref, **TOL)
