"""Flash attention's tiles and the bf16 tensor-core instances' rounding.

* The tiles: the forward and both backward passes launch with the one
  ``(block_q, block_kv)`` of the Hopper ``flash_tiles`` (checked here
  with the loader monkeypatched: no card), and a tile the bf16 instance
  does not take raises.
* The shared-memory budget's repair moves none of the model's choices
  at ``chip_smoke.py``'s shapes: the serving page and chunk, the fp8
  page, and the conv tiles of ``PERF.md`` §6.
* The rounding: the bf16 instances (``csrc/attn_mma.cuh``) round P and
  dS to bf16 before their products, where the TPU kernels and the plain
  versions keep them in fp32.  A CPU emulation of that rounding, tile by
  tile at ``flash_tiles``' tiles, stays inside the card's bf16 gates
  (``test_torch_cuda.TOL`` and ``grad_close``) against JAX's
  ``_flash_forward`` and ``flash_attention_bwd`` run in interpret mode on
  the same bf16 inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_forward as jflash_forward
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jbwd
from repro_torch.core.hopper_adapter import flash_tiles
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FB

NEG_INF = -1e30
# the card's bf16 gates (tests/test_torch_cuda.py): the output within one
# bf16 rounding of an O(1) value; a gradient within 1e-2 of its largest
# |value| and 1e-2 rel
TOL_BF16 = dict(atol=2e-2, rtol=1e-2)


def grad_close_bf16(out, ref):
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2 * scale,
                               rtol=1e-2)


# ------------------------------ the tiles ----------------------------------


class FakeStream:
    cuda_stream = 0


def fake_loader(monkeypatch, calls):
    """``_build.load`` returning a C function that records its arguments
    and reports success; no library is built and nothing launches."""
    def load(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, len(args))
            calls.append((name, args))
            return 0
        return fn
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: FakeStream())


def fake_tiles(monkeypatch, module, asked, tiles):
    def tiles_fn(*args):
        asked.append(args)
        return tiles
    monkeypatch.setattr(module, "flash_tiles", tiles_fn)


@pytest.mark.parametrize("dtype,tiles", [(torch.bfloat16, (32, 16)),
                                         (torch.float32, (64, 32))])
def test_forward_launches_with_flash_tiles(monkeypatch, dtype, tiles):
    """``_forward`` asks ``flash_tiles`` (seq_q, seq_kv, head_dim, element
    size) and passes its (block_q, block_kv) to the kernel; the wrapper
    records the instance."""
    calls, asked = [], []
    fake_loader(monkeypatch, calls)
    fake_tiles(monkeypatch, FA, asked, tiles)
    monkeypatch.setattr(FA, "_check", lambda q, k, v, w: tuple(q.shape))
    q = torch.zeros(2, 40, 8, 64, dtype=dtype)
    k = torch.zeros(2, 104, 2, 64, dtype=dtype)
    FA._forward(q, k, k, True, None, None, with_lse=True)
    assert asked == [(40, 104, 64, dtype.itemsize)]
    (name, args), = calls
    assert name == "flash_attention"
    assert args[7:12] == (2, 40, 104, 8, 2)         # batch, sq, skv, hq, hkv
    assert args[-3:-1] == tiles                     # block_q, block_kv
    kind = "mma" if dtype == torch.bfloat16 else "cuda_core"
    assert FA.flash_attention.instance == (kind, *tiles)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_launches_with_the_forwards_tiles(monkeypatch, dtype):
    """The backward asks ``flash_tiles`` the forward's question and
    launches both passes with its answer, o passed for the dq pass's
    delta."""
    calls, asked = [], []
    fake_loader(monkeypatch, calls)
    fake_tiles(monkeypatch, FB, asked, (64, 32))
    monkeypatch.setattr(FB, "_check", lambda q, k, v, w: tuple(q.shape))

    class Props:
        shared_memory_per_block_optin = 232_448
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props())
    q = torch.zeros(1, 64, 4, 128, dtype=dtype)
    k = torch.zeros(1, 64, 1, 128, dtype=dtype)
    o, g = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(1, 4, 64)
    FB._backward(q, k, k, o, lse, g, True, None, None)
    assert asked == [(64, 64, 128, dtype.itemsize)]
    (name, args), = calls
    assert name == "flash_attention_bwd"
    assert args[5:8] == (g.data_ptr(), o.data_ptr(), lse.data_ptr())
    assert args[-3:-1] == (64, 32)
    kind = "mma" if dtype == torch.bfloat16 else "cuda_core"
    assert FB.flash_attention_bwd.instance == (kind, 64, 32)


@pytest.mark.parametrize("tiles", [(48, 64), (64, 128), (8, 16)])
def test_bf16_instance_refuses_tiles_off_its_warp_grid(tiles):
    with pytest.raises(ValueError, match="tensor-core instance"):
        FA.check_tiles(tiles, torch.bfloat16)
    assert FA.check_tiles(tiles, torch.float32) == tiles


# ------------------- the model's choices at the smoke shapes ---------------


def test_serving_choices_at_the_smoke_shapes_do_not_move():
    """granite-3-8b at max_seq 512 (phases 6, 6b, 9): page 32 and chunk
    512 in bf16, fused page 32, fp8 page 64 (PERF.md §4)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.kv_cache import (choose_page_size,
                                            choose_prefill_chunk)
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              dtype=torch.bfloat16)
    page = choose_page_size(cfg, 512)
    assert (page, choose_prefill_chunk(cfg, 512, page)) == (32, 512)
    assert choose_page_size(cfg, 512, fused=True) == 32
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    page8 = choose_page_size(cfg8, 512)
    assert (page8, choose_prefill_chunk(cfg8, 512, page8)) == (64, 512)


# the model's tiles at Conv1 and Conv4 under the three conv keys, bf16
# (PERF.md §6, rows 12 and 13; the wgrad's on row 13's tensor-core grid)
CONV_TILES = [("Conv1", "conv2d", (32, 16, 8, 16)),
              ("Conv1", "conv2d_dgrad", (38, 19, 8, 16)),
              ("Conv1", "conv2d_wgrad", (32, 16, 8, 16)),
              ("Conv4", "conv2d", (28, 8, 32, 16)),
              ("Conv4", "conv2d_dgrad", (2, 58, 16, 128)),
              ("Conv4", "conv2d_wgrad", (8, 28, 32, 32))]


@pytest.mark.parametrize("layer,op,tiles", CONV_TILES)
def test_conv_tiles_at_the_smoke_shapes_do_not_move(tmp_path, layer, op,
                                                    tiles):
    from repro_torch.configs import PAPER_LAYERS
    from repro_torch.tune import ScheduleCache, best_schedule
    p = PAPER_LAYERS[layer]
    dims = (p.X, p.Y, p.C, p.K, p.Fw, p.Fh)
    if op == "conv2d_dgrad":   # the transposed conv, in the nest's terms
        dims = (p.X + p.Fw - 1, p.Y + p.Fh - 1, p.K, p.C, p.Fw, p.Fh)
    cache = ScheduleCache(str(tmp_path / "s.json"))
    assert best_schedule(op, dims, "bfloat16", cache=cache).tiles == tiles


# ------------------- the bf16 instances' rounding ---------------------------


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def scores(q, k, causal, window, cap):
    """Scaled (capped) fp32 scores of one head, the tanh (or None) and
    the visible pairs; kv_offset = Skv - Sq."""
    sq, d = q.shape
    skv = k.shape[0]
    s = (q @ k.T) * d ** -0.5
    t = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = cap * t
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s, t, mask


def emulate_forward(q, k, v, causal, window, cap, block_kv):
    """The bf16 forward instance's arithmetic on one head (inputs hold
    bf16 values in fp32): the online softmax over ``block_kv``-key tiles
    with the TPU kernel's NaN guards, P rounded to bf16 before P . V, the
    denominator summed from the fp32 P; the output rounded to bf16."""
    s, _, mask = scores(q, k, causal, window, cap)
    sq, skv = s.shape
    m = torch.full((sq,), NEG_INF)
    l = torch.zeros(sq)
    acc = torch.zeros(sq, q.shape[1])
    for c0 in range(0, skv, block_kv):
        st = torch.where(mask[:, c0:c0 + block_kv], s[:, c0:c0 + block_kv],
                         torch.tensor(NEG_INF))
        m_new = torch.maximum(m, st.max(-1).values)
        m_sub = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(st <= NEG_INF / 2, 0.0, torch.exp(st - m_sub[:, None]))
        alpha = torch.where(m <= NEG_INF / 2, 0.0,
                            torch.exp(torch.clamp(m - m_new, max=0.0)))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + bf16(p) @ v[c0:c0 + block_kv]
        m = m_new
    out = bf16(acc / torch.where(l == 0, 1.0, l)[:, None])
    lse = torch.where(l == 0, 1e30, m + torch.log(torch.where(l == 0, 1.0,
                                                              l)))
    return out, lse


def emulate_backward(q, k, v, o, lse, g, causal, window, cap):
    """The bf16 backward instances' arithmetic on one head: p and ds in
    fp32 from the residual, each rounded to bf16 before its products
    (dv = P^T do, dk = dS^T q, dq = dS k); the results rounded to bf16.
    The rounding is per element, so the tiles change only the fp32
    summation order."""
    s, t, mask = scores(q, k, causal, window, cap)
    scale = q.shape[1] ** -0.5
    p = torch.where(mask, torch.exp(s - lse[:, None]), 0.0)
    delta = (g * o).sum(-1, keepdim=True)
    ds = p * (g @ v.T - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    return (bf16(bf16(ds) @ k * scale), bf16(bf16(ds).T @ q * scale),
            bf16(bf16(p).T @ g))


ROUNDING_CASES = [  # sq, skv, causal, window, cap
    (64, 64, True, None, None),
    (64, 64, False, None, None),
    (40, 40, True, None, None),       # ragged at flash_tiles' (32, 32)
    (32, 96, True, None, None),       # Sq < Skv
    (64, 64, True, 24, None),         # a window across tiles
    (64, 64, True, None, 20.0),       # a cap
]


@pytest.mark.parametrize("sq,skv,causal,window,cap", ROUNDING_CASES)
def test_bf16_rounding_stays_inside_the_card_gates(sq, skv, causal, window,
                                                   cap):
    d = 64
    rng = np.random.default_rng(sq * 7 + skv)
    draw = lambda *s: bf16(torch.tensor(  # noqa: E731
        rng.standard_normal(s), dtype=torch.float32))
    q, k, v, g = draw(sq, d), draw(skv, d), draw(skv, d), draw(sq, d)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    block_q, block_kv = flash_tiles(sq, skv, d, 2)
    j = lambda x: jnp.asarray(x.numpy()).astype(jnp.bfloat16)  # noqa: E731
    tiles = dict(block_q=8, block_kv=8, interpret=True)
    jo, jlse = jflash_forward(j(q), j(k), j(v), return_lse=True, **tiles,
                              **kw)
    want_o = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(jlse))[:, 0]
    o, lse = emulate_forward(q, k, v, causal, window, cap, block_kv)
    torch.testing.assert_close(o, want_o, **TOL_BF16)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    want = jbwd(j(q), j(k), j(v), jo, jlse, j(g), **tiles, **kw)
    got = emulate_backward(q, k, v, bf16(want_o), lse, g, causal, window,
                           cap)
    for x, y in zip(got, want):
        grad_close_bf16(x, torch.from_numpy(np.array(
            y.astype(jnp.float32))))
    assert block_q % 16 == 0 and block_kv % 16 == 0
