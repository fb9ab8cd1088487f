"""The plain reference held against the program's plain path at a
reduced granite (float32 on the CPU): prefill logits and keys and
values, the loss and every gradient, one AdamW step."""

import copy

import pytest
import torch

from portbench import harness, model, traffic, weights
from portbench.reference import dense

CONF = {"name": "tiny", "family": "dense", "hidden_size": 64,
        "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 250, "rope_theta": 10000000.0,
        "tie_word_embeddings": True, "torch_dtype": "float32"}
HEADS = model.heads(CONF)
THETA = CONF["rope_theta"]
SEED = 2 ** 40 + 7


def _setup():
    from repro_torch.models import transformer as T
    cfg = model.model_config(CONF, remat="none")
    params = weights.make(T.model_defs(cfg), SEED, torch.device("cpu"))
    return T, cfg, params


def test_weights_deterministic_and_scaled():
    T, cfg, params = _setup()
    again = weights.make(T.model_defs(cfg), SEED, torch.device("cpu"))
    wq, wd = params["layers"][0]["mixer"]["wq"], params["layers"][1]["ffn"]
    assert torch.equal(wq, again["layers"][0]["mixer"]["wq"])
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.2 * 64 ** -0.5
    assert abs(float(wd["w_down"].std()) - 96 ** -0.5) < 0.2 * 96 ** -0.5
    assert torch.equal(params["final_norm"]["scale"], torch.ones(64))


def test_prefill_logits_and_kv():
    T, cfg, params = _setup()
    tokens = torch.from_numpy(traffic.prompts_of([37], SEED, 250)[0]).long()
    logits, cache = T.prefill(cfg, params, tokens[None], max_seq=64,
                              use_kernel=False)
    seen = {}
    h = dense.prefill(params, tokens, HEADS, THETA,
                      on_kv=lambda i, kvs: seen.__setitem__(i, kvs[0]))
    ref = dense.logits(params, h[0][-1:], dense.fp32_mm)
    torch.testing.assert_close(ref[0], logits[0], rtol=1e-4, atol=1e-4)
    for i, (k, v) in seen.items():
        torch.testing.assert_close(k, cache["layers"][i]["k"][0, :37],
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(v, cache["layers"][i]["v"][0, :37],
                                   rtol=1e-4, atol=1e-5)


def test_loss_grads_and_adamw_step():
    from repro_torch.optim import adamw
    T, cfg, params = _setup()
    rows = traffic.batch_rows({"batch": 2, "seq_len": 24}, SEED, 0, 250,
                              torch.device("cpu"))
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    flat = adamw.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    total, _ = T.loss_fn(cfg, adamw.unflatten(params, live), batch,
                         use_kernel=False)
    grads = torch.autograd.grad(total, live)
    ref_params = copy.deepcopy(params)
    loss, ref_grads = dense.loss_and_grads(ref_params, batch, HEADS, THETA)
    assert loss == pytest.approx(float(total.detach()), rel=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(r, g, rtol=1e-4, atol=1e-6)
    opt = adamw.AdamWConfig(warmup_steps=2)
    new, state, _ = adamw.apply_updates(
        opt, params, adamw.unflatten(params, list(grads)),
        adamw.init_state(params))
    ref_state = {"mu": [torch.zeros_like(p) for p in flat],
                 "nu": [torch.zeros_like(p) for p in flat], "step": 0}
    train = harness.load_module("drivers", "train")
    dense.adamw_step(ref_params, list(ref_grads), ref_state,
                     train.opt_dict(opt))
    for p, r in zip(adamw.leaves(new), dense._leaves(ref_params)):
        torch.testing.assert_close(r, p, rtol=1e-5, atol=1e-7)
    for m, r in zip(adamw.leaves(state["mu"]), ref_state["mu"]):
        torch.testing.assert_close(r, m, rtol=1e-4, atol=1e-8)


def test_fp8_control_differs_and_has_gradients():
    a = torch.randn(8, 32, requires_grad=True)
    b = torch.randn(32, 4, requires_grad=True)
    exact = a @ b
    low = dense.fp8_mm(a, b)
    err = float(((low - exact).norm() / exact.norm()).detach())
    assert 0.005 < err < 0.2
    ga, gb = torch.autograd.grad(low.sum(), (a, b))
    ea, eb = torch.autograd.grad(exact.sum(), (a, b))
    assert 0 < float((ga - ea).norm() / ea.norm()) < 0.2
    assert 0 < float((gb - eb).norm() / eb.norm()) < 0.2
