"""End-to-end arithmetic and the counts, pinned to hand-worked numbers
at granite-3-8b's widths."""

import math

import pytest

from portbench import counts, e2e, layer_metrics

G = counts.Dense(layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
                 head_dim=128, d_ff=12800, vocab=49168)


def test_percentile_interpolates():
    assert e2e.percentile([1, 2, 3, 4, 5], 50) == 3
    assert e2e.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)


def test_percentile_counts_misses():
    vals = [10.0] * 95 + [math.inf] * 5
    assert e2e.percentile(vals, 90) == 10.0
    vals = [10.0] * 85 + [math.inf] * 15
    assert e2e.percentile(vals, 90) == math.inf
    assert layer_metrics.p90(vals) is None


def test_rate():
    assert e2e.rate(8192 * 10, 4.0) == 20480.0
    with pytest.raises(ValueError):
        e2e.rate(1, 0.0)


def test_layer_params():
    # q 4096x4096, k and v 4096x1024, o 4096x4096, three 4096x12800
    assert G.layer_params == 2 * 4096 * 4096 + 2 * 4096 * 1024 \
        + 3 * 4096 * 12800 == 199_229_440


def test_attention_counts():
    # 1,000 causal rows from position 0: 500,500 pairs, 4 * 32 * 128 each
    assert G.attn_flops(0, 1000) == 4 * 32 * 128 * 500_500
    # 10 rows after 100 cached: 10 * 100 + 55 pairs
    assert G.attn_flops(100, 10) == 4 * 32 * 128 * 1055
    # bf16 q and o of 1,000 rows x 32 heads, k and v of 1,000 x 8 heads
    assert G.attn_bytes(0, 1000) == 2 * 128 * (2 * 1000 * 32 + 2 * 1000 * 8)


def test_prefill_and_train_flops():
    per_layer = 2 * 199_229_440 * 4096 + G.attn_flops(0, 4096)
    head = 2 * 4096 * 49168
    assert G.prefill_flops(0, 4096, 1) == 40 * per_layer + head
    s10 = counts.Dense(10, 4096, 32, 8, 128, 12800, 49168)
    fwd = 10 * (2 * 199_229_440 * 4096 + s10.attn_flops(0, 4096)) \
        + head * 4096
    assert s10.train_flops(2, 4096) == 3 * 2 * fwd
    # about 1.16e14 a step at 2 x 4096 tokens
    assert 1.1e14 < s10.train_flops(2, 4096) < 1.2e14


def test_train_attention_counts():
    s10 = counts.Dense(10, 4096, 32, 8, 128, 12800, 49168)
    f, b = s10.train_attn(2, 4096)
    assert f == 3 * 10 * 2 * s10.attn_flops(0, 4096)
    rows = 2 * 128 * (4 * 4096 * 32 + 4 * 4096 * 8)
    assert b == 10 * 2 * (s10.attn_bytes(0, 4096) + rows)


def test_least_seconds_takes_the_slower_bound():
    assert counts.least_seconds(989e12, 0) == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0
    assert counts.least_seconds(989e12, 6.7e12) == 2.0
