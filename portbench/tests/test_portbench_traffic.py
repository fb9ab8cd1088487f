"""The traffic generator: deterministic per seed, the same work for
every seed, the clip, large seeds."""

import numpy as np
import torch

from portbench import traffic

MIX = {"rate_per_s": 4.0, "schedule_seed": 1, "max_new_tokens": 1,
       "prompt": {"dist": "lognormal", "median": 4096, "sigma": 0.8,
                  "min": 1024, "max": 12000}}
BIG = 2 ** 31 + 12345


def test_same_seed_same_arrivals():
    a = traffic.open_loop(MIX, 40.0, BIG, 49155)
    b = traffic.open_loop(MIX, 40.0, BIG, 49155)
    assert np.array_equal(a.due_s, b.due_s)
    assert np.array_equal(a.prompt_lens, b.prompt_lens)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))


def test_seeds_replay_one_schedule_with_their_own_tokens():
    a = traffic.open_loop(MIX, 40.0, 1, 49155)
    b = traffic.open_loop(MIX, 40.0, BIG, 49155)
    assert len(a.due_s) == len(b.due_s) == 160
    assert np.array_equal(a.prompt_lens, b.prompt_lens)
    assert np.array_equal(a.due_s, b.due_s)
    assert not np.array_equal(a.prompts[0][:8], b.prompts[0][:8])


def test_schedule_seed_orders_the_same_work():
    a = traffic.open_loop(MIX, 40.0, 1, 49155)
    c = traffic.open_loop(dict(MIX, schedule_seed=2), 40.0, 1, 49155)

    def gaps(x):   # every gap, the last running to the window's end
        return np.sort(np.r_[np.diff(x.due_s),
                             40.0 - x.due_s[-1] + x.due_s[0]])
    assert np.array_equal(np.sort(a.prompt_lens), np.sort(c.prompt_lens))
    assert np.allclose(gaps(a), gaps(c))
    assert not np.array_equal(a.prompt_lens, c.prompt_lens)


def test_arrivals_fall_inside_the_window():
    a = traffic.open_loop(MIX, 40.0, 5, 49155)
    assert np.all(np.diff(a.due_s) > 0)
    assert 0 < a.due_s[0] and a.due_s[-1] < 40.0
    assert abs(len(a.due_s) / 40.0 - MIX["rate_per_s"]) < 1e-9


def test_lognormal_clip_and_median():
    lens = traffic.lengths(MIX["prompt"], 1000)
    assert lens.min() == 1024 and lens.max() == 12000
    assert np.all(np.diff(lens) >= 0)
    assert abs(np.median(lens) - 4096) <= 16
    # the share clipped at each end is the distribution's tail
    assert 0.03 < np.mean(lens == 1024) < 0.06
    assert 0.07 < np.mean(lens == 12000) < 0.11


def test_maxent_holds_the_published_mean_inside_the_range():
    spec = {"dist": "maxent", "mean": 7590, "min": 1024, "max": 12000}
    lens = traffic.lengths(spec, 1000)
    assert abs(lens.mean() - 7590) < 2
    assert 1024 <= lens.min() and lens.max() <= 12000
    assert np.all(np.diff(lens) >= 0)
    # a mean above the range's middle: the density rises, half the
    # prompts past the 8,192-token chunk
    assert 0.45 < np.mean(lens > 8192) < 0.52
    low = traffic.lengths(dict(spec, mean=3000), 1000)
    assert abs(low.mean() - 3000) < 2 and np.median(low) < 3000


def test_prompt_ids_inside_the_vocabulary():
    a = traffic.open_loop(MIX, 10.0, 3, 300)
    assert all(p.min() >= 0 and p.max() < 300 for p in a.prompts)
    assert [len(p) for p in a.prompts] == list(a.prompt_lens)


def test_batches_deterministic_and_distinct():
    mix = {"batch": 2, "seq_len": 16}
    cpu = torch.device("cpu")
    a0 = traffic.batch_rows(mix, BIG, 0, 1000, cpu)
    assert torch.equal(a0, traffic.batch_rows(mix, BIG, 0, 1000, cpu))
    a1 = traffic.batch_rows(mix, BIG, 1, 1000, cpu)
    assert a0.shape == (2, 17) and not torch.equal(a0, a1)
    assert not torch.equal(a0[0], a0[1])
