"""A cell's whole run, but the look for a card, on the CPU at a reduced
granite: the drivers, the check and the cell's own limits, unchanged."""

import time

import torch

from portbench import harness

TINY = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 8,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
        "vocab_size": 256}


def run(cell: str, seed: int, control: bool = False):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    mix, conf, limits, _ = harness.cell_files(bench, cell)
    conf = dict(conf, **TINY)
    if mix["driver"] == "serve_open":
        seconds = 2.5     # a window that outlasts a loaded CPU's first steps
        mix = dict(mix, max_seq=256, rate_per_s=4.0,
                   warmup_lengths=[16, 128, 200],
                   prompt={"dist": "lognormal", "median": 64, "sigma": 0.8,
                           "min": 16, "max": 200})
    else:
        # float32 weights: at these widths a bf16 step's rounding reads
        # above limits set at the published widths
        seconds = 1.0
        mix = dict(mix, batch=2, seq_len=32)
        conf["torch_dtype"] = "float32"
    ctx = harness.Context(cell, mix, conf, limits, seed, seconds, False,
                          torch.device("cpu"), time.perf_counter(),
                          control=control)
    # one thread: beside other test workers, more only contend for cores
    # and slow the open loop past its window
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.load_module("drivers", mix["driver"]).run(ctx)
    finally:
        torch.set_num_threads(threads)
