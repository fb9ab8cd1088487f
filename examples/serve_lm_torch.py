"""Serving example on the PyTorch/CUDA port: the paged
continuous-batching engine next to the static-batch baseline, across
architecture families (dense GQA, hybrid RG-LRU, pure SSM) -- the paged
engine streams ragged-length requests through a fixed set of decode
slots while the static engine must pad and run in lock-step.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` (the kernels' plain versions);
raises without a GPU otherwise.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (DecodeEngine, PagedEngine,
                                      PagedServeConfig, ServeConfig)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    for arch in ("granite-3-8b", "recurrentgemma-9b", "mamba2-780m"):
        cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
        params = T.init_params(cfg, seed=0, device=args.device)

        # ragged request stream: 6 requests through 2 decode slots
        prompts = [rng.integers(0, cfg.vocab, (int(L),), dtype=np.int32)
                   for L in rng.integers(4, 13, 6)]
        paged = PagedEngine(cfg, params,
                            PagedServeConfig(max_seq=64, max_batch=2,
                                             device=args.device))
        out = paged.generate(prompts, 16)

        # static baseline on the same-length slice, greedy must agree
        static = DecodeEngine(cfg, params,
                              ServeConfig(max_seq=64, device=args.device))
        ref = static.generate(prompts[0][None, :], 16)[0]
        agree = bool(np.array_equal(out[0], ref))

        sampled = PagedEngine(cfg, params,
                              PagedServeConfig(max_seq=64, max_batch=2,
                                               temperature=0.8,
                                               device=args.device))
        out_t = sampled.generate(prompts, 16)
        print(f"{arch:20s} page={paged.page_size:3d} "
              f"greedy[0]={out[0, :8].tolist()} "
              f"matches-static={agree} "
              f"sampled[0]={out_t[0, :8].tolist()}")


if __name__ == "__main__":
    main()
