"""End-to-end training example on the PyTorch/CUDA port: train a
~20M-param granite-style LM for a few hundred steps, with checkpointing
and a restart drill.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 \\
        [--device cpu] [--blocked-kernels]

Runs on the card unless ``--device cpu`` (the kernels' plain versions);
raises without a GPU otherwise.
"""

import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--blocked-kernels", action="store_true",
                    help="projections through the blocked GEMM forward "
                         "and its dgrad kernels backward (kernel rows "
                         "6-8 on the card, their plain versions on the "
                         "CPU)")
    args = ap.parse_args()

    # scale the smoke config up to ~20M params (real training, small)
    cfg = dataclasses.replace(
        get_reduced(args.arch), n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=1024, vocab=2048)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    tc = TrainConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        blocked_linear=args.blocked_kernels,
        ckpt_dir=ckpt_dir, ckpt_every=50, log_every=10)

    def batches(start=0):
        for step in range(start, args.steps):
            yield make_batch(cfg, args.seq_len, args.batch, step,
                             device=args.device)

    print(f"training {args.arch}-mini for {args.steps} steps on "
          f"{args.device} (ckpts -> {ckpt_dir})")
    result = train(cfg, tc, batches(), device=args.device)
    h = result["history"]
    print(f"\nloss: {h[0]:.3f} -> {h[-1]:.3f} "
          f"({(1 - h[-1]/h[0])*100:.0f}% reduction)")
    assert h[-1] < h[0] * 0.8, "training did not converge"

    # restart drill: resume from the last checkpoint, confirm continuity
    print("\nrestart drill: resuming from newest checkpoint...")
    train(cfg, tc, batches(start=args.steps - args.steps % 50
                           if args.steps % 50 else args.steps - 50),
          device=args.device, restore=True)
    print("resumed OK")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
