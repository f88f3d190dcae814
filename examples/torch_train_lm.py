"""End to end with the PyTorch port: train an LM for a few hundred
steps.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
      [--arch mamba2-130m] [--steps 300] [--batch 8] [--seq 64] [--full]

The port of ``examples/train_lm.py``.  Uses the port's training loop
(``launch/train.py``: checkpoint/restart, straggler detection).  By
default it trains the reduced (smoke) config and prints the loss
trajectory; ``--full`` selects the published config.  Checkpoints go to a
temporary directory unless ``--ckpt-dir`` names one.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2.5-3b")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3,
                   help="peak LR (default tuned for the smoke-scale configs)")
    p.add_argument("--full", action="store_true",
                   help="use the full (published) config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default) or cpu")
    args = p.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    print(f"[example] training {cfg.name}: ~{cfg.param_count() / 1e6:.1f}M "
          f"params, {args.steps} steps @ batch {args.batch} x seq "
          f"{args.seq} on {args.device}")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_lm_")
    try:
        state = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      lr=args.lr, ckpt_dir=ckpt_dir,
                      ckpt_every=max(args.steps // 3, 1),
                      log_every=max(args.steps // 6, 1), device=args.device)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = np.asarray(state["losses"])
    k = max(len(losses) // 10, 1)
    first, last = losses[:k].mean(), losses[-k:].mean()
    ok = bool(np.isfinite(losses).all() and last < first)
    print(f"[example] loss: {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if ok else 'NOT LEARNING'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
