"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for
a few hundred steps with checkpointing and deterministic resume (port of
``examples/train_lm.py``).

Uses mamba2-130m by default; pass ``--arch mamba2-130m-smoke`` for its
width-reduced twin (fast on the CPU).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]

Training runs on the CUDA card unless ``--device`` names another device,
and raises where there is no card.  On the card every step of mamba2
launches the hand-written ``ssd_scan`` and ``rmsnorm`` kernels and their
backward kernels.  The checkpoints go to ``--ckpt-dir`` (by default a
directory under the system's temporary directory).
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.launch.train import train
from repro_torch.optim.adamw import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    out = train(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        log_every=20,
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        device=args.device,
    )
    losses = out["losses"]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(
        f"\ntrained {args.arch} for {args.steps} steps: "
        f"loss {first:.3f} -> {last:.3f} "
        f"({'LEARNING' if last < first else 'check hyperparams'})"
    )
    return out


if __name__ == "__main__":
    main()
