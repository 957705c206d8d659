"""Batched serving on the PyTorch port: continuous batching of synthetic
requests through the port's decode step (port of
``examples/serve_batched.py``).

    PYTHONPATH=src python examples/torch_serve_batched.py --requests 12 [--device cpu]

The server runs on the CUDA card unless ``--device`` names another
device, and raises where there is no card.  On the card its decode steps
launch the hand-written norm kernels (and ``flash_decode`` for a model
with attention layers).
"""

import argparse

from repro_torch.launch.serve import serve_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = serve_requests(
        args.arch,
        batch=args.batch,
        ctx=args.ctx,
        n_requests=args.requests,
        max_tokens=args.tokens,
        device=args.device,
    )
    print(
        f"served {out['completed']} requests / {out['tokens']} tokens "
        f"in {out['wall_s']:.1f}s -> {out['tok_per_s']:.1f} tok/s "
        f"(batch={args.batch}, ctx={args.ctx})"
    )
    return out


if __name__ == "__main__":
    main()
