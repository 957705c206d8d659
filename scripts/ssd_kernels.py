#!/usr/bin/env python3
"""The SSD scan kernels at the main path's shapes, on one CUDA card.

    python3 scripts/ssd_kernels.py [--src DIR] [--tag NAME]

Times ``ssd_scan_cuda(keep_states=True)`` (the forward as training calls
it) and ``ssd_scan_bwd_cuda`` through their wrappers: CUDA events around
batches of back-to-back calls, the median (``ms``, as ``chip_smoke.py``
times them).  Shapes (B, S, H, P, N), f32: mamba2-130m's train layer (the
headline) and the reference sweep's (1, 256, 2, 64, 32).  Each line also
holds the kernels' largest error against the plain chunked form and its
autograd gradient, as a share of the plain output's largest magnitude
(chip_smoke.py's SSD_TOL is 1e-4), and whether two calls gave the same
bits.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit), so that two trees are compared in one call, in turns:
parent, change, change, parent.  One JSON object per line, then the
card's name and power limit as ``nvidia-smi`` prints them.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHAPES = [("headline", 8, 4096, 24, 64, 128), ("sweep", 1, 256, 2, 64, 32)]
CHUNK = 128  # the plain form's chunk (configs/base.py ssd_chunk)


def median_ms(fn, batches: int = 7, calls: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def inputs(B, S, H, P, N, seed: int = 0):
    """Model-like inputs, as chip_smoke.py draws them: a = -softplus(.)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 0.5 * torch.randn(B, S, H, P, generator=gen, device="cuda")
    a = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda") - 1)
    b = 0.3 * torch.randn(B, S, N, generator=gen, device="cuda")
    c = 0.3 * torch.randn(B, S, N, generator=gen, device="cuda")
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda")
    return x, a, b, c, dy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree whose repro_torch to time")
    ap.add_argument("--tag", default="change", help="the tree's name in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("ssd_kernels.py needs a CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    for case, B, S, H, P, N in SHAPES:
        x, a, b, c, dy = inputs(B, S, H, P, N)
        y, states = ssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
        grads = ssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)
        y2, states2 = ssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
        grads2 = ssd.ssd_scan_bwd_cuda(x, a, b, c, states2, dy)
        same = torch.equal(y, y2) and all(torch.equal(g, h) for g, h in zip(grads, grads2))
        errs = {"y": scaled_err(y, ref.ssd_scan_chunked(x, a, b, c, chunk=CHUNK))}
        want = ref.ssd_scan_bwd(x, a, b, c, dy, chunk=CHUNK)
        for name, got, w in zip(("dx", "da", "db", "dc"), grads, want):
            errs[name] = scaled_err(got, w)
        del y2, states2, grads2, want
        rec = {
            "tree": args.tag,
            "case": case,
            "shape": [B, S, H, P, N],
            "tile": ssd.tile_rows(N, P),
            "fwd_ms": median_ms(lambda: ssd.ssd_scan_cuda(x, a, b, c, keep_states=True)),
            "bwd_ms": median_ms(lambda: ssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)),
            "err_of_max": errs,
            "bitwise_twice": same,
        }
        print(json.dumps(rec), flush=True)
        del x, a, b, c, dy, y, states, grads
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
