#!/usr/bin/env python3
"""COX grid execution of chip_smoke.py's MatrixMulCUDA, on one CUDA card.

    python3 scripts/cox_grid.py [--root DIR] [--tag NAME] [--sweep]

Launches the tiled 16 x 16 matmul of ``chip_smoke.py`` at n = 320 (grid
20 x 20) through ``KernelFn.launch``.  Always: the serial ``scan``
backend on the first ``--blocks`` blocks (the grid cut to 100 blocks by
default, enough to compare two trees).  With ``--sweep`` (a tree that
has the block-parallel backend): the ``vmap`` backend at wave widths
``--chunks``, for the default flat collapse (one 256-lane warp a block)
and for the hierarchical collapse with the batched ``(n_warps, W)`` warp
plane, each held bitwise against the scan launch of the whole grid.
Each line gives the wall seconds (host clock around the launch and a
synchronize) and the host flag reads (``execute.host_syncs``).

``--root`` takes ``chip_smoke.py`` and ``src`` from another checkout
(the parent commit, so two trees are compared in one call, in turns:
parent, change, change, parent).

One JSON object per line, then the card's name and power limit as
``nvidia-smi`` prints them.
"""

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_smoke(root: pathlib.Path):
    """``chip_smoke.py`` of the tree at ``root``: its kernels, and the
    ``repro_torch`` of that tree (the module puts its own ``src`` first)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tree", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(smoke, **kw):
    torch.cuda.synchronize()
    syncs = smoke.execute.host_syncs
    t0 = time.perf_counter()
    out = smoke.MatrixMulCUDA.launch(**kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, smoke.execute.host_syncs - syncs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--blocks", type=int, default=100)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--chunks", default="8,16,32,64,128,400")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("cox_grid.py needs a CUDA card; none is available")
    smoke = load_smoke(pathlib.Path(args.root).resolve())
    n = smoke.MM_N
    side = n // 16
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)
    launch_args = (np.zeros((n, n), np.float32), a, b, n)
    base = dict(block=(16, 16), args=launch_args)

    def emit(rec):
        print(json.dumps({"tag": args.tag, "n": n, **rec}), flush=True)

    rows = -(-args.blocks // side)  # whole rows of blocks: grid (side, rows)
    kw = dict(base, grid=(side, rows), backend="scan", warp_exec="serial")
    timed(smoke, **dict(kw, grid=(side, 1)))  # warm up: first CUDA calls
    _, wall, syncs = timed(smoke, **kw)
    emit({"variant": "scan", "blocks": side * rows, "wall_s": wall, "host_syncs": syncs})
    if args.sweep:
        want, wall, syncs = timed(smoke, **dict(base, grid=(side, side), backend="scan"))
        emit({"variant": "scan", "blocks": side * side, "wall_s": wall, "host_syncs": syncs})
        for collapse, warp_exec in (("hybrid", "serial"), ("hier", "batched")):
            for chunk in (int(c) for c in args.chunks.split(",")):
                out, wall, syncs = timed(
                    smoke,
                    **base,
                    grid=(side, side),
                    backend="vmap",
                    collapse=collapse,
                    warp_exec=warp_exec,
                    chunk=chunk,
                )
                same = torch.equal(out["out"], want["out"])
                emit(
                    {
                        "variant": "vmap",
                        "collapse": collapse,
                        "warp_exec": warp_exec,
                        "chunk": chunk,
                        "blocks": side * side,
                        "wall_s": wall,
                        "host_syncs": syncs,
                        "bitwise_scan": same,
                    }
                )
                if not same:
                    raise AssertionError(f"vmap chunk {chunk} {collapse} != scan")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
