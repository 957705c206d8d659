"""Quickstart on the PyTorch port: write a CUDA-style kernel, run it
through hierarchical collapsing, and check it against the per-thread
oracle (port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The launch runs on the CUDA card unless ``--device`` names another
device, and raises where there is no card.
"""

import argparse

import numpy as np

from repro_torch.core import cox
from repro_torch.core.oracle import run_grid as oracle_run
from repro_torch.core.runtime import resolve_device


# The paper's motivating kernel (Code 1): warp-shuffle tree reduction of
# the first warp, guarded by a conditional -- the case flat collapsing
# cannot express.
@cox.kernel
def warp_reduce(c, out: cox.Array(cox.f32), val: cox.Array(cox.f32)):
    tid = c.thread_idx()
    v = val[tid]
    if tid < 32:
        offset = 16
        while offset > 0:
            s = c.shfl_down(v, offset)
            v = v + s
            offset = offset // 2
    if tid == 0:
        out[c.block_idx()] = v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    block = 256
    val = np.arange(block, dtype=np.float32)
    out0 = np.zeros(1, np.float32)

    # inspect the transformation
    ck = warp_reduce.compiled(collapse="hier")
    summary = ck.summary()
    print("pipeline summary:", summary)

    # run on the torch executor (the lanes of a warp are a tensor axis:
    # the paper's AVX role), on CUDA tensors unless asked otherwise
    got = warp_reduce.launch(grid=1, block=block, args=(out0, val), device=device)
    got = got["out"].cpu().numpy()
    print("COX result   :", got)

    # independent per-thread oracle (mini GPU simulator)
    ref = oracle_run(warp_reduce.ir, grid=1, block=block, args=(out0, val))
    print("oracle result:", ref["out"], " (expect", val[:32].sum(), ")")
    assert np.allclose(got, ref["out"])

    # flat collapsing (the prior art) must reject this kernel
    flat_error = None
    try:
        warp_reduce.launch(grid=1, block=block, args=(out0, val), collapse="flat", device=device)
    except Exception as e:
        flat_error = type(e).__name__
        print("flat collapsing correctly rejects it:", flat_error, "-", str(e)[:80])

    print("OK")
    return {"summary": summary, "out": got, "oracle": ref["out"], "flat_error": flat_error}


if __name__ == "__main__":
    main()
