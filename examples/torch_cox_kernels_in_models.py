"""The three-way kernel story on the PyTorch port: the same row softmax
written (1) as a CUDA-style COX kernel compiled by hierarchical
collapsing, (2) as the hand-written CUDA kernel the model stack calls
through ``kernels/ops.py`` (``csrc/softmax.cu``; on a CPU tensor its
plain version), and (3) as the plain PyTorch reference -- all agreeing
(port of ``examples/cox_kernels_in_models.py``).

    PYTHONPATH=src python examples/torch_cox_kernels_in_models.py [--device cpu]

Everything runs on the CUDA card unless ``--device`` names another
device, and raises where there is no card.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import cox
from repro_torch.core.runtime import resolve_device
from repro_torch.kernels import ops, ref


# (1) CUDA-style: one warp per row, warp collectives for max and sum --
# the reduction pattern the paper's warp-level features exist for.
@cox.kernel
def softmax_rows(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), cols: cox.i32):
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    lane = c.lane_id()
    # strided load: each lane covers cols/32 elements
    m = -1e30
    j = lane
    while j < cols:
        m = max(m, x[row * cols + j])
        j = j + 32
    m = c.red_max(m)  # warp collective max
    s = 0.0
    j = lane
    while j < cols:
        s = s + c.exp(x[row * cols + j] - m)
        j = j + 32
    s = c.red_add(s)  # warp collective sum
    j = lane
    while j < cols:
        out[row * cols + j] = c.exp(x[row * cols + j] - m) / s
        j = j + 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows, cols = 8, 128
    x = np.random.default_rng(0).normal(size=(rows, cols)).astype(np.float32)
    out0 = np.zeros_like(x)
    xt = torch.from_numpy(x).to(device)

    # 2 warps per block, 4 blocks -> 8 rows
    got_cox = softmax_rows.launch(grid=4, block=64, args=(out0, x, cols), device=device)["out"]
    got_kernel = ops.softmax(xt)  # (2) the CUDA kernel on the card
    want = ref.softmax(xt)  # (3) the plain reference

    got_cox, got_kernel, want = (t.cpu().numpy() for t in (got_cox, got_kernel, want))
    np.testing.assert_allclose(got_cox, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_kernel, want, rtol=1e-4, atol=1e-5)
    leg = "CUDA kernel" if device.type == "cuda" else "plain version"
    print(f"COX == {leg} == plain reference: OK")
    err = float(np.abs(got_cox - want).max())
    print("max |cox - ref| =", err)
    return {"cox": got_cox, "kernel": got_kernel, "ref": want, "max_abs_err": err}


if __name__ == "__main__":
    main()
