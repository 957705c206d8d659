"""Port of the paper's Fig. 8 host program (vector copy) on the PyTorch
port: what the manual CUDA-host -> COX-host migration looks like (port
of ``examples/cuda_migration.py``).

CUDA (paper Fig. 8a)                 | here
-------------------------------------+---------------------------------
cudaMalloc / cudaMemcpy              | numpy arrays, copied to the card
vecCopy<<<grid_size, 1024>>>(a, b)   | vec_copy.launch(grid=..., block=...)
kernel<<<dim3(4,4), dim3(16,16)>>>   | launch(grid=(4, 4), block=(16, 16))
pthread fork/join per block          | a loop over blocks (scan backend)
                                     | or a wave of blocks (vmap)

    PYTHONPATH=src python examples/torch_cuda_migration.py [--device cpu]

The launches run on the CUDA card unless ``--device`` names another
device, and raise where there is no card.
"""

import argparse

import numpy as np

from repro_torch.core import cox
from repro_torch.core.runtime import resolve_device


@cox.kernel
def vec_copy(c, d_b: cox.Array(cox.f32), d_a: cox.Array(cox.f32)):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    d_b[i] = d_a[i]


@cox.kernel
def mat_transpose(c, odata: cox.Array(cox.f32), idata: cox.Array(cox.f32), n: cox.i32):
    # the SDK's 2-D tiled transpose, unmodified dim3 indexing: no
    # hand-flattening of threadIdx/blockIdx into linear arithmetic
    tile = c.shared((16, 17), cox.f32)
    x = c.block_idx("x") * 16 + c.thread_idx("x")
    y = c.block_idx("y") * 16 + c.thread_idx("y")
    tile[c.thread_idx("y"), c.thread_idx("x")] = idata[y * n + x]
    c.syncthreads()
    xo = c.block_idx("y") * 16 + c.thread_idx("x")
    yo = c.block_idx("x") * 16 + c.thread_idx("y")
    odata[yo * n + xo] = tile[c.thread_idx("x"), c.thread_idx("y")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n = 4096
    grid_size = n // 1024

    # cudaMalloc + cudaMemcpy(HostToDevice) -> arrays, copied by the launch
    h_a = np.random.default_rng(0).normal(size=n).astype(np.float32)
    h_b = np.zeros(n, np.float32)

    # vecCopy<<<grid_size, 1024>>>(d_a, d_b)
    out = vec_copy.launch(grid=grid_size, block=1024, args=(h_b, h_a), device=device)

    # cudaMemcpy(DeviceToHost)
    h_b = out["d_b"].cpu().numpy()
    assert np.array_equal(h_b, h_a)
    print(f"copied {n} floats through a {grid_size}x1024 COX grid: OK")

    # normal mode vs JIT mode (paper §4: runtime config as variable vs
    # burned in at compile time)
    out_n = vec_copy.launch(grid=grid_size, block=1024, args=(h_b, h_a), mode="normal", device=device)
    h_n = out_n["d_b"].cpu().numpy()
    assert np.array_equal(h_n, h_a)
    print("normal-mode launch: OK")

    # dim3 launch geometry: transpose<<<dim3(4,4), dim3(16,16)>>>(o, i, n)
    m = 64
    h_m = np.random.default_rng(1).normal(size=(m, m)).astype(np.float32)
    out_t = mat_transpose.launch(
        grid=(4, 4), block=(16, 16), args=(np.zeros((m, m), np.float32), h_m, m), device=device
    )
    h_t = out_t["odata"].cpu().numpy()
    assert np.array_equal(h_t, h_m.T)
    print(f"transposed a {m}x{m} matrix through a dim3(4,4)x(16,16) COX grid: OK")
    return {"h_a": h_a, "vec_copy": h_b, "vec_copy_normal": h_n, "h_m": h_m, "transpose": h_t}


if __name__ == "__main__":
    main()
