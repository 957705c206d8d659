"""The three-way kernel story of ``examples/cox_kernels_in_models.py``,
in the port: the same row softmax as a COX warp-collective kernel
launched through ``repro_torch`` on CPU torch, as the port's plain
version, and -- from the JAX package -- as the Pallas kernel in
interpret mode and the jnp reference, all agree (rtol 1e-4, atol 1e-5,
the example's tolerance).  The same holds for a row sum and max built
from ``red_add``/``red_max`` against ``row_reduce``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import softmax as jsm
from repro.kernels import warp_reduce as jwr
from repro_torch.core import cox
from repro_torch.kernels import ops


@cox.kernel
def softmax_rows(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), cols: cox.i32):
    # one warp per row, warp collectives for max and sum (the example's kernel)
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    lane = c.lane_id()
    m = -1e30
    j = lane
    while j < cols:
        m = max(m, x[row * cols + j])
        j = j + 32
    m = c.red_max(m)
    s = 0.0
    j = lane
    while j < cols:
        s = s + c.exp(x[row * cols + j] - m)
        j = j + 32
    s = c.red_add(s)
    j = lane
    while j < cols:
        out[row * cols + j] = c.exp(x[row * cols + j] - m) / s
        j = j + 32


@cox.kernel
def row_stats(
    c,
    sums: cox.Array(cox.f32),
    maxes: cox.Array(cox.f32),
    x: cox.Array(cox.f32),
    cols: cox.i32,
):
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    lane = c.lane_id()
    s = 0.0
    m = -1e30
    j = lane
    while j < cols:
        v = x[row * cols + j]
        s = s + v
        m = max(m, v)
        j = j + 32
    s = c.red_add(s)
    m = c.red_max(m)
    if lane == 0:
        sums[row] = s
        maxes[row] = m


@pytest.mark.parametrize("mode", ["jit", "normal"])
@pytest.mark.parametrize("rows,cols", [(8, 128), (4, 100)])
def test_softmax_three_way(rows, cols, mode):
    x = np.random.default_rng(0).normal(size=(rows, cols)).astype(np.float32)
    # 2 warps per block, one row per warp
    got_cox = softmax_rows.launch(
        grid=rows // 2,
        block=64,
        args=(np.zeros_like(x), x, cols),
        device="cpu",
        mode=mode,
    )["out"].numpy()
    got_plain = ops.softmax(torch.from_numpy(x)).numpy()
    got_pallas = np.asarray(jsm.softmax(jnp.asarray(x), interpret=True))
    want = np.asarray(jref.softmax(jnp.asarray(x)))
    for got in (got_cox, got_plain, got_pallas):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_row_reduce_three_way():
    rows, cols = 6, 300
    x = np.random.default_rng(1).normal(size=(rows, cols)).astype(np.float32)
    z = np.zeros(rows, np.float32)
    out = row_stats.launch(grid=rows // 2, block=64, args=(z, z, x, cols), device="cpu")
    for op, key in (("sum", "sums"), ("max", "maxes")):
        got_plain = ops.row_reduce(torch.from_numpy(x), op).numpy()
        got_pallas = np.asarray(jwr.row_reduce(jnp.asarray(x), op, interpret=True))
        for got in (out[key].numpy(), got_plain):
            np.testing.assert_allclose(got, got_pallas, rtol=1e-5, atol=1e-4)
        if op == "max":  # order-free: bitwise
            np.testing.assert_array_equal(out[key].numpy(), got_pallas)
