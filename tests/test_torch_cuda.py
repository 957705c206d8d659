"""The port on a CUDA card, against the port on the CPU.

Every runnable kernel of ``benchmarks/kernels_suite.py`` (parsed by the
port: a copy whose ``cox`` import points at ``repro_torch.core``) is
launched on CUDA tensors and on CPU tensors with the same inputs; the
two must agree bitwise, which holds the CUDA-side torch semantics
(scatters, atomics, integer division, casts) to the CPU's, and so to the
JAX package's (``tests/test_torch_launch.py``).  This file imports no
JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips where there is no card.
"""

import importlib.util
import pathlib
import sys
import tempfile

import pytest
import torch

from repro_torch.core import cox, execute
from repro_torch.kernels import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_IMPORT = "from repro.core import cox"


def _load_port_suite():
    """The kernels suite, parsed by the port (the kernels keep their
    parsed source, so the file is gone once the module has run)."""
    src = (ROOT / "benchmarks" / "kernels_suite.py").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "port_kernels_suite_cuda.py"
        path.write_text(src.replace(REF_IMPORT, "from repro_torch.core import cox"))
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod


SUITE = {k.name: k for k in _load_port_suite().all_kernels() if k.kernel is not None}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SUITE))
def test_suite_on_cuda_matches_cpu(cuda, name):
    sk = SUITE[name]
    args = sk.make_args()
    want = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args, device="cpu")
    got = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args)
    for k, w in want.items():
        assert got[k].device.type == "cuda"
        assert got[k].dtype == w.dtype
        assert torch.equal(got[k].cpu(), w), f"{name}.{k}"


@cox.kernel
def _scale(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * 2.0


def test_launch_runs_on_the_card_by_default(cuda):
    a = torch.arange(100, dtype=torch.float32, device=cuda)
    out = _scale.launch(grid=4, block=32, args=(torch.zeros_like(a), a, 100))["out"]
    assert out.device.type == "cuda"
    assert torch.equal(out, a * 2)
    with pytest.raises(ValueError, match="move it"):
        _scale.launch(grid=4, block=32, args=(torch.zeros(100), a, 100))


@cox.kernel
def _row_max(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), cols: cox.i32):
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    m = -1e30
    j = c.lane_id()
    while j < cols:
        m = max(m, x[row * cols + j])
        j = j + 32
    m = c.red_max(m)
    if c.lane_id() == 0:
        out[row] = m


def test_cox_row_max_equals_the_kernel_and_counts_flag_reads(cuda):
    x = torch.randn(4, 300, device=cuda)
    before = execute.host_syncs
    got = _row_max.launch(grid=2, block=64, args=(x.new_zeros(4), x, 300))["out"]
    # one any-lane read per trip: 10 trips (ceil(300 / 32)) + the exit, per warp
    assert execute.host_syncs - before == 4 * 11
    assert torch.equal(got, ops.row_reduce(x, "max"))
    assert torch.equal(got, ref.row_reduce(x, "max"))


@cox.kernel
def _scatter_add(
    c,
    out: cox.Array(cox.f32),
    hits: cox.Array(cox.i32),
    idx: cox.Array(cox.i32),
    val: cox.Array(cox.f32),
    n: cox.i32,
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(out, idx[i], val[i])
        c.atomic_add(hits, idx[i], 1)


def test_float_atomics_within_tolerance(cuda):
    """Float atomic sums on CUDA run in the device's order: within
    rtol = atol = 1e-5 of the CPU's; integer atomics are exact."""
    gen = torch.Generator().manual_seed(0)
    n = 4096
    idx = torch.randint(0, 37, (n,), generator=gen, dtype=torch.int32)
    val = torch.randn(n, generator=gen)
    args = (torch.zeros(37), torch.zeros(37, dtype=torch.int32), idx, val, n)
    want = _scatter_add.launch(grid=16, block=256, args=args, device="cpu")
    on_card = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    got = _scatter_add.launch(grid=16, block=256, args=on_card)
    torch.testing.assert_close(got["out"].cpu(), want["out"], rtol=1e-5, atol=1e-5)
    assert torch.equal(got["hits"].cpu(), want["hits"])


# Softmax outputs are compared entry by entry (relative): a fixed atol
# would cover most entries of a wide row, whose mean is 1/cols.  float16
# keeps one subnormal step, where the two may round apart.
SOFTMAX_TOL = {
    torch.float32: (1e-5, 0.0),
    torch.bfloat16: (2e-2, 0.0),
    torch.float16: (2e-2, 2.0**-24),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernels_take_every_dtype(cuda, dtype):
    x = (torch.randn(3, 1027, device=cuda) * 3).to(dtype)
    ops.reset_launch_counts()
    rtol, atol = SOFTMAX_TOL[dtype]
    torch.testing.assert_close(
        ops.softmax(x).float(), ref.softmax(x).float(), rtol=rtol, atol=atol
    )
    for op in ("max", "absmax"):
        assert torch.equal(ops.row_reduce(x, op), ref.row_reduce(x, op))
    assert ops.launch_counts() == {"softmax": 1, "row_reduce": 2}


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        ops.softmax(torch.zeros(4, 8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.softmax(torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match="rows, cols"):
        ops.row_reduce(torch.zeros(2, 3, 4, device=cuda))


def test_nan_propagates_through_the_kernels(cuda):
    x = torch.randn(3, 777, device=cuda)
    x[1, 500] = float("nan")
    assert torch.isnan(ops.row_reduce(x, "max")[1])
    assert torch.isnan(ops.softmax(x)[1]).all()
    assert not torch.isnan(ops.softmax(x)[0]).any()


def test_all_minus_inf_prefix_rows(cuda):
    """A row whose first elements are -inf (masked logits) stays finite."""
    x = torch.randn(2, 5000, device=cuda)
    x[:, :4000] = float("-inf")
    torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=1e-5, atol=0.0)


def test_ragged_vocabulary_widths(cuda):
    for cols in (1, 31, 32769, 152064 + 3):
        x = torch.randn(2, cols, device=cuda)
        torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=1e-5, atol=0.0)
        torch.testing.assert_close(
            ops.row_reduce(x, "sum"), ref.row_reduce(x, "sum"), rtol=1e-5, atol=1e-4
        )
    # an unaligned view: rows start off a 16-byte boundary
    base = torch.randn(3 * 1001 + 1, device=cuda)
    x = base[1:].view(3, 1001)
    torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=1e-5, atol=0.0)
    assert torch.equal(ops.row_reduce(x, "max"), ref.row_reduce(x, "max"))
