"""The ported kernels against the Pallas kernels they replace.

On the CPU, ``ops.softmax``/``ops.row_reduce`` run the plain PyTorch
versions; they are held against ``repro.kernels.softmax.softmax`` and
``warp_reduce.row_reduce`` in Pallas interpret mode on the shape and
dtype grids of ``tests/test_kernels.py``, with its tolerances.  On a
CUDA tensor the wrappers must launch the CUDA kernel: those tests carry
the ``cuda`` marker and skip where there is no card.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import softmax as jsm
from repro.kernels import warp_reduce as jwr
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import softmax as psm
from repro_torch.kernels import warp_reduce as pwr

ROOT = pathlib.Path(__file__).resolve().parents[1]


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "rows,cols", [(8, 128), (16, 256), (3, 128), (8, 4096), (1, 512)]
)
@pytest.mark.parametrize("op", ["sum", "max", "absmax"])
def test_row_reduce_matches_pallas(rows, cols, op):
    x = normal([rows, cols], (rows, cols))
    want = np.asarray(jwr.row_reduce(jnp.asarray(x), op, interpret=True))
    got = ops.row_reduce(torch.from_numpy(x), op).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 128), (4, 16, 256), (2, 8, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_matches_pallas(shape, dtype):
    x = normal(len(shape), shape, scale=3.0)
    want = jsm.softmax(jnp.asarray(x).astype(dtype), interpret=True)
    got = ops.softmax(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want, np.float32),
        rtol=2e-2 if dtype == "bfloat16" else 1e-5,
        atol=1e-3,
    )


def test_bf16_row_reduce_sum_follows_the_pallas_kernel():
    """The Pallas kernel sums bf16 in f32 and returns f32; the JAX
    package's plain ``ref.row_reduce`` sums in bf16.  The port follows
    the kernel."""
    x = normal(7, (8, 1024))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kernel = np.asarray(jwr.row_reduce(xb, "sum", interpret=True))
    plain = jref.row_reduce(xb, "sum")
    got = ops.row_reduce(torch.from_numpy(x).to(torch.bfloat16), "sum")
    assert kernel.dtype == np.float32 and plain.dtype == jnp.bfloat16
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["max", "absmax"])
def test_max_propagates_nan(op):
    x = normal(11, (4, 64))
    x[2, 17] = np.nan
    got = ops.row_reduce(torch.from_numpy(x), op).numpy()
    want = np.asarray(jwr.row_reduce(jnp.asarray(x), op, interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2])


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launch_counts()
    x = torch.from_numpy(normal(1, (4, 33)))
    assert ops.resolve(x) == "torch"
    torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=0, atol=0)
    torch.testing.assert_close(ops.row_reduce(x), ref.row_reduce(x), rtol=0, atol=0)
    assert ops.launch_counts() == {"softmax": 0, "row_reduce": 0}


def test_kernel_entry_points_refuse_cpu_tensors():
    """The CUDA paths raise instead of falling back to the plain version."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        psm.softmax_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pwr.row_reduce_cuda(x, "max")
    with pytest.raises(ValueError, match="unknown op"):
        pwr.row_reduce(x, "mean")


def test_library_names_track_the_sources(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    paths = {name: build._library_path(name) for name in build.SIGNATURES}
    assert set(paths) == {"softmax", "row_reduce"}
    for name, path in paths.items():
        assert path.parent == tmp_path and path.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").exists()
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_softmax_launches_the_kernel(cuda, dtype):
    x = (torch.randn(5, 3001, device=cuda) * 3).to(dtype)
    before = psm.launches
    got = ops.softmax(x)
    assert psm.launches == before + 1
    # relative, entry by entry: at 3001 columns most outputs lie below the
    # reference's 512-column atol
    rtol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    want = ref.softmax(x).float()
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max", "absmax"])
def test_cuda_row_reduce_launches_the_kernel(cuda, op):
    x = torch.randn(7, 2049, device=cuda)
    before = pwr.launches
    got = ops.row_reduce(x, op)
    assert pwr.launches == before + 1
    want = ref.row_reduce(x, op)
    if op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(got, want)
