"""The port's compiler and oracle against the JAX package's.

Both packages parse the same kernel sources: a copy of
``benchmarks/kernels_suite.py`` whose ``cox`` import points at
``repro_torch.core`` is written under a temporary directory and imported,
so every suite kernel exists twice, once per package.  For each runnable
kernel the pass pipelines must agree (``summary()``, replication classes,
variable types) and the two numpy oracles must give identical arrays.
The copied compiler modules must stay line-for-line copies.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from benchmarks import kernels_suite as ref_suite
from repro.core import oracle as ref_oracle
from repro.core import types as ref_types
from repro.core.execute import compile_kernel as ref_compile
from repro_torch.core import oracle as port_oracle
from repro_torch.core import types as port_types
from repro_torch.core.execute import compile_kernel as port_compile

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_IMPORT = "from repro.core import cox"
RUNNABLE = [k.name for k in ref_suite.all_kernels() if k.kernel is not None]
# kernels whose per-thread oracle takes seconds per block at the suite's
# grid: their oracle parity runs on a one-block grid
HEAVY = {
    "MatrixMulCUDA",
    "matrixMul",
    "matrixMultiplyKernel",
    "matrixMul1D",
    "saxpyHeavy",
    "warpPrefixStats",
}
COPIED = [
    "kernel_ir",
    "frontend",
    "cfg",
    "lower",
    "passes",
    "phases",
    "regions",
    "typeinfer",
    "flat",
    "errors",
    "oracle",
]


def load_port_suite(tmp_dir: pathlib.Path):
    """The kernels suite, parsed by the port."""
    src = (ROOT / "benchmarks" / "kernels_suite.py").read_text()
    assert src.count(REF_IMPORT) == 1
    path = tmp_dir / "port_kernels_suite.py"
    path.write_text(src.replace(REF_IMPORT, "from repro_torch.core import cox"))
    spec = importlib.util.spec_from_file_location("port_kernels_suite", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (reference SuiteKernel, port SuiteKernel, args drawn once)."""
    port_suite = load_port_suite(tmp_path_factory.mktemp("suite"))
    out = {}
    for r, p in zip(ref_suite.all_kernels(), port_suite.all_kernels()):
        assert r.name == p.name
        if r.kernel is not None:
            out[r.name] = (r, p, p.make_args())
    return out


def test_suite_rows(pairs):
    rows = ref_suite.all_kernels()
    assert len(rows) == 39
    assert len(RUNNABLE) == 36 and len(pairs) == 36
    assert all(r.unsupported_reason for r in rows if r.kernel is None)


def _typed(d):
    return {k: v.value for k, v in d.items()}


@pytest.mark.parametrize("name", RUNNABLE)
def test_compile_matches_reference(pairs, name):
    r, p, _ = pairs[name]
    hybrid = r.kernel.compiled(block=r.block)  # what a launch compiles
    for ws in sorted({32, hybrid.warp_size}):
        want = ref_compile(r.kernel.ir, warp_size=ws)
        got = port_compile(p.kernel.ir, warp_size=ws)
        assert got.summary() == want.summary()
        assert got.classes == want.classes
        assert _typed(got.var_types) == _typed(want.var_types)
        assert _typed(got.warp_bufs) == _typed(want.warp_bufs)
        assert got.carried == want.carried


def _oracle_grid(r):
    if r.name not in HEAVY:
        return r.grid
    return (1, 1) if isinstance(r.grid, tuple) else 1


@pytest.mark.parametrize("name", RUNNABLE)
def test_oracle_matches_reference(pairs, name):
    r, p, args = pairs[name]
    grid = _oracle_grid(r)
    want = ref_oracle.run_grid(r.kernel.ir, grid=grid, block=r.block, args=args)
    got = port_oracle.run_grid(p.kernel.ir, grid=grid, block=r.block, args=args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}.{k}")


def _normalized(module: str, pkg: str) -> list:
    lines = (ROOT / "src" / pkg / "core" / f"{module}.py").read_text().splitlines()
    return [ln for ln in lines if ln != "# fmt: off"]


@pytest.mark.parametrize("module", COPIED)
def test_compiler_copy_is_verbatim(module):
    """The JAX-free modules are copies: the only differences allowed are
    the formatter guard and flat.py's dtype size (numpy's view of a jnp
    dtype in the reference, the port's own table here)."""
    got = _normalized(module, "repro_torch")
    want = _normalized(module, "repro")
    if module == "flat":
        want = [
            ln.replace("np.dtype(s.dtype.jnp).itemsize", "s.dtype.itemsize")
            for ln in want
            if ln != "import numpy as np"
        ]
        want = [ln for i, ln in enumerate(want) if not (ln == "" == want[i - 1])]
        got = [ln for i, ln in enumerate(got) if not (ln == "" == got[i - 1])]
    assert got == want


@pytest.mark.parametrize(
    "np_dtype", ["float32", "float16", "int32", "int64", "uint32", "bool"]
)
def test_dtype_tables_match_reference(np_dtype):
    """Both packages name the same DType for a numpy dtype, and the
    port's torch table round-trips it -- except i64, which the port
    stores as int32, as the reference (64-bit types off) really does."""
    want = ref_types.from_jnp(np.dtype(np_dtype))
    got = port_types.from_numpy(np.dtype(np_dtype))
    assert got.value == want.value
    assert port_types.from_torch(got.torch).value == (
        "i32" if np_dtype == "int64" else want.value
    )
    assert got.np == (np.dtype(np.int32) if np_dtype == "int64" else np.dtype(np_dtype))
    assert got.itemsize == got.np.itemsize
