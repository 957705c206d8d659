"""The port's launch path on CPU torch against the JAX package's.

Every runnable kernel of ``benchmarks/kernels_suite.py`` is launched
through the port (``backend="scan"``, serial warps, both ``mode``s, on
``device="cpu"``) and through the reference (``backend="scan"``) on the
same inputs, drawn once.  The results must agree bitwise, except where
the reference's XLA contracts ``a * b + c`` into one fused multiply-add
and eager torch rounds twice (:data:`FMA_KERNELS`, rtol = atol = 1e-5,
the tolerance of ``tests/test_kernels.py``).  They must also equal the
port's numpy oracle bitwise.

The rest pins the semantics that torch does not give for free: JAX's
out-of-range and negative indices, lanes re-entering a masked while,
integer division, u32 ballots, JAX's saturating casts, unmutated
inputs, and a loud error for every knob the port does not run yet.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from benchmarks import kernels_suite as ref_suite
from repro.core import cox as rcox
from repro_torch.core import cox as pcox
from repro_torch.core import oracle as port_oracle
from repro_torch.core.types import CoxUnsupported

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_IMPORT = "from repro.core import cox"
RUNNABLE = [k.name for k in ref_suite.all_kernels() if k.kernel is not None]
FMA_KERNELS = {
    "gpuSpMV",
    "MatrixMulCUDA",
    "matrixMul",
    "matrixMultiplyKernel",
    "matrixMul1D",
}
# per-thread oracle cost is seconds per block here: one-block grid
HEAVY = {
    "MatrixMulCUDA",
    "matrixMul",
    "matrixMultiplyKernel",
    "matrixMul1D",
    "saxpyHeavy",
    "warpPrefixStats",
}


def load_port_suite(tmp_dir: pathlib.Path):
    """The kernels suite, parsed by the port."""
    src = (ROOT / "benchmarks" / "kernels_suite.py").read_text()
    assert src.count(REF_IMPORT) == 1
    path = tmp_dir / "port_kernels_suite_launch.py"
    path.write_text(src.replace(REF_IMPORT, "from repro_torch.core import cox"))
    spec = importlib.util.spec_from_file_location("port_kernels_suite_launch", path)
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
        if r.kernel is not None:
            out[r.name] = (r, p, p.make_args())
    return out


@pytest.fixture(scope="module")
def reference(pairs):
    """name -> the reference's scan launch on the shared args (cached:
    both modes of the port compare against one reference run)."""
    cache = {}

    def run(name):
        if name not in cache:
            r, _, args = pairs[name]
            out = r.kernel.launch(grid=r.grid, block=r.block, args=args, backend="scan")
            cache[name] = {k: np.asarray(v) for k, v in out.items()}
        return cache[name]

    return run


def port_outputs(sk, args, **kw):
    out = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args, device="cpu", **kw)
    return {k: v.numpy() for k, v in out.items()}


def assert_same(got, want, name, tolerant=False):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (name, k)
        if tolerant and got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}.{k}")


@pytest.mark.parametrize("mode", ["jit", "normal"])
@pytest.mark.parametrize("name", RUNNABLE)
def test_suite_launch_matches_reference(pairs, reference, name, mode):
    _, p, args = pairs[name]
    got = port_outputs(p, args, mode=mode, backend="scan", warp_exec="serial")
    assert_same(got, reference(name), name, name in FMA_KERNELS)


@pytest.mark.parametrize("name", RUNNABLE)
def test_suite_launch_matches_oracle(pairs, name):
    _, p, args = pairs[name]
    grid = p.grid
    if name in HEAVY:
        grid = (1, 1) if isinstance(grid, tuple) else 1
    out = p.kernel.launch(grid=grid, block=p.block, args=args, device="cpu")
    got = {k: v.numpy() for k, v in out.items()}
    want = port_oracle.run_grid(p.kernel.ir, grid=grid, block=p.block, args=args)
    assert_same(got, want, name)


# ---------------------------------------------------------------------------
# semantics torch does not give for free
# ---------------------------------------------------------------------------


def both(kernel_name, **kw):
    """Launch the module-level kernel pair ``r_<name>``/``p_<name>``."""
    want = globals()[f"r_{kernel_name}"].launch(backend="scan", **kw)
    got = globals()[f"p_{kernel_name}"].launch(device="cpu", **kw)
    return {k: v.numpy() for k, v in got.items()}, {
        k: np.asarray(v) for k, v in want.items()
    }


def _oob(c, out, src, n):
    tid = c.thread_idx()
    out[tid - 8] = src[tid - 12] + 1.0  # negative: [-n, -1] wraps
    out[tid + n - 4] = src[tid + n - 2] * 2.0  # past the end: dropped, loads 0


def _define(fn, annotations):
    """One kernel body, parsed by both packages."""
    fn.__annotations__ = annotations(rcox)
    r = rcox.kernel(fn)
    fn.__annotations__ = annotations(pcox)
    return r, pcox.kernel(fn)


r_oob, p_oob = _define(
    _oob,
    lambda m: {"out": m.Array(m.f32), "src": m.Array(m.f32), "n": m.i32},
)


def test_out_of_range_and_negative_indices():
    n = 24
    src = np.arange(n, dtype=np.float32) + 100.0
    got, want = both("oob", grid=1, block=32, args=(np.zeros(n, np.float32), src, n))
    assert_same(got, want, "oob")
    # spot-check the reference's semantics the port reproduces
    assert want["out"][n - 8] == src[n - 12] + 1.0  # tid 0 wraps both indices
    assert want["out"][0] == src[n - 4] + 1.0  # tid 8: src[-4] wraps


def _reenter(c, g, x):
    i = c.thread_idx()
    k = 0
    while g[0] % 2 == i % 2 and g[0] < 10:
        k = k + 1
        if i < 2:
            g[0] = g[0] + 1
    x[i] = k


r_reenter, p_reenter = _define(
    _reenter, lambda m: {"g": m.Array(m.i32), "x": m.Array(m.i32)}
)


@pytest.mark.parametrize("mode", ["jit", "normal"])
def test_masked_while_lanes_reenter(mode):
    """Even and odd lanes take turns: a lane whose condition turns true
    again re-enters the loop, so every lane counts 5 trips (a latched
    mask would stop the even lanes after one)."""
    args = (np.zeros(1, np.int32), np.zeros(32, np.int32))
    got, want = both("reenter", grid=1, block=32, args=args, mode=mode)
    assert_same(got, want, "reenter")
    np.testing.assert_array_equal(got["x"], np.full(32, 5, np.int32))
    assert got["g"][0] == 10


def _intdiv(c, q, r, f, a, b):
    i = c.thread_idx()
    q[i] = a[i] // b[i]
    r[i] = a[i] % b[i]
    f[i] = a[i] / b[i]


r_intdiv, p_intdiv = _define(
    _intdiv,
    lambda m: {
        "q": m.Array(m.i32),
        "r": m.Array(m.i32),
        "f": m.Array(m.f32),
        "a": m.Array(m.i32),
        "b": m.Array(m.i32),
    },
)


def test_integer_floor_division_and_true_division():
    a = np.array([7, -7, 7, -7, 0, 5, -(2**31), 9] * 4, np.int32)
    b = np.array([2, 2, -2, -2, 3, 0, -1, 0] * 4, np.int32)
    z = np.zeros(32, np.int32)
    got, want = both(
        "intdiv", grid=1, block=32, args=(z, z, z.astype(np.float32), a, b)
    )
    assert_same(got, want, "intdiv")
    np.testing.assert_array_equal(got["q"][:4], [3, -4, -4, 3])  # floor, not trunc


def _casts(c, i_out, u_out, s_out, x, sh):
    i = c.thread_idx()
    i_out[i] = c.i32(x[i])
    u_out[i] = c.u32(x[i])
    s_out[i] = (i_out[i] << sh[i]) + (i_out[i] >> sh[i])


r_casts, p_casts = _define(
    _casts,
    lambda m: {
        "i_out": m.Array(m.i32),
        "u_out": m.Array(m.u32),
        "s_out": m.Array(m.i32),
        "x": m.Array(m.f32),
        "sh": m.Array(m.i32),
    },
)


def test_saturating_casts_and_shifts():
    x = np.array([-1.5, 3e9, -3e9, np.nan, 2.7, -0.2, 5e9, 1e3] * 4, np.float32)
    sh = np.array([0, 1, 31, 32, 33, -1, 4, 2] * 4, np.int32)
    z = np.zeros(32, np.int32)
    got, want = both("casts", grid=1, block=32, args=(z, z.astype(np.uint32), z, x, sh))
    assert_same(got, want, "casts")


def _ballot(c, out, a):
    tid = c.thread_idx()
    r = c.ballot(a[tid] > 0)
    out[c.block_idx() * c.block_dim() + tid] = r


r_ballot, p_ballot = _define(
    _ballot, lambda m: {"out": m.Array(m.u32), "a": m.Array(m.i32)}
)


@pytest.mark.parametrize("simd", [True, False])
def test_u32_ballot_lane_31(simd):
    a = np.zeros(64, np.int32)
    a[31] = a[63] = a[0] = 1
    got, want = both(
        "ballot", grid=1, block=64, args=(np.zeros(64, np.uint32), a), simd=simd
    )
    assert_same(got, want, "ballot")
    assert got["out"][0] == np.uint32(0x80000001)


def _wide(c, out, a):
    i = c.thread_idx()
    out[i] = a[i] * 3


r_wide, p_wide = _define(
    _wide, lambda m: {"out": m.Array(m.DType.i64), "a": m.Array(m.i32)}
)


def test_i64_arrays_are_int32_as_in_the_reference():
    """JAX runs with 64-bit types off: an i64 array is int32 there."""
    a = np.arange(32, dtype=np.int32) - 16
    got, want = both("wide", grid=1, block=32, args=(np.zeros(32, np.int64), a))
    assert want["out"].dtype == np.int32
    assert_same(got, want, "wide")


def test_caller_inputs_are_not_mutated():
    n = 24
    src_t = torch.arange(n, dtype=torch.float32)
    out_t = torch.zeros(n)
    out_np = np.zeros(n, np.float32)
    before = (src_t.clone(), out_t.clone())
    got = p_oob.launch(grid=1, block=32, args=(out_t, src_t, n), device="cpu")
    assert torch.equal(src_t, before[0]) and torch.equal(out_t, before[1])
    assert not torch.equal(got["out"], out_t)
    p_oob.launch(grid=1, block=32, args=(out_np, src_t.numpy(), n), device="cpu")
    assert not out_np.any()


def test_tensor_on_another_device_raises():
    args = (torch.zeros(24, device="meta"), torch.zeros(24), 24)
    with pytest.raises(ValueError, match="move it"):
        p_oob.launch(grid=1, block=32, args=args, device="cpu")


@pytest.mark.parametrize(
    "knobs,item",
    [
        ({"backend": "sharded"}, (ValueError, "backend='sharded' needs a mesh")),
        ({"mesh": object()}, (CoxUnsupported, "mutually exclusive")),  # with device=
        ({"donate": True}, None),
        ({"autotune": True}, None),
        ({"stream": "cox.Stream"}, None),
        ({"device": torch.device("cpu")}, None),
    ],
    ids=["sharded", "mesh", "donate", "autotune", "stream", "pin"],
)
def test_unported_knobs_raise(knobs, item, tmp_path, monkeypatch):
    """Every launch knob of the reference is ported: ``backend='sharded'``
    without a mesh raises the reference's ``ValueError``, and ``mesh=``
    beside ``device=`` its "mutually exclusive" (both packages, same
    text).  A launch on a ``cox.Stream``, one pinned to
    ``torch.device("cpu")`` (A.9.2), a donating launch and a tuned one
    (A.9.3) run, bitwise the plain launch."""
    from repro_torch.core import autotune
    from repro_torch.core.streams import Dispatcher

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    rng = np.random.default_rng(5)
    args = (np.zeros(24, np.float32), rng.standard_normal(24).astype(np.float32), 24)
    if item is not None:
        exc, text = item
        with pytest.raises(exc, match=text):
            p_oob.launch(grid=1, block=32, args=args, **{"device": "cpu", **knobs})
        import jax

        ref_exc = rcox.CoxUnsupported if exc is CoxUnsupported else exc
        ref_knobs = dict(knobs, mesh=jax.make_mesh((1,), ("data",))) if "mesh" in knobs else knobs
        ref_dev = {"device": jax.devices()[0]} if "mesh" in knobs else {}
        with pytest.raises(ref_exc, match=text):
            r_oob.launch(grid=1, block=32, args=args, **ref_dev, **ref_knobs)
        return
    want = p_oob.launch(grid=1, block=32, args=args, device="cpu")
    d = Dispatcher(devices=[torch.device("cpu")])
    if "stream" in knobs:
        got = p_oob.launch(grid=1, block=32, args=args, stream=pcox.Stream("s", d))
    elif "device" in knobs:
        pinned = pcox.Stream("pinned", d, device=knobs["device"])
        got = p_oob.launch(grid=1, block=32, args=args, stream=pinned, **knobs)
        assert pinned.device == knobs["device"]
    else:
        held = tuple(torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a for a in args)
        got = p_oob.launch(grid=1, block=32, args=held, device="cpu", **knobs)
        if "donate" in knobs:  # the 1-D f32 tensors were consumed
            assert all(t.numel() == 0 for t in held[:2])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_auto_knobs_clamp_to_the_serial_path_and_say_so(pairs):
    """Nothing is clamped any more: 'auto' resolves MatrixMulCUDA to the
    block-parallel backend and the batched warp plane, as the
    reference's heuristics do."""
    from repro.core import runtime as ref_runtime
    from repro_torch.core import runtime

    r, p, _ = pairs["MatrixMulCUDA"]
    ck = p.kernel.compiled(collapse="hier")
    rl = runtime.resolve_launch(ck, grid=p.grid, block=p.block)
    assert (rl.backend, rl.warp_exec) == ("vmap", "batched")
    want = ref_runtime.resolve_launch(
        r.kernel.compiled(collapse="hier"), grid=r.grid, block=r.block
    )
    assert (rl.backend, rl.warp_exec, rl.chunk) == (want.backend, want.warp_exec, want.chunk)
    assert not hasattr(rl, "clamped")
