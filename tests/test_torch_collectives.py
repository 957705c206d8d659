"""The port's warp collectives against the JAX package's.

The deterministic case grid of ``tests/test_collectives_property.py``:
every collective, tile widths 0/8/16, full and partial last warps, 1-D
``(W,)`` buffers and a leading warp axis, through the port's vectorized
and scalar ("w/o AVX") backends, against the reference's matching
backend on the same numpy inputs.  Shuffles, votes, ballots and integer
reductions must agree bitwise.  Float buffers hold small integers, so
their sums are exact in any order and agree bitwise too; a separate
case with normal floats holds ``red_add`` to a tolerance, because a
float sum's rounding depends on its order.
"""

import numpy as np
import pytest
import torch

from repro.core import collectives as RC
from repro_torch.core import collectives as PC
from repro_torch.core.types import CoxUnsupported

W = 32
FUNCS = sorted(RC.VECTORIZED)
WIDTHS = (0, 8, 16)
VOTES = ("vote_all", "vote_any", "ballot")


def _extra_args(func):
    """Positional operand(s) each collective takes after the buffer."""
    if func in ("shfl_down", "shfl_up"):
        return (3,)
    if func == "shfl_xor":
        return (1,)
    if func == "shfl_idx":
        return (np.full(W, 2, np.int32),)
    return ()


def _buf(rng, shape, func, dtype=np.float32):
    if func in VOTES:
        return rng.integers(0, 2, shape).astype(bool)
    return rng.integers(-8, 9, shape).astype(dtype)


def _mask(partial: bool):
    if not partial:
        return None
    m = np.zeros(W, bool)
    m[:16] = True  # a partial last warp: 16 live lanes
    return m


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _port(table, func, buf, extra, width, mask):
    extra = [_t(e) if isinstance(e, np.ndarray) else e for e in extra]
    out = table[func](_t(buf), *extra, W=W, width=width, mask=_t(mask)).numpy()
    return out.astype(np.uint32) if func == "ballot" else out


def _ref(func, buf, extra, width, mask, table=RC.VECTORIZED):
    return np.asarray(table[func](buf, *extra, W=W, width=width, mask=mask))


BACKENDS = [(PC.VECTORIZED, RC.VECTORIZED), (PC.SCALAR, RC.SCALAR)]


@pytest.mark.parametrize("lead", [(), (4,), (3, 4)], ids=["1d", "plane", "chunk-plane"])
@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("func", FUNCS)
def test_collective_matches_reference(func, width, partial, lead):
    rng = np.random.default_rng([FUNCS.index(func), width, partial, len(lead)])
    buf = _buf(rng, lead + (W,), func)
    mask = _mask(partial)
    extra = _extra_args(func)
    for port, ref in BACKENDS:
        want = _ref(func, buf, extra, width, mask, ref)
        got = _port(port, func, buf, extra, width, mask)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{func}/w={width}")


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
@pytest.mark.parametrize("func", ["red_add", "red_max", "red_min"])
def test_int_reductions_match_reference(func, partial):
    rng = np.random.default_rng(5)
    buf = rng.integers(-(2**20), 2**20, (3, W)).astype(np.int32)
    mask = _mask(partial)
    want = _ref(func, buf, (), 0, mask)
    for table in (PC.VECTORIZED, PC.SCALAR):
        got = _port(table, func, buf, (), 0, mask)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", WIDTHS)
def test_float_red_add_within_tolerance(width):
    rng = np.random.default_rng(9)
    buf = rng.normal(size=(4, W)).astype(np.float32)
    want = _ref("red_add", buf, (), width, None)
    for table in (PC.VECTORIZED, PC.SCALAR):
        got = _port(table, "red_add", buf, (), width, None)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ballot_lane_31_is_bitwise():
    buf = np.zeros(W, bool)
    buf[[0, 5, 31]] = True
    want = _ref("ballot", buf, (), 0, None)
    assert want[0] == np.uint32(0x80000021)
    for table in (PC.VECTORIZED, PC.SCALAR):
        got = _port(table, "ballot", buf, (), 0, None)
        np.testing.assert_array_equal(got, want)
    # u32 values are carried in int64, in range: bit 31 is not a sign bit
    raw = PC.VECTORIZED["ballot"](torch.from_numpy(buf), W=W)
    assert raw.dtype == torch.int64 and int(raw[0]) == 0x80000021


@pytest.mark.parametrize("func", ["shfl_down", "shfl_up", "shfl_xor"])
def test_per_warp_offset_planes(func):
    """Per-warp offsets (an (n_warps, W) plane) through both backends."""
    rng = np.random.default_rng(3)
    n_warps = 3
    buf = rng.integers(-8, 9, (n_warps, W)).astype(np.float32)
    off = np.broadcast_to(rng.integers(1, 4, (n_warps, 1)), (n_warps, W))
    off = off.astype(np.int32)
    want = np.stack(
        [_ref(func, buf[i], (off[i],), 0, None) for i in range(n_warps)]
    )
    for table in (PC.VECTORIZED, PC.SCALAR):
        np.testing.assert_array_equal(_port(table, func, buf, (off,), 0, None), want)


def test_invalid_tile_width_rejected():
    for bad in (3, 12, 64):
        with pytest.raises(CoxUnsupported):
            PC.VECTORIZED["red_add"](torch.ones(W), W=W, width=bad)
