"""Shared types for the COX core compiler, with PyTorch dtype tables.

The compile layers (frontend through typeinfer) only name ``DType``
members; the executor maps them to torch dtypes here.  Two mappings
keep launches bitwise-comparable with the JAX package, which runs with
64-bit types disabled:

* ``DType.i64`` stores as ``torch.int32`` -- what the reference really
  produces for an i64 array (JAX canonicalizes int64 to int32).
* ``DType.u32`` is *carried* as ``torch.int64`` holding values in
  ``[0, 2**32)``: torch's ``uint32`` has no shifts, sums or bitwise ops
  on CUDA.  Results wrap back into range after integer arithmetic, and
  launches hand ``u32`` arrays back as ``torch.uint32``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np
import torch

WARP_SIZE = 32  # CUDA warpSize, native on Hopper

# CUDA launch-geometry limits (compute capability >= 2.x, the paper's
# benchmark hardware): per-axis block caps, 1024 threads per block, and
# the 65535 cap on grid y/z.
CUDA_MAX_BLOCK = (1024, 1024, 64)
CUDA_MAX_BLOCK_THREADS = 1024
CUDA_MAX_GRID = (2**31 - 1, 65535, 65535)

U32_MASK = 0xFFFFFFFF


class CoxUnsupported(Exception):
    """Raised when a kernel uses a feature outside the supported set,
    or a launch asks for a knob the port does not run yet."""


class CoxTypeError(Exception):
    pass


class DType(enum.Enum):
    f32 = "f32"
    f16 = "f16"
    bf16 = "bf16"
    i32 = "i32"
    i64 = "i64"
    u32 = "u32"
    b1 = "b1"  # predicate / bool

    @property
    def torch(self) -> torch.dtype:
        """The dtype a launch returns for an array of this type."""
        return _TORCH[self]

    @property
    def compute(self) -> torch.dtype:
        """The dtype the executor holds values of this type in."""
        return torch.int64 if self is DType.u32 else _TORCH[self]

    @property
    def np(self):
        """The numpy dtype of the same values (bf16 has none: float32)."""
        return _NUMPY[self]

    @property
    def itemsize(self) -> int:
        return _TORCH[self].itemsize

    @property
    def is_float(self) -> bool:
        return self in (DType.f32, DType.f16, DType.bf16)

    @property
    def is_int(self) -> bool:
        return self in (DType.i32, DType.i64, DType.u32)


_TORCH = {
    DType.f32: torch.float32,
    DType.f16: torch.float16,
    DType.bf16: torch.bfloat16,
    DType.i32: torch.int32,
    DType.i64: torch.int32,  # JAX's x64-off canonicalization
    DType.u32: torch.uint32,
    DType.b1: torch.bool,
}

_NUMPY = {
    DType.f32: np.dtype(np.float32),
    DType.f16: np.dtype(np.float16),
    DType.bf16: np.dtype(np.float32),
    DType.i32: np.dtype(np.int32),
    DType.i64: np.dtype(np.int32),
    DType.u32: np.dtype(np.uint32),
    DType.b1: np.dtype(np.bool_),
}


def from_torch(dt: torch.dtype) -> DType:
    table = {
        torch.float32: DType.f32,
        torch.float16: DType.f16,
        torch.bfloat16: DType.bf16,
        torch.int32: DType.i32,
        torch.int64: DType.i64,
        torch.uint32: DType.u32,
        torch.bool: DType.b1,
    }
    if dt not in table:
        raise CoxTypeError(f"unsupported dtype {dt}")
    return table[dt]


def from_numpy(dt) -> DType:
    dt = np.dtype(dt)
    table = {
        np.dtype(np.float32): DType.f32,
        np.dtype(np.float16): DType.f16,
        np.dtype(np.int32): DType.i32,
        np.dtype(np.int64): DType.i64,
        np.dtype(np.uint32): DType.u32,
        np.dtype(np.bool_): DType.b1,
    }
    if dt not in table:
        raise CoxTypeError(f"unsupported dtype {dt}")
    return table[dt]


def promote(a: DType, b: DType) -> DType:
    """C-style arithmetic promotion over our small lattice."""
    if a == b:
        return a
    order = [
        DType.b1,
        DType.i32,
        DType.u32,
        DType.i64,
        DType.bf16,
        DType.f16,
        DType.f32,
    ]
    # float beats int; f32 is the top float.
    if a.is_float or b.is_float:
        floats = [d for d in (a, b) if d.is_float]
        if len(floats) == 2 and floats[0] != floats[1]:
            return DType.f32
        return floats[0]
    return order[max(order.index(a), order.index(b))]


@dataclasses.dataclass(frozen=True)
class Dim3:
    """CUDA ``dim3`` launch geometry.  The internal schedule stays
    *linear*: threads linearize x-fastest into warps and blocks
    linearize the same way into the grid walk."""

    x: int
    y: int = 1
    z: int = 1

    @property
    def total(self) -> int:
        return self.x * self.y * self.z

    def astuple(self) -> tuple:
        return (self.x, self.y, self.z)

    def __repr__(self):
        return f"dim3({self.x}, {self.y}, {self.z})"


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def as_dim3(v, what: str = "launch dimension") -> Dim3:
    """Normalize ``int | (x,) | (x, y) | (x, y, z) | Dim3`` to one
    canonical :class:`Dim3` (missing axes are 1, CUDA's default)."""
    if isinstance(v, Dim3):
        d = v
    elif _is_int(v):
        d = Dim3(int(v))
    elif isinstance(v, (tuple, list)):
        if not 1 <= len(v) <= 3:
            raise ValueError(f"{what} must have 1-3 components, got {v!r}")
        if not all(_is_int(c) for c in v):
            raise TypeError(f"{what} components must be ints, got {v!r}")
        d = Dim3(*(int(c) for c in v))
    else:
        raise TypeError(
            f"{what} must be an int or a 1-3 tuple of ints, got {type(v).__name__}"
        )
    if d.x <= 0 or d.y <= 0 or d.z <= 0:
        raise ValueError(f"{what} components must be positive, got {d}")
    return d


def dim3_tuple(v) -> Optional[tuple]:
    """Normalize a Dim3 / tuple / None to a static (x, y, z) int tuple
    (None passes through: 'no geometry -- treat as 1-D linear')."""
    if v is None:
        return None
    if isinstance(v, Dim3):
        return v.astuple()
    t = tuple(int(c) for c in v)
    return t + (1,) * (3 - len(t))


def check_launch_geometry(grid: Dim3, block: Dim3):
    """Enforce CUDA's launch limits on a normalized dim3 pair."""
    for ax, extent, cap in zip("xyz", block.astuple(), CUDA_MAX_BLOCK):
        if extent > cap:
            raise CoxUnsupported(
                f"CUDA blocks are limited to {cap} threads along "
                f"{ax} (got block.{ax}={extent})"
            )
    if block.total > CUDA_MAX_BLOCK_THREADS:
        raise CoxUnsupported(
            f"CUDA blocks are limited to {CUDA_MAX_BLOCK_THREADS} threads "
            f"(got {block} = {block.total})"
        )
    for ax, extent, cap in zip("xyz", grid.astuple(), CUDA_MAX_GRID):
        if extent > cap:
            raise CoxUnsupported(
                f"CUDA grids are limited to {cap} blocks along "
                f"{ax} (got grid.{ax}={extent})"
            )


class BarrierLevel(enum.Enum):
    """Hierarchy of barrier scopes: WARP < BLOCK < GRID."""

    WARP = "warp"  # __syncwarp() / implicit from warp collectives
    BLOCK = "block"  # __syncthreads()
    GRID = "grid"  # this_grid().sync(): cooperative-groups grid barrier

    @property
    def rank(self) -> int:
        return {"warp": 0, "block": 1, "grid": 2}[self.value]

    def __ge__(self, other: "BarrierLevel") -> bool:  # wider scope subsumes
        return self.rank >= other.rank


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A kernel parameter backed by global memory."""

    name: str
    dtype: DType


@dataclasses.dataclass(frozen=True)
class ScalarSpec:
    """A kernel parameter passed by value (block-uniform)."""

    name: str
    dtype: DType


@dataclasses.dataclass(frozen=True)
class SharedSpec:
    """A __shared__ array declaration (per-block)."""

    name: str
    shape: tuple
    dtype: DType


ParamSpec = Any  # ArraySpec | ScalarSpec
