"""The launch footprint model: which schedule a block-parallel launch takes.

This is the static part of the reference's cost model
(``repro/core/costmodel.py:44-262``).  ``chunk_footprint`` and
``stride_footprint`` price a wave's residency -- one copy of global
memory per block of the wave plus its shared memory (per warp when the
batched plane copies it), and for the chunked schedule its O(grid)
block-id table -- and ``schedule_verdict`` turns them into the
chunked-or-grid-stride decision that ``runtime.resolve_schedule`` makes
for ``schedule='auto'``.  ``COX_FOOTPRINT_BUDGET`` overrides the budget
so tests can force the grid-stride path on small inputs.

Bytes are priced at each type's declared width, as the reference prices
them (an ``i64`` array counts 8 bytes though both packages store it in
32 bits), so ``auto`` picks the reference's schedule.

``estimate`` is the per-launch cost record the dispatcher's telemetry
keeps (tinygrad's ``op_estimate``/``mem_estimate`` idiom): the
reference's ``static`` source, an IR walk -- arithmetic instructions x
threads for operations, twice the bound global bytes for memory -- which
gives the reference's numbers field by field.  The reference's second
source, ``xla``, reads XLA's cost analysis of the compiled program;
nothing in PyTorch counts a COX launch's operations and bytes without
running it (``torch.utils.flop_counter`` sees matmul-class ops only), so
``mode='xla'`` and ``COX_COSTMODEL=xla`` raise ``CoxUnsupported`` naming
ROADMAP A.9.3, which brings the measured counterpart with the autotuner.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from . import flat as _flat
from . import kernel_ir as K
from .execute import CompiledKernel, walk_instrs
from .regions import warp_peel_count
from .types import ArraySpec, CoxUnsupported, DType

# estimate source for the dispatcher's always-on telemetry: 'static' (the
# default, and the only one the port has)
ENV_MODE = "COX_COSTMODEL"

# residency budget for a chunked wave's schedule-dependent footprint
FOOTPRINT_BUDGET = 64 << 20
ENV_BUDGET = "COX_FOOTPRINT_BUDGET"

# wave widths the residency sizer considers, widest first
RESIDENT_CANDIDATES = (32, 16, 8, 4, 2, 1)


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One launch's cost record (the ASTRunner fields plus the static
    features the autotuner prunes candidates with)."""

    op_estimate: float  # arithmetic-op proxy per dispatch
    mem_estimate: float  # bytes touched per dispatch
    coll_estimate: float  # collective bytes (sharded launches: A.10)
    shared_footprint: int  # static shared-memory bytes per block
    peel_count: int  # warp-graph peel blocks (batched-exec cost)
    collective_density: float  # warp collectives per IR instruction
    source: str  # 'static'

    def gflops(self, seconds: float) -> float:
        """Achieved GFLOPS for a measured wall time."""
        if seconds <= 0:
            return 0.0
        return self.op_estimate / seconds / 1e9

    def gbps(self, seconds: float) -> float:
        """Achieved memory bandwidth (GB/s) for a measured wall time."""
        if seconds <= 0:
            return 0.0
        return self.mem_estimate / seconds / 1e9


_cache: Dict[tuple, CostEstimate] = {}
_cache_lock = threading.Lock()
_CACHE_MAX = 1024


def _xla_unported() -> CoxUnsupported:
    return CoxUnsupported(
        "costmodel mode 'xla' (the compiled program's own cost analysis) is "
        "not ported to repro_torch yet: ROADMAP queue item A.9.3 (autotune.py "
        "and the measured cost model); use the 'static' estimate"
    )


def telemetry_mode() -> str:
    """``COX_COSTMODEL``: 'static' (default; any unknown value reads as
    'static', as in the reference), and 'xla' raises (ROADMAP A.9.3)."""
    mode = os.environ.get(ENV_MODE, "static").strip().lower()
    if mode == "xla":
        raise _xla_unported()
    return "static"


def footprint_budget() -> int:
    """``COX_FOOTPRINT_BUDGET`` (a positive byte count; anything else
    raises at the launch that reads it) or ``FOOTPRINT_BUDGET``."""
    raw = os.environ.get(ENV_BUDGET)
    if raw is None or not raw.strip():
        return FOOTPRINT_BUDGET
    try:
        val = int(raw.strip())
    except ValueError:
        raise ValueError(f"{ENV_BUDGET}={raw!r} is not an integer byte count") from None
    if val <= 0:
        raise ValueError(f"{ENV_BUDGET}={raw!r} must be a positive byte count")
    return val


def kernel_features(ck: CompiledKernel) -> Tuple[int, int, float]:
    """Static features: (shared bytes a block, warp peel count,
    collective density -- warp collectives per IR instruction)."""
    shared = _flat.shared_footprint(ck.kernel)
    machines = (ck.machine,) if not ck.phases else tuple(p.machine for p in ck.phases)
    peels = sum(warp_peel_count(m) for m in machines)
    instrs = list(walk_instrs(ck))
    n_coll = sum(1 for s in instrs if isinstance(s, K.WarpCall))
    return shared, peels, n_coll / max(1, len(instrs))


def _declared_bytes(dt: DType) -> int:
    return 8 if dt is DType.i64 else dt.itemsize


def global_bytes(ck: CompiledKernel, shapes: Dict[str, tuple]) -> int:
    """Total bytes of the bound global-memory arrays."""
    total = 0
    for spec in ck.kernel.params:
        shape = shapes.get(spec.name) if isinstance(spec, ArraySpec) else None
        if shape is None:
            continue
        n = 1
        for d in shape:
            n *= int(d)
        total += n * _declared_bytes(spec.dtype)
    return total


def _per_block_bytes(
    ck: CompiledKernel, shapes: Dict[str, tuple], *, n_warps: int, warp_exec: str
) -> int:
    """One block's resident bytes in a wave: its copy of global memory
    plus its shared memory -- per warp when the batched plane copies it."""
    shared, _, _ = kernel_features(ck)
    return global_bytes(ck, shapes) + shared * (n_warps if warp_exec == "batched" else 1)


def bid_table_bytes(grid: int, chunk: int) -> int:
    """Bytes of the ``(n_chunks, chunk)`` -1-padded block-id table of the
    chunked schedule (``LaunchPlan.chunked_bids``): the O(grid) term the
    grid-stride schedule has not."""
    chunk = max(1, int(chunk))
    return -(-int(grid) // chunk) * chunk * 4  # int32 entries


def chunk_footprint(
    ck: CompiledKernel,
    shapes: Dict[str, tuple],
    *,
    chunk: int,
    n_warps: int,
    warp_exec: str = "serial",
    grid: Optional[int] = None,
) -> int:
    """Resident bytes of the chunked schedule: ``chunk`` per-block
    copies, and with ``grid`` the block-id table, which no smaller chunk
    can shrink -- why an over-budget verdict strides instead."""
    per_block = _per_block_bytes(ck, shapes, n_warps=n_warps, warp_exec=warp_exec)
    total = int(chunk) * per_block
    if grid is not None:
        total += bid_table_bytes(grid, chunk)
    return total


def stride_footprint(
    ck: CompiledKernel,
    shapes: Dict[str, tuple],
    *,
    n_resident: int,
    n_warps: int,
    warp_exec: str = "serial",
) -> int:
    """Resident bytes of one grid-stride wave: ``n_resident`` slot
    copies and no table, so the footprint does not grow with the grid."""
    return int(n_resident) * _per_block_bytes(
        ck, shapes, n_warps=n_warps, warp_exec=warp_exec
    )


def resident_slots(
    ck: CompiledKernel,
    shapes: Dict[str, tuple],
    *,
    grid: int,
    n_warps: int,
    warp_exec: str = "serial",
    budget: Optional[int] = None,
) -> int:
    """The grid-stride wave width: the widest ``RESIDENT_CANDIDATES``
    entry whose :func:`stride_footprint` fits the budget, floored at
    ``min(grid, DEFAULT_CHUNK)`` (below it a narrower wave saves no real
    memory -- one copy of global memory is live under every schedule --
    and only adds merge passes)."""
    from .backends.plan import DEFAULT_CHUNK

    budget = footprint_budget() if budget is None else int(budget)
    floor = min(int(grid), DEFAULT_CHUNK)
    for width in RESIDENT_CANDIDATES:
        if width <= floor:
            break
        fits = (
            stride_footprint(
                ck, shapes, n_resident=width, n_warps=n_warps, warp_exec=warp_exec
            )
            <= budget
        )
        if width <= grid and fits:
            return width
    return max(1, floor)


def schedule_verdict(
    ck: CompiledKernel,
    shapes: Dict[str, tuple],
    *,
    grid: int,
    chunk: int,
    n_warps: int,
    warp_exec: str = "serial",
    backend: str = "vmap",
    budget: Optional[int] = None,
) -> Tuple[str, Optional[int]]:
    """``('chunked', None)`` when the chunk-table schedule fits the
    budget (or the grid is one wave), else ``('grid_stride',
    n_resident)`` with the width from :func:`resident_slots`.  For
    ``backend='scan'`` only the block-id sequence counts: scan holds one
    copy of global memory under every schedule, and its grid-stride form
    has width 1."""
    grid = int(grid)
    chunk = max(1, int(chunk))
    budget = footprint_budget() if budget is None else int(budget)
    if backend == "scan":
        if bid_table_bytes(grid, 1) > budget:
            return "grid_stride", 1
        return "chunked", None
    if grid <= chunk:
        return "chunked", None
    fits = (
        chunk_footprint(
            ck, shapes, chunk=chunk, n_warps=n_warps, warp_exec=warp_exec, grid=grid
        )
        <= budget
    )
    if fits:
        return "chunked", None
    return "grid_stride", resident_slots(
        ck, shapes, grid=grid, n_warps=n_warps, warp_exec=warp_exec, budget=budget
    )


def _static_estimate(ck: CompiledKernel, rl, shapes: Dict[str, tuple]) -> CostEstimate:
    shared, peels, density = kernel_features(ck)
    # arithmetic proxy: every non-structural instruction is ~1 op per
    # thread; warp collectives cost ~log2(W) lane ops
    arith = 0.0
    for s in walk_instrs(ck):
        if isinstance(s, K.WarpCall):
            arith += max(1, int(np.log2(max(2, ck.warp_size))))
        elif not isinstance(s, K.Barrier):
            arith += 1
    threads = rl.grid.total * rl.block.total
    return CostEstimate(
        op_estimate=arith * threads,
        mem_estimate=2.0 * global_bytes(ck, shapes),
        coll_estimate=0.0,
        shared_footprint=shared,
        peel_count=peels,
        collective_density=density,
        source="static",
    )


def estimate(
    ck: CompiledKernel,
    rl,
    shapes: Dict[str, tuple],
    *,
    simd: bool = True,
    mode: Optional[str] = None,
) -> CostEstimate:
    """The cost record of one resolved launch shape, cached per (kernel,
    knobs, shapes).  ``mode=None`` follows ``COX_COSTMODEL``; 'xla'
    raises ``CoxUnsupported`` (ROADMAP A.9.3) rather than hand back the
    static record under another name."""
    mode = telemetry_mode() if mode is None else mode
    if mode == "xla":
        raise _xla_unported()
    key = (
        id(ck),
        rl.backend,
        rl.mode,
        rl.warp_exec,
        rl.grid.astuple(),
        rl.block.astuple(),
        rl.chunk,
        rl.schedule,
        rl.n_resident,
        simd,
        tuple(sorted(shapes.items())),
        mode,
    )
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            return hit
    est = _static_estimate(ck, rl, shapes)
    with _cache_lock:
        _cache[key] = est
        while len(_cache) > _CACHE_MAX:
            _cache.pop(next(iter(_cache)))
    return est


def estimate_request(req, mode: Optional[str] = None) -> CostEstimate:
    """:func:`estimate` keyed off a dispatcher ``LaunchRequest``."""
    return estimate(req.ck, req.rl, req.shapes, simd=req.simd, mode=mode)


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()
