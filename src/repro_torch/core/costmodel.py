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

The per-launch ``estimate`` (the reference reads XLA's
``cost_analysis``) is ROADMAP queue item A.9.2 and is not here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from . import flat as _flat
from . import kernel_ir as K
from .execute import CompiledKernel, walk_instrs
from .regions import warp_peel_count
from .types import ArraySpec, DType

# residency budget for a chunked wave's schedule-dependent footprint
FOOTPRINT_BUDGET = 64 << 20
ENV_BUDGET = "COX_FOOTPRINT_BUDGET"

# wave widths the residency sizer considers, widest first
RESIDENT_CANDIDATES = (32, 16, 8, 4, 2, 1)


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
