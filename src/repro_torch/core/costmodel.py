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
keeps (tinygrad's ``op_estimate``/``mem_estimate`` idiom), from one of
two sources:

* ``static`` -- the reference's IR walk: arithmetic instructions x
  threads for operations, twice the bound global bytes for memory,
  which gives the reference's numbers field by field.  No launch.
* ``xla`` -- the counterpart of the reference's compiled-program cost
  analysis (``cost_analysis()``: flops and bytes accessed, summed per
  HLO instruction over operands and outputs).  Nothing in PyTorch counts
  a COX launch without running it (``torch.utils.flop_counter`` sees
  matmul-class ops only), so the port runs the resolved launch once on
  zero-filled globals of the launch's shapes under a
  ``TorchDispatchMode`` and counts every aten op it issues, by the rules
  of :data:`OP_RULES`: operations are an arithmetic op's output elements
  (a reduction's input elements, 2 m n k for a product), bytes its
  tensor operands plus its outputs.  One extra launch for each distinct
  launch shape, on the launch's own device and stream;
  ``COX_COSTMODEL=xla`` forces it on the dispatcher's telemetry too.
  Where the counting pass raises ``CoxUnsupported`` the record degrades
  to the static walk, with ``source='static'``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from . import flat as _flat
from . import kernel_ir as K
from .dist_ops import collective_kind, result_bytes
from .execute import CompiledKernel, walk_instrs
from .regions import warp_peel_count
from .types import ArraySpec, CoxUnsupported, DType

# estimate source for the dispatcher's always-on telemetry: 'static' (the
# default) never launches; 'xla' counts one launch of each distinct shape
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
    coll_estimate: float  # collective bytes (0 on the static walk; counted on a sharded launch)
    shared_footprint: int  # static shared-memory bytes per block
    peel_count: int  # warp-graph peel blocks (batched-exec cost)
    collective_density: float  # warp collectives per IR instruction
    source: str  # 'xla' | 'static'

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


def telemetry_mode() -> str:
    """``COX_COSTMODEL``: 'static' (the default; any unknown value reads
    as 'static', as in the reference) or 'xla' (the counted launch)."""
    mode = os.environ.get(ENV_MODE, "static").strip().lower()
    return mode if mode in ("static", "xla") else "static"


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


# how the counted pass ('xla') prices the operations of one aten op, by
# its overload name (an in-place op by its out-of-place name):
# ('product', i) is 2 m n k with k the last dimension of operand i;
# ('input', i) the elements of operand i (a reduction, a scan, the source
# of a scatter).  An op not named here counts its output elements when
# torch tags it pointwise, its first operand's when it is a reduction, and
# no operations otherwise (creation, copies, indexing, host reads).  Bytes
# are every tensor operand plus every output, as XLA's "bytes accessed";
# a view moves none.
OP_RULES = {
    "mm": ("product", 0),
    "bmm": ("product", 0),
    "matmul": ("product", 0),
    "dot": ("product", 0),
    "mv": ("product", 0),
    "addmm": ("product", 1),
    "addmv": ("product", 1),
    "baddbmm": ("product", 1),
    "addbmm": ("product", 1),
    "cumsum": ("input", 0),
    "cumprod": ("input", 0),
    "scatter_add": ("input", 3),
    "scatter_reduce": ("input", 3),
    "index_add": ("input", 3),
    "index_reduce": ("input", 3),
}


def count_op(func, args, kwargs, out) -> Tuple[float, float]:
    """``(operations, bytes)`` of one aten op by the rules of
    :data:`OP_RULES`."""
    if func.is_view:
        return 0.0, 0.0
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    nbytes = float(sum(t.numel() * t.element_size() for t in ins + outs))
    name = func.overloadpacket.__name__
    rule = OP_RULES.get(name[:-1] if name.endswith("_") else name)
    if rule is None:
        if torch.Tag.pointwise in func.tags:
            return float(sum(t.numel() for t in outs)), nbytes
        if torch.Tag.reduction in func.tags and ins:
            return float(ins[0].numel()), nbytes
        return 0.0, nbytes
    kind, i = rule
    if kind == "product":
        return 2.0 * sum(t.numel() for t in outs) * args[i].shape[-1], nbytes
    return float(args[i].numel()), nbytes


class OpCounter(TorchDispatchMode):
    """Sums :func:`count_op` over every aten op run under it (``ops``,
    ``bytes``, ``n_ops``), and the result bytes of every collective
    (``coll``: a sharded launch's merges, one ``all_gather`` each)."""

    def __init__(self):
        super().__init__()
        self.ops = 0.0
        self.bytes = 0.0
        self.coll = 0.0
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if collective_kind(func):
            self.coll += result_bytes(func, args, out)
            self.n_ops += 1
            return out
        ops, nbytes = count_op(func, args, kwargs, out)
        self.ops += ops
        self.bytes += nbytes
        self.n_ops += 1
        return out


def _counted_estimate(
    ck: CompiledKernel, rl, shapes: Dict[str, tuple], *, simd: bool, scalars, device, mesh=None, axis="data"
) -> CostEstimate:
    """The 'xla' record: one launch of the resolved shape on zero-filled
    globals (the tuner's ``_zero_globals``) and the given scalars (zeros
    where none are given), on ``device`` and its current stream, counted
    op by op.  A field the count leaves at 0 takes the static walk's
    value, as the reference's falls back to its HLO parse.

    A sharded launch is counted on its mesh (every rank of it estimates
    alike, as every rank launches): ``coll_estimate`` is the result bytes
    of its merges' ``all_gather`` (``AxisGroup.gather``: every rank's
    packed copy).  The reference's merge is a ``psum``, whose all-reduce
    result is one copy, so its count differs from the port's by design."""
    from . import runtime as _runtime
    from .autotune import _zero_globals
    from .backends.plan import materialize_args

    sharded = rl.backend == "sharded"
    if sharded:
        if mesh is None:
            raise CoxUnsupported(f"kernel '{ck.kernel.name}': a sharded launch is counted on its mesh")
        from .backends.sharded import mesh_device

        device = mesh_device(mesh)  # this rank's device of the mesh
    device = _runtime.resolve_device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise CoxUnsupported(
            f"kernel '{ck.kernel.name}': the counted cost pass launches the "
            f"kernel, and a CUDA graph capture is running on this stream"
        )
    held_s = {
        spec.name: (scalars or {}).get(spec.name, np.zeros((), spec.dtype.np))
        for spec in ck.kernel.params
        if not isinstance(spec, ArraySpec)
    }
    _, run = _runtime.build_resolved(ck, rl, simd=simd, mesh=mesh if sharded else None, axis=axis)
    g, s = materialize_args(ck, _zero_globals(ck, shapes, device), held_s, device)
    counter = OpCounter()
    with counter:
        run(g, s, device)
    st = _static_estimate(ck, rl, shapes)
    return CostEstimate(
        op_estimate=counter.ops if counter.ops > 0 else st.op_estimate,
        mem_estimate=counter.bytes if counter.bytes > 0 else st.mem_estimate,
        coll_estimate=counter.coll,
        shared_footprint=st.shared_footprint,
        peel_count=st.peel_count,
        collective_density=st.collective_density,
        source="xla",
    )


def estimate(
    ck: CompiledKernel,
    rl,
    shapes: Dict[str, tuple],
    *,
    simd: bool = True,
    mode: Optional[str] = None,
    scalars: Optional[Dict[str, object]] = None,
    device=None,
    mesh=None,
    axis: str = "data",
) -> CostEstimate:
    """The cost record of one resolved launch shape, cached per (kernel,
    knobs, the mesh's shape, shapes), as the reference caches it.  ``mode=None`` follows
    ``COX_COSTMODEL`` ('static' by default); 'xla' counts one launch on
    ``device`` (by default the card) with ``scalars`` (zeros where none
    are given; the first count of a shape is kept), a sharded one on
    ``mesh`` over ``axis``, with its collective bytes.  Never raises for a
    launch the counting pass refuses (``CoxUnsupported``): the record
    degrades to the static walk and says so in ``source``.  A CUDA
    error is not caught."""
    mode = telemetry_mode() if mode is None else mode
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
        None if mesh is None else (tuple(mesh.shape), axis),
        tuple(sorted(shapes.items())),
        mode,
    )
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            return hit
    if mode == "xla":
        try:
            est = _counted_estimate(ck, rl, shapes, simd=simd, scalars=scalars, device=device, mesh=mesh, axis=axis)
        except CoxUnsupported:
            est = _static_estimate(ck, rl, shapes)
    else:
        est = _static_estimate(ck, rl, shapes)
    with _cache_lock:
        _cache[key] = est
        while len(_cache) > _CACHE_MAX:
            _cache.pop(next(iter(_cache)))
    return est


def estimate_request(req, mode: Optional[str] = None) -> CostEstimate:
    """:func:`estimate` keyed off a dispatcher ``LaunchRequest``: the
    counted pass uses its scalars and runs on its device."""
    from . import runtime as _runtime

    return estimate(
        req.ck,
        req.rl,
        req.shapes,
        simd=req.simd,
        mode=mode,
        scalars=req.scalars,
        device=req.target if req.target is not None else _runtime.physical(req.device),
        mesh=req.mesh,
        axis=req.axis,
    )


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()
