"""COX runtime: grid launch (the paper section 4 host side).

The paper forks one pthread per CUDA block.  Here the grid runs through
a pluggable backend (``backends``):

* ``scan`` -- one block after another, carrying global memory in place
  (a legal schedule: CUDA guarantees nothing about cross-block ordering
  between grid-wide syncs);
* ``vmap`` -- waves of blocks run at once as a leading copy axis of the
  executor's tensors; the blocks' copies of global memory are
  reconciled with single-writer write masks and summed atomic deltas
  (``backends/merge.py``);
* ``sharded`` -- the grid dealt over an axis of a ``torch.distributed``
  ``DeviceMesh`` (``mesh=``, ``axis=``), each rank running its slice
  with the ``vmap`` executor on its own device, the ranks' copies merged
  across the axis.  Every rank makes the same launch and gets the merged
  globals back.

``backend='auto'`` and ``warp_exec='auto'`` apply the reference's
heuristics (``flat.choose_backend`` / ``choose_warp_exec``), and
``schedule='auto'`` its footprint verdict (``costmodel``), so a launch
takes the path the reference would.

``KernelFn.launch`` does not call :func:`launch` any more: it builds a
request (``api.KernelFn.make_request``) and issues it on the default
stream of the dispatcher (``streams.py``), which stages the plan through
its shared cache, orders it against the other streams and runs it.
:func:`launch` stays the uncached entry point, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from . import backends as _backends
from . import flat as _flat
from .backends.plan import (
    DEFAULT_CHUNK,
    LaunchPlan,
    check_donate_supported,
    consume_donated,
    hold_kernel_args,
    materialize_args,
    unbind_outputs,
)
from .execute import CompiledKernel
from .types import (
    COOP_MAX_RESIDENT_BLOCKS,
    CoxUnsupported,
    Dim3,
    as_dim3,
    check_launch_geometry,
)

def resolve_device(device) -> torch.device:
    """The launch's torch device.  ``None`` means CUDA: a launch runs on
    the card unless the caller asks for the CPU, and raises when there
    is no card rather than carrying on on the host.  A ``str`` or a
    ``torch.device`` names the device, and pins the launch to it (the
    reference's ``device=`` placement pin)."""
    if device is None:
        device = "cuda"
    if not isinstance(device, (str, torch.device)):
        raise TypeError(
            f"device must be None, a str or a torch.device, got {type(device).__name__}"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "launch on the host"
        )
    if device.type not in ("cuda", "cpu"):
        raise CoxUnsupported(f"device type {device.type!r}: expected cuda or cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class LogicalDevice:
    """A device of a pool that shares its physical ``device`` with the
    pool's other logical devices (``launch.mesh.device_pool(n,
    logical=True)``).  Placement, the per-device health counters, sticky
    errors, ``device_reset(device=)`` and the staging-cache keys key on
    it, not on ``device``; on the card each cox stream issues a logical
    device's work on a CUDA stream of its own."""

    id: int
    device: torch.device

    def __str__(self):
        return f"{self.device}/logical{self.id}"


def physical(entry) -> Optional[torch.device]:
    """The torch device a pool entry runs on."""
    return entry.device if isinstance(entry, LogicalDevice) else entry


def resolve_entry(device):
    """A pool entry as given (a :class:`LogicalDevice`), or a device
    resolved by :func:`resolve_device`."""
    return device if isinstance(device, LogicalDevice) else resolve_device(device)


def launch_device(device, mesh, axis: str, kernel_name: str) -> torch.device:
    """The device a launch runs on: ``device=`` (``resolve_device``), or
    for a sharded launch the rank's own device of ``mesh``.  The two are
    mutually exclusive, as in the reference."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        raise CoxUnsupported(
            f"kernel '{kernel_name}': device= and mesh= are mutually exclusive -- "
            f"a sharded launch spans the mesh's own devices; placement applies "
            f"to single-device launches"
        )
    from .backends import sharded

    sharded.check_mesh(mesh, axis)
    return sharded.mesh_device(mesh)


@dataclasses.dataclass(frozen=True)
class ResolvedLaunch:
    """Launch knobs after dim3 normalization and 'auto' resolution.

    ``chunk``/``chunk_source`` are the blocks a wave and where that came
    from: ``'explicit'`` (the caller's ``chunk=``), ``'heuristic'``
    (``min(grid, DEFAULT_CHUNK)``) or ``'cooperative'`` (pinned by the
    grid-sync residency rule).  ``schedule``/``n_resident``/
    ``schedule_source`` do the same for the schedule: ``'chunked'``
    walks the ``(n_chunks, chunk)`` block-id table, ``'grid_stride'``
    runs waves of ``n_resident`` blocks over the grid; the source is
    ``'explicit'``, ``'heuristic'`` (the footprint verdict, applied once
    argument shapes are bound) or ``'cooperative'`` (a grid-sync grid
    beyond the resident capacity)."""

    grid: Dim3
    block: Dim3
    backend: str  # 'scan' | 'vmap' | 'sharded'
    mode: str  # 'normal' | 'jit'
    warp_exec: str  # 'serial' | 'batched'
    n_warps: int
    chunk: Optional[int] = None
    chunk_source: str = "heuristic"
    schedule: str = "chunked"
    n_resident: Optional[int] = None
    schedule_source: str = "heuristic"


def resolve_chunk(ck: CompiledKernel, grid: int, chunk) -> tuple:
    """The ``chunk`` knob as ``(value, source)``: an int is explicit
    (clamped to the grid), ``None``/'auto' the ``min(grid,
    DEFAULT_CHUNK)`` heuristic; cooperative launches pin ``chunk ==
    grid`` as ``LaunchPlan.build`` does."""
    auto = chunk is None or chunk == "auto"
    if ck.n_phases > 1:
        if not auto and int(chunk) < grid:
            raise CoxUnsupported(
                f"cooperative launch of '{ck.kernel.name}': chunk={chunk} "
                f"would split the grid into waves, but a grid barrier needs "
                f"every block resident per phase -- drop chunk= (the plan "
                f"schedules all {grid} blocks as one wave)"
            )
        return grid, "cooperative"
    if auto:
        return min(grid, DEFAULT_CHUNK), "heuristic"
    c = int(chunk)
    if c < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk!r}")
    return min(c, grid), "explicit"


def resolve_launch(
    ck: CompiledKernel,
    *,
    grid,
    block,
    mode: str = "auto",
    backend: str = "auto",
    warp_exec: str = "auto",
    chunk=None,
    schedule: str = "auto",
    n_resident: Optional[int] = None,
    mesh=None,
) -> ResolvedLaunch:
    """Normalize ``grid``/``block`` to dim3, enforce CUDA's launch
    limits and resolve the 'auto' knobs with the reference's rules.

    ``n_resident`` sizes the grid-stride wave and implies
    ``schedule='grid_stride'``.  A cooperative grid beyond the resident
    capacity lowers to a grid-strided phase wave instead of raising,
    unless the caller pins ``schedule='chunked'``."""
    grid3 = as_dim3(grid, "grid")
    block3 = as_dim3(block, "block")
    check_launch_geometry(grid3, block3)
    if schedule not in ("auto", "chunked", "grid_stride"):
        raise ValueError(
            f"schedule must be 'auto', 'chunked' or 'grid_stride', got {schedule!r}"
        )
    if n_resident is not None:
        n_resident = int(n_resident)
        if n_resident < 1:
            raise ValueError(f"n_resident must be >= 1, got {n_resident}")
        if schedule == "chunked":
            raise ValueError(
                "n_resident= only applies to schedule='grid_stride' "
                "(the chunked schedule sizes waves with chunk=)"
            )
        schedule = "grid_stride"
    sched = "chunked" if schedule == "auto" else schedule
    sched_src = "heuristic" if schedule == "auto" else "explicit"
    n_res = n_resident
    total = grid3.total
    bname = _flat.choose_backend(ck.kernel, grid=total, mesh=mesh, requested=backend)
    n_warps = -(-block3.total // ck.warp_size)
    mode = _flat.choose_mode(ck.kernel, n_warps=n_warps, requested=mode)
    machines = ck.machine if not ck.phases else tuple(p.machine for p in ck.phases)
    warp_exec = _flat.choose_warp_exec(
        ck.kernel, n_warps=n_warps, requested=warp_exec, machine=machines
    )
    ch, ch_src = resolve_chunk(ck, total, chunk)
    if ck.n_phases > 1:
        if total > COOP_MAX_RESIDENT_BLOCKS:
            if schedule == "chunked":
                raise CoxUnsupported(
                    f"cooperative launch of '{ck.kernel.name}': grid={total} "
                    f"blocks exceeds the resident capacity "
                    f"({COOP_MAX_RESIDENT_BLOCKS}) and schedule='chunked' pins "
                    f"the all-resident wave -- drop schedule= to let the "
                    f"grid-stride lowering page blocks through "
                    f"{COOP_MAX_RESIDENT_BLOCKS} resident slots"
                )
            sched = "grid_stride"
            if sched_src != "explicit":
                sched_src = "cooperative"
            n_res = min(n_res or COOP_MAX_RESIDENT_BLOCKS, COOP_MAX_RESIDENT_BLOCKS)
            ch, ch_src = n_res, "cooperative"
        elif sched == "grid_stride":
            n_res = min(n_res or total, total, COOP_MAX_RESIDENT_BLOCKS)
            ch, ch_src = n_res, "cooperative"
    elif sched == "grid_stride" and n_res is not None:
        n_res = min(n_res, total)
    return ResolvedLaunch(
        grid3, block3, bname, mode, warp_exec, n_warps, ch, ch_src, sched, n_res, sched_src
    )


def resolve_schedule(
    ck: CompiledKernel,
    rl: ResolvedLaunch,
    shapes: Dict[str, tuple],
    *,
    budget: Optional[int] = None,
) -> ResolvedLaunch:
    """Apply the footprint verdict once the argument shapes are bound.
    An explicit schedule or chunk is kept (an explicit ``'grid_stride'``
    without ``n_resident=`` gets the cost model's wave width), and so is
    a cooperative lowering; otherwise ``costmodel.schedule_verdict``
    routes a chunked launch whose footprint exceeds the budget to
    grid-stride."""
    from . import costmodel as _costmodel

    if rl.schedule == "grid_stride":
        if rl.n_resident is None:
            n_res = _costmodel.resident_slots(
                ck,
                shapes,
                grid=rl.grid.total,
                n_warps=rl.n_warps,
                warp_exec=rl.warp_exec,
                budget=budget,
            )
            return dataclasses.replace(rl, n_resident=min(n_res, rl.grid.total))
        return rl
    if rl.schedule_source == "explicit" or rl.chunk_source == "explicit" or ck.n_phases > 1:
        return rl
    sched, n_res = _costmodel.schedule_verdict(
        ck,
        shapes,
        grid=rl.grid.total,
        chunk=rl.chunk if rl.chunk else DEFAULT_CHUNK,
        n_warps=rl.n_warps,
        warp_exec=rl.warp_exec,
        backend=rl.backend,
        budget=budget,
    )
    if sched == "grid_stride":
        return dataclasses.replace(
            rl, schedule="grid_stride", n_resident=n_res, schedule_source="heuristic"
        )
    return rl


def build_resolved(
    ck: CompiledKernel, rl: ResolvedLaunch, *, simd: bool = True, mesh=None, axis: str = "data"
):
    """Build the plan and the launcher for an already-resolved launch.
    Returns ``(plan, run)`` with ``run(globals_, scalars, device)``;
    ``mesh``/``axis`` reach the ``sharded`` backend."""
    plan = LaunchPlan.build(
        ck,
        grid=rl.grid,
        block=rl.block,
        mode=rl.mode,
        simd=simd,
        chunk=rl.chunk,
        warp_exec=rl.warp_exec,
        schedule=rl.schedule,
        n_resident=rl.n_resident,
    )
    return plan, _backends.get_backend(rl.backend).build_fn(plan, mesh=mesh, axis=axis)


def launch(
    ck: CompiledKernel,
    *,
    grid,
    block,
    args: Sequence[Any],
    mode: str = "auto",
    simd: bool = True,
    backend: str = "auto",
    chunk=None,
    warp_exec: str = "auto",
    schedule: str = "auto",
    n_resident: Optional[int] = None,
    device=None,
    mesh=None,
    axis: str = "data",
    donate: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run ``kernel<<<grid, block>>>(*args)`` on ``device`` (default
    CUDA); returns {array name: tensor} for every array parameter.

    Numpy arguments are copied to fresh tensors on the device; tensor
    arguments must already be there and are copied too, so the caller's
    inputs are never mutated.  ``donate=True`` consumes each 1-D
    contiguous tensor argument already on the device in the kernel's
    storage dtype once the launch holds its copy (its storage is
    released; a later launch that binds it raises), as the reference's
    donated buffers are deleted.

    ``mesh=`` (a ``DeviceMesh``; exclusive with ``device=``) shards the
    grid over its ``axis`` (backend ``'sharded'``): every rank calls
    with the same arguments and gets the merged globals on its own
    device."""
    dev = launch_device(device, mesh, axis, ck.kernel.name)
    rl = resolve_launch(
        ck,
        grid=grid,
        block=block,
        mode=mode,
        backend=backend,
        warp_exec=warp_exec,
        chunk=chunk,
        schedule=schedule,
        n_resident=n_resident,
        mesh=mesh,
    )
    held, shapes, held_s = hold_kernel_args(ck, args)
    rl = resolve_schedule(ck, rl, shapes)
    if donate:
        check_donate_supported(rl.backend, ck.kernel.name)
    _, run = build_resolved(ck, rl, simd=simd, mesh=mesh, axis=axis)
    globals_, scalars = materialize_args(ck, held, held_s, dev)
    if donate:
        consume_donated(ck, held, dev)
    return unbind_outputs(ck, run(globals_, scalars, dev), shapes)
