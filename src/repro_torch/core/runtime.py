"""COX runtime: grid launch (the paper section 4 host side).

The paper forks one pthread per CUDA block.  Here the grid runs as the
``scan`` backend's serial loop over block ids on one torch device.  The
reference's ``auto`` heuristics (``flat.choose_backend`` /
``choose_warp_exec``) still run, so a launch records what the reference
would have picked; the port clamps it to the paths it has and says so
in :attr:`ResolvedLaunch.clamped`.

Knobs the port does not run yet raise :class:`CoxUnsupported` naming the
ROADMAP queue item that brings them (:data:`UNPORTED`); none is
silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from . import backends as _backends
from . import flat as _flat
from .backends.plan import LaunchPlan, bind_kernel_args, unbind_outputs
from .execute import CompiledKernel
from .types import CoxUnsupported, Dim3, as_dim3, check_launch_geometry

# knob -> the ROADMAP queue item that ports it
UNPORTED = {
    "backend='vmap'": "A.5 (block-parallel grid execution)",
    "warp_exec='batched'": "A.5 (block-parallel grid execution)",
    "chunk": "A.5 (block-parallel grid execution)",
    "schedule": "A.5 (block-parallel grid execution)",
    "n_resident": "A.5 (block-parallel grid execution)",
    "backend='sharded'": "A.10 (multi-device)",
    "mesh": "A.10 (multi-device)",
    "donate": "A.9 (runtime services)",
    "autotune": "A.9 (runtime services: autotune.py)",
    "stream": "A.9 (runtime services: streams.py)",
    "device pin": "A.9 (runtime services: placement.py)",
}


def unported(knob: str) -> CoxUnsupported:
    return CoxUnsupported(
        f"{knob} is not ported to repro_torch yet: ROADMAP queue item "
        f"{UNPORTED[knob]}"
    )


def resolve_device(device) -> torch.device:
    """The launch's torch device.  ``None`` means CUDA: a launch runs on
    the card unless the caller asks for the CPU, and raises when there
    is no card rather than carrying on on the host.  Only a ``str`` or a
    ``torch.device`` names a device; anything else is a placement pin."""
    if device is None:
        device = "cuda"
    if not isinstance(device, (str, torch.device)):
        raise unported("device pin")
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
class ResolvedLaunch:
    """Launch knobs after dim3 normalization and 'auto' resolution.

    ``clamped`` lists each 'auto' choice the reference heuristic made
    that the port replaced with its serial path, e.g.
    ``("backend: vmap -> scan",)``."""

    grid: Dim3
    block: Dim3
    backend: str  # 'scan'
    mode: str  # 'normal' | 'jit'
    warp_exec: str  # 'serial'
    n_warps: int
    clamped: Tuple[str, ...] = ()


def resolve_launch(
    ck: CompiledKernel,
    *,
    grid,
    block,
    mode: str = "auto",
    backend: str = "auto",
    warp_exec: str = "auto",
) -> ResolvedLaunch:
    """Normalize ``grid``/``block`` to dim3, enforce CUDA's launch
    limits and resolve the 'auto' knobs.  ``backend='auto'`` resolves to
    ``scan`` and ``warp_exec='auto'`` to ``serial``; an explicit request
    for a path the port lacks raises."""
    grid3 = as_dim3(grid, "grid")
    block3 = as_dim3(block, "block")
    check_launch_geometry(grid3, block3)
    clamped = []
    if backend in ("vmap", "sharded"):
        raise unported(f"backend={backend!r}")
    want = _flat.choose_backend(ck.kernel, grid=grid3.total, requested=backend)
    if want != "scan":
        clamped.append(f"backend: {want} -> scan")
    n_warps = -(-block3.total // ck.warp_size)
    mode = _flat.choose_mode(ck.kernel, n_warps=n_warps, requested=mode)
    if warp_exec == "batched":
        raise unported("warp_exec='batched'")
    machines = ck.machine if not ck.phases else tuple(p.machine for p in ck.phases)
    want = _flat.choose_warp_exec(
        ck.kernel, n_warps=n_warps, requested=warp_exec, machine=machines
    )
    if want != "serial":
        clamped.append(f"warp_exec: {want} -> serial")
    return ResolvedLaunch(
        grid3, block3, "scan", mode, "serial", n_warps, tuple(clamped)
    )


def build_resolved(ck: CompiledKernel, rl: ResolvedLaunch, *, simd: bool = True):
    """Build the plan and the launcher for an already-resolved launch.
    Returns ``(plan, run)`` with ``run(globals_, scalars, device)``."""
    plan = LaunchPlan.build(
        ck,
        grid=rl.grid,
        block=rl.block,
        mode=rl.mode,
        simd=simd,
        warp_exec=rl.warp_exec,
    )
    return plan, _backends.get_backend(rl.backend).build_fn(plan)


def launch(
    ck: CompiledKernel,
    *,
    grid,
    block,
    args: Sequence[Any],
    mode: str = "auto",
    simd: bool = True,
    backend: str = "auto",
    warp_exec: str = "auto",
    device=None,
    mesh=None,
    donate: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run ``kernel<<<grid, block>>>(*args)`` on ``device`` (default
    CUDA); returns {array name: tensor} for every array parameter.

    Numpy arguments are copied to fresh tensors on the device; tensor
    arguments must already be there and are copied too, so the caller's
    inputs are never mutated."""
    if mesh is not None:
        raise unported("mesh")
    if donate:
        raise unported("donate")
    dev = resolve_device(device)
    rl = resolve_launch(
        ck,
        grid=grid,
        block=block,
        mode=mode,
        backend=backend,
        warp_exec=warp_exec,
    )
    globals_, shapes, scalars = bind_kernel_args(ck, args, dev)
    _, run = build_resolved(ck, rl, simd=simd)
    return unbind_outputs(ck, run(globals_, scalars, dev), shapes)
