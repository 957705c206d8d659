"""LaunchPlan -- everything a grid-execution backend needs, precomputed.

A plan captures the launch geometry (grid, block, warps), the execution
flavor (mode, simd, warp_exec), the schedule of block ids into waves
(the chunk table, or the grid-stride wave width), and the arg-binding
convention (arrays flattened to CUDA-pointer 1-D views, scalars split
off as block-uniform parameters).  Backends are functions of a plan;
none of them re-derives this state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernel_ir as K
from ..execute import CompiledKernel, _cast, make_block_fn, walk_instrs, with_sink
from ..types import (
    COOP_MAX_RESIDENT_BLOCKS,
    U32_MASK,
    ArraySpec,
    CoxUnsupported,
    Dim3,
    DType,
    GraphRef,
    as_dim3,
    check_launch_geometry,
)

DEFAULT_CHUNK = 8  # blocks run at once per wave of the vmap backend

# the attribute that marks a tensor a donate=True launch consumed
CONSUMED = "_cox_donated"


def check_donate_supported(backend: str, kernel_name: str) -> None:
    """Donation hands the launch each global's single device buffer; the
    sharded backend has none to take (globals enter it
    replicated and leave through a cross-device merge).  One shared check
    for the request and for the backend, as in the reference."""
    if backend == "sharded":
        raise CoxUnsupported(
            f"kernel '{kernel_name}': donate=True is unsupported on the "
            f"sharded backend -- replicated cross-device globals have no "
            f"single buffer to reuse; drop donate= or launch without a mesh"
        )


def is_consumed(val) -> bool:
    """True for a tensor a ``donate=True`` launch consumed."""
    return getattr(val, CONSUMED, False)


def _check_not_consumed(val, name: str) -> None:
    if isinstance(val, torch.Tensor) and is_consumed(val):
        raise CoxUnsupported(
            f"argument '{name}' was donated to an earlier donate=True launch, "
            f"which consumed its storage -- keep a copy (or the launch's "
            f"outputs) before donating it"
        )


def donatable(val, dtype: DType, device) -> bool:
    """Whether a held global is the buffer the reference's flat binding
    would alias: a 1-D contiguous tensor already on the launch's device
    in the kernel's storage dtype.  Numpy data, and a tensor that needed
    a copy or a cast, is never consumed."""
    return (
        isinstance(val, torch.Tensor)
        and val.dim() == 1
        and val.is_contiguous()
        and not val.requires_grad
        and val.device == torch.device(device)
        and val.dtype == dtype.compute
        and not is_consumed(val)
    )


def consume_donated(ck: CompiledKernel, globals_: Dict[str, Any], device) -> int:
    """Release the storage of every donatable held global, once the
    launch holds its own copies (``materialize_args``): the tensor is
    reset to an empty storage (``set_()``; freeing the storage under a
    live tensor with ``untyped_storage().resize_(0)`` leaves it reading
    freed memory) and marked consumed, so a later launch that binds it
    raises.  On the card a tensor made on another stream must
    have been ``record_stream``-ed on the launch's stream first, so the
    caching allocator does not hand its block out while the launch's
    copy still reads it.  Returns the bytes released."""
    freed = 0
    for spec in ck.array_params:
        t = globals_.get(spec.name)
        if not donatable(t, spec.dtype, device):
            continue
        freed += t.numel() * t.element_size()
        t.set_()
        setattr(t, CONSUMED, True)
    return freed


def _to_tensor(val, dtype: DType, device: torch.device, name: str) -> torch.Tensor:
    """One argument as a tensor of ``dtype``'s compute type on ``device``.
    Numpy data is copied to the device; a tensor must already be there."""
    if isinstance(val, torch.Tensor):
        _check_not_consumed(val, name)
        check_arg_device(val, device, name)
        t = val.detach()
        if t.dtype == torch.uint32:  # torch has few uint32 kernels: reinterpret
            t = t.view(torch.int32).to(torch.int64) & U32_MASK
    else:
        a = np.asarray(val)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        t = _host_to_device(torch.from_numpy(np.ascontiguousarray(a)), torch.device(device))
    return _cast(t, dtype.compute)


def _host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host data onto ``device`` without blocking the host: on a card a
    scalar becomes a fill kernel and an array goes through pinned memory
    with a non-blocking copy (torch's pinned-memory cache keeps the
    buffer until the copy is done).  A plain ``.to(cuda)`` from pageable
    memory synchronises the issuing stream, which would make every
    launch wait for its stream to drain, and which a CUDA graph capture
    refuses."""
    if device.type != "cuda":
        return t.to(device)
    if t.dim() == 0:
        return torch.full((), t.item(), dtype=t.dtype, device=device)
    return t.pin_memory().to(device, non_blocking=True)


def check_arg_device(val, device, name: str) -> None:
    """A tensor argument must already sit on the launch's device."""
    if isinstance(val, torch.Tensor) and val.device != torch.device(device):
        raise ValueError(
            f"argument '{name}' is on {val.device} but the launch runs on "
            f"{device}: move it with .to({str(device)!r}) or pass numpy"
        )


def hold_kernel_args(
    ck: CompiledKernel, args: Sequence[Any]
) -> Tuple[Dict[str, Any], Dict[str, tuple], Dict[str, Any]]:
    """Split positional args into (globals dict, shapes, scalars) without
    putting anything on a device: what a ``LaunchRequest`` holds between
    its ``make_request`` and its dispatch.

    Tensors are held as flat views (no copy), everything else as a flat
    numpy copy, so a caller mutating its numpy array after the call does
    not change the launch.  A :class:`~types.GraphRef` (a captured
    launch's output placeholder) binds symbolically: its shape is
    recorded and the value passes through for the graph to resolve.
    :func:`materialize_args` makes a launch's own device copies from
    what is held -- afresh for every attempt, so a retry or a fallback
    rung never sees an earlier attempt's in-place writes."""
    if len(args) != len(ck.kernel.params):
        raise TypeError(
            f"kernel {ck.kernel.name} takes {len(ck.kernel.params)} args, "
            f"got {len(args)}"
        )
    globals_: Dict[str, Any] = {}
    shapes: Dict[str, tuple] = {}
    scalars: Dict[str, Any] = {}
    for spec, val in zip(ck.kernel.params, args):
        if isinstance(spec, ArraySpec):
            if isinstance(val, GraphRef):
                shapes[spec.name] = tuple(val.shape)
                globals_[spec.name] = val
                continue
            if isinstance(val, torch.Tensor):
                _check_not_consumed(val, spec.name)
                shapes[spec.name] = tuple(val.shape)
                # a flat tensor is held as the very object passed: the
                # dispatcher knows a launch's outputs by identity (the
                # data edges of handle.outputs chaining)
                flat = val.dim() == 1 and not val.requires_grad
                globals_[spec.name] = val if flat else val.detach().reshape(-1)
                continue
            held = np.array(val)
            shapes[spec.name] = tuple(held.shape)
            globals_[spec.name] = held.reshape(-1)
        else:
            if isinstance(val, GraphRef):
                raise CoxUnsupported(
                    f"kernel {ck.kernel.name}: scalar parameter '{spec.name}' "
                    f"bound to a captured array output ({val!r}) -- graph data "
                    f"edges carry global-memory arrays, not by-value uniforms"
                )
            scalars[spec.name] = val.detach() if isinstance(val, torch.Tensor) else np.array(val)
    return globals_, shapes, scalars


def materialize_args(
    ck: CompiledKernel, globals_: Dict[str, Any], scalars: Dict[str, Any], device
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Fresh flat tensors on ``device`` with one sink slot appended (CUDA
    pointer semantics: the launch updates its own copies, never the
    held values), and the scalars as 0-d tensors."""
    device = torch.device(device)
    g: Dict[str, torch.Tensor] = {}
    s: Dict[str, torch.Tensor] = {}
    for spec in ck.kernel.params:
        if isinstance(spec, ArraySpec):
            t = _to_tensor(globals_[spec.name], spec.dtype, device, spec.name)
            g[spec.name] = with_sink(t.reshape(-1))
        else:
            s[spec.name] = _to_tensor(scalars[spec.name], spec.dtype, device, spec.name).reshape(())
    return g, s


def flat_outputs(ck: CompiledKernel, globals_: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every array parameter's final value, flat: the sink slot stripped
    and u32 arrays back as ``torch.uint32`` (their low 32 bits)."""
    out = {}
    for spec in ck.array_params:
        # detached: not an autograd view of the sink-extended buffer, so
        # a donate=True launch that consumes the output frees the buffer
        t = globals_[spec.name][:-1].detach()
        if spec.dtype is DType.u32:
            t = t.to(torch.int32).view(torch.uint32)
        out[spec.name] = t
    return out


def unbind_outputs(
    ck: CompiledKernel, globals_: Dict[str, torch.Tensor], shapes: Dict[str, tuple]
) -> Dict[str, torch.Tensor]:
    """Strip the sink slots and restore shapes; u32 arrays go back to
    ``torch.uint32`` by reinterpreting their low 32 bits."""
    return {k: v.reshape(shapes[k]) for k, v in flat_outputs(ck, globals_).items()}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Immutable description of one ``kernel<<<grid, block>>>`` launch.

    ``grid``/``block`` are the *linear totals* -- the chunk tables, warp
    counts and merges key on them, so ``grid=4`` and ``grid=(4, 1, 1)``
    build identical plans; ``grid_dim``/``block_dim`` carry the canonical
    dim3 geometry for the per-axis intrinsics only.
    """

    ck: CompiledKernel
    grid: int  # total blocks (grid_dim.total)
    block: int  # total threads per block (block_dim.total)
    n_warps: int
    mode: str  # 'normal' | 'jit' (resolved, never 'auto')
    simd: bool
    chunk: int  # blocks per vmap wave (1 = one block at a time)
    has_atomics: bool
    captures_atomic_old: bool  # AtomicRMW with dst -- serial only
    warp_exec: str = "serial"  # 'serial' | 'batched' (resolved)
    grid_dim: Optional[Dim3] = None
    block_dim: Optional[Dim3] = None
    n_phases: int = 1  # >1 -> cooperative (grid_sync) launch
    schedule: str = "chunked"  # 'chunked' | 'grid_stride'
    n_resident: Optional[int] = None  # grid-stride wave width (else None)

    @classmethod
    def build(
        cls,
        ck: CompiledKernel,
        *,
        grid,
        block,
        mode: str = "normal",
        simd: bool = True,
        chunk: Optional[int] = None,
        warp_exec: str = "serial",
        schedule: str = "chunked",
        n_resident: Optional[int] = None,
    ) -> "LaunchPlan":
        grid3 = as_dim3(grid, "grid")
        block3 = as_dim3(block, "block")
        check_launch_geometry(grid3, block3)
        grid, block = grid3.total, block3.total
        if mode not in ("normal", "jit"):
            raise ValueError(
                f"mode must be resolved to 'normal' or 'jit' before plan build, "
                f"got {mode!r} (flat.choose_mode resolves 'auto')"
            )
        if warp_exec not in ("serial", "batched"):
            raise ValueError(
                f"warp_exec must be resolved to 'serial' or 'batched' before "
                f"plan build, got {warp_exec!r} (flat.choose_warp_exec "
                f"resolves 'auto')"
            )
        if schedule not in ("chunked", "grid_stride"):
            raise ValueError(
                f"schedule must be resolved to 'chunked' or 'grid_stride' "
                f"before plan build, got {schedule!r} "
                f"(runtime.resolve_schedule resolves 'auto')"
            )
        n_warps = -(-block // ck.warp_size)
        n_phases = ck.n_phases
        name = ck.kernel.name
        if schedule == "grid_stride":
            # the wave width doubles as the merge chunk: wave i covers
            # the block ids [i*R, (i+1)*R), row i of the chunk table a
            # chunked plan with chunk=R walks -- so the two schedules are
            # bitwise equal by construction
            n_resident = (
                min(grid, DEFAULT_CHUNK)
                if n_resident is None
                else max(1, min(int(n_resident), grid))
            )
            if n_phases > 1 and n_resident > COOP_MAX_RESIDENT_BLOCKS:
                raise CoxUnsupported(
                    f"cooperative launch of '{name}': n_resident={n_resident} "
                    f"exceeds the resident capacity ({COOP_MAX_RESIDENT_BLOCKS}) "
                    f"-- the grid-stride wave is the resident set, as "
                    f"cudaLaunchCooperativeKernel's occupancy rule"
                )
            chunk = n_resident
        elif n_phases > 1:
            # CUDA's cooperative-launch rule: every block resident per
            # phase, so the chunked schedule may not split the grid
            if grid > COOP_MAX_RESIDENT_BLOCKS:
                raise CoxUnsupported(
                    f"cooperative launch of '{name}': grid={grid} blocks exceeds "
                    f"the resident capacity ({COOP_MAX_RESIDENT_BLOCKS}) -- every "
                    f"block must be resident per phase for a grid barrier, as "
                    f"cudaLaunchCooperativeKernel's occupancy rule "
                    f"(schedule='grid_stride' pages blocks through a "
                    f"capacity-sized resident wave instead)"
                )
            if chunk is not None and int(chunk) < grid:
                raise CoxUnsupported(
                    f"cooperative launch of '{name}': chunk={chunk} would split "
                    f"the grid into waves, but a grid barrier needs every block "
                    f"resident per phase -- drop chunk= (the plan schedules all "
                    f"{grid} blocks as one wave)"
                )
            chunk = grid
        else:
            n_resident = None  # chunked plans carry no wave width
        if chunk is None:
            chunk = min(grid, DEFAULT_CHUNK)
        chunk = max(1, min(int(chunk), grid))
        atomics = [s for s in walk_instrs(ck) if isinstance(s, K.AtomicRMW)]
        plan = cls(
            ck,
            grid,
            block,
            n_warps,
            mode,
            simd,
            chunk,
            has_atomics=bool(atomics),
            captures_atomic_old=any(s.dst for s in atomics),
            warp_exec=warp_exec,
            grid_dim=grid3,
            block_dim=block3,
            n_phases=n_phases,
            schedule=schedule,
            n_resident=n_resident,
        )
        plan.check_warp_batchable()
        return plan

    def check_warp_batchable(self):
        """Refuse what the batched plane's per-warp delta merge cannot
        reproduce: captured atomic old values are unique only under a
        serial warp order (per-warp delta buffers would hand every warp
        of a block the same ticket)."""
        if self.warp_exec == "batched" and self.captures_atomic_old:
            raise CoxUnsupported(
                f"kernel '{self.ck.kernel.name}' captures atomic old values "
                f"(atomic_add_old): old values are only unique under a serial "
                f"warp order, which warp-batched execution's per-warp delta "
                f"merge cannot reproduce -- use warp_exec='serial' (the 'auto' "
                f"heuristic picks it)"
            )

    def check_mergeable(self, backend: str):
        """Refuse what the block-parallel delta merge cannot reproduce:
        captured atomic old values (the ticket pattern) are unique only
        under serial execution, so such kernels run on ``scan`` alone."""
        if self.captures_atomic_old:
            raise CoxUnsupported(
                f"kernel '{self.ck.kernel.name}' captures atomic old values "
                f"(atomic_add_old): old values are only unique under serial "
                f"execution, which the {backend!r} backend's delta merge cannot "
                f"reproduce -- use backend='scan' (the 'auto' heuristic picks it)"
            )

    # ---------------- phase staging (cooperative grid sync) ----------------

    def persist_spec(self) -> Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
        """``(carried local names, shared-memory names)`` a phase must
        thread through -- or ``None`` for single-phase launches."""
        if self.n_phases == 1:
            return None
        return (
            tuple(self.ck.carried),
            tuple(s.name for s in self.ck.kernel.shared),
        )

    def block_fns(self, *, track_writes: bool = False):
        """One block function per phase (a single-entry list for
        ordinary kernels), all built with identical launch knobs."""
        persist = self.persist_spec()
        return [
            make_block_fn(
                sub,
                n_warps=self.n_warps,
                mode=self.mode,
                simd=self.simd,
                track_writes=track_writes,
                warp_exec=self.warp_exec,
                block_dim=self.block_dim,
                grid_dim=self.grid_dim,
                persist=persist,
            )
            for sub in self.ck.phase_list()
        ]

    def init_persist(self, device, n_blocks: Optional[int] = None):
        """Phase-0 per-block state stacked over ``n_blocks`` (default:
        the whole grid): zeroed ``(n_blocks, n_warps, W)`` planes for
        carried locals and zeroed flat shared buffers."""
        nb = self.grid if n_blocks is None else int(n_blocks)
        W = self.ck.warp_size
        bv = {
            v: torch.zeros(
                (nb, self.n_warps, W),
                dtype=self.ck.var_types.get(v, DType.f32).compute,
                device=device,
            )
            for v in self.ck.carried
        }
        sh = {
            s.name: torch.zeros(
                (nb, int(np.prod(s.shape))), dtype=s.dtype.compute, device=device
            )
            for s in self.ck.kernel.shared
        }
        return {"bv": bv, "sh": sh}

    def uniforms(self, bid: torch.Tensor, scalars: Dict[str, Any]) -> Dict[str, Any]:
        """The block-uniform environment: ``bid`` (0-d for one block, or
        ``(C,)`` for a wave of blocks), bdim, gdim and the scalars, as
        int32 tensors on the launch's device."""
        dev = bid.device
        # torch.full, not torch.tensor: a fill kernel, where torch.tensor
        # would copy from pageable host memory -- illegal while a CUDA
        # graph captures the launch (graphs.py)
        u = {
            "bid": bid,
            "bdim": torch.full((), self.block, dtype=torch.int32, device=dev),
            "gdim": torch.full((), self.grid, dtype=torch.int32, device=dev),
        }
        u.update(scalars)
        return u

    # ---------------- waves ----------------

    def n_stride_waves(self, total: Optional[int] = None) -> int:
        """How many resident waves a grid-stride launch runs:
        ``ceil(total / n_resident)`` (default: the whole grid; the
        sharded backend passes its per-device block count)."""
        n = self.grid if total is None else int(total)
        return max(1, -(-n // self.n_resident))

    def stride_bids(self, wave: int, *, base: int = 0, limit: Optional[int] = None) -> np.ndarray:
        """Block ids of one grid-stride wave: ``base + wave*R`` on, ``R =
        n_resident`` of them, those at or past ``limit`` (default: the
        grid) as -1 -- row ``wave`` of the table the chunked schedule
        walks, made as it is needed.  ``base``/``limit`` scope the waves
        to one device's slice of the grid (the sharded backend)."""
        limit = self.grid if limit is None else int(limit)
        bids = base + wave * self.n_resident + np.arange(self.n_resident, dtype=np.int32)
        return np.where(bids < limit, bids, -1).astype(np.int32)

    def chunked_bids(self) -> np.ndarray:
        """The whole grid's block ids as a ``(n_chunks, chunk)`` table,
        -1-padded."""
        n = self.grid
        n_chunks = -(-n // self.chunk)
        bids = np.full((n_chunks * self.chunk,), -1, np.int32)
        bids[:n] = np.arange(n, dtype=np.int32)
        return bids.reshape(n_chunks, self.chunk)

    def device_bid_table(self, ndev: int) -> np.ndarray:
        """Round-robin-contiguous block ids per device, shaped ``(ndev,
        per_padded)`` with ``per_padded`` a multiple of ``chunk`` and -1
        marking idle pad slots: device *d* owns the ids ``[d*per,
        (d+1)*per)``, ``per = ceil(grid / ndev)``."""
        per = -(-self.grid // ndev)
        per_padded = -(-per // self.chunk) * self.chunk
        table = np.full((ndev, per_padded), -1, np.int32)
        flat = np.arange(self.grid, dtype=np.int32)
        for d in range(ndev):
            mine = flat[d * per : (d + 1) * per]
            table[d, : len(mine)] = mine
        return table
