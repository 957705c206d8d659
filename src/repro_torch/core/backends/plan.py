"""LaunchPlan -- everything the grid backend needs, precomputed.

A plan captures the launch geometry (grid, block, warps), the execution
flavor (mode, simd), and the arg-binding convention (arrays flattened to
CUDA-pointer 1-D views, scalars split off as block-uniform parameters).
This is the serial subset of the reference's plan: the chunk tables of
the block-parallel backends are queue item A.5.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..execute import CompiledKernel, _cast, make_block_fn, with_sink
from ..types import (
    U32_MASK,
    ArraySpec,
    CoxUnsupported,
    Dim3,
    DType,
    as_dim3,
    check_launch_geometry,
)

def _to_tensor(val, dtype: DType, device: torch.device, name: str) -> torch.Tensor:
    """One argument as a tensor of ``dtype``'s compute type on ``device``.
    Numpy data is copied to the device; a tensor must already be there."""
    if isinstance(val, torch.Tensor):
        if val.device != device:
            raise ValueError(
                f"argument '{name}' is on {val.device} but the launch runs on "
                f"{device}: move it with .to({str(device)!r}) or pass numpy"
            )
        t = val.detach()
        if t.dtype == torch.uint32:  # torch has few uint32 kernels: reinterpret
            t = t.view(torch.int32).to(torch.int64) & U32_MASK
    else:
        a = np.asarray(val)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return _cast(t, dtype.compute)


def bind_kernel_args(
    ck: CompiledKernel, args: Sequence[Any], device
) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple], Dict[str, torch.Tensor]]:
    """Split positional args into (globals dict, shapes, scalar uniforms).

    Arrays become fresh flat tensors on ``device`` (CUDA pointer
    semantics) with one sink slot appended, so the launch updates its own
    copies and never the caller's.  Scalars become 0-d tensors."""
    device = torch.device(device)
    if len(args) != len(ck.kernel.params):
        raise TypeError(
            f"kernel {ck.kernel.name} takes {len(ck.kernel.params)} args, "
            f"got {len(args)}"
        )
    globals_: Dict[str, torch.Tensor] = {}
    shapes: Dict[str, tuple] = {}
    scalars: Dict[str, torch.Tensor] = {}
    for spec, val in zip(ck.kernel.params, args):
        t = _to_tensor(val, spec.dtype, device, spec.name)
        if isinstance(spec, ArraySpec):
            shapes[spec.name] = tuple(t.shape)
            globals_[spec.name] = with_sink(t.reshape(-1))
        else:
            scalars[spec.name] = t.reshape(())
    return globals_, shapes, scalars


def unbind_outputs(
    ck: CompiledKernel, globals_: Dict[str, torch.Tensor], shapes: Dict[str, tuple]
) -> Dict[str, torch.Tensor]:
    """Strip the sink slots and restore shapes; u32 arrays go back to
    ``torch.uint32`` by reinterpreting their low 32 bits."""
    out = {}
    for spec in ck.array_params:
        t = globals_[spec.name][:-1].reshape(shapes[spec.name])
        if spec.dtype is DType.u32:
            t = t.to(torch.int32).view(torch.uint32)
        out[spec.name] = t
    return out


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Immutable description of one ``kernel<<<grid, block>>>`` launch.

    ``grid``/``block`` are the *linear totals*; ``grid_dim``/``block_dim``
    carry the canonical dim3 geometry for the per-axis intrinsics only.
    """

    ck: CompiledKernel
    grid: int  # total blocks (grid_dim.total)
    block: int  # total threads per block (block_dim.total)
    n_warps: int
    mode: str  # 'normal' | 'jit' (resolved, never 'auto')
    simd: bool
    warp_exec: str = "serial"
    grid_dim: Optional[Dim3] = None
    block_dim: Optional[Dim3] = None
    n_phases: int = 1  # >1 -> cooperative (grid_sync) launch

    @classmethod
    def build(
        cls,
        ck: CompiledKernel,
        *,
        grid,
        block,
        mode: str = "normal",
        simd: bool = True,
        warp_exec: str = "serial",
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
        if warp_exec != "serial":
            raise CoxUnsupported(
                f"warp_exec={warp_exec!r}: only the serial inter-warp loop is "
                f"ported (the batched warp plane is ROADMAP queue item A.5)"
            )
        n_warps = -(-block // ck.warp_size)
        return cls(
            ck,
            grid,
            block,
            n_warps,
            mode,
            simd,
            warp_exec=warp_exec,
            grid_dim=grid3,
            block_dim=block3,
            n_phases=ck.n_phases,
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

    def block_fns(self):
        """One block function per phase (a single-entry list for
        ordinary kernels), all built with identical launch knobs."""
        persist = self.persist_spec()
        return [
            make_block_fn(
                sub,
                n_warps=self.n_warps,
                mode=self.mode,
                simd=self.simd,
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
        """The block-uniform environment for one block: 0-d int32
        tensors on the launch's device."""
        dev = bid.device
        u = {
            "bid": bid,
            "bdim": torch.tensor(self.block, dtype=torch.int32, device=dev),
            "gdim": torch.tensor(self.grid, dtype=torch.int32, device=dev),
        }
        u.update(scalars)
        return u
