"""Public COX API of the torch port.

    from repro_torch.core import cox

    @cox.kernel
    def vec_add(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32),
                b: cox.Array(cox.f32), n: cox.i32):
        i = c.block_idx() * c.block_dim() + c.thread_idx()
        if i < n:
            out[i] = a[i] + b[i]

    out = vec_add.launch(grid=4, block=256, args=(out, a, b, n))["out"]

A launch runs on the CUDA device unless ``device=`` names the CPU, and
returns a dict of tensors.  Kernels are parsed from their source file
(``inspect.getsource``), so they must be defined in a file, not typed
into an interactive prompt or ``python -c``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

from . import flat as _flat
from . import kernel_ir as K
from . import runtime as _runtime
from .execute import CompiledKernel, compile_kernel
from .frontend import Array, parse_kernel  # noqa: F401  (cox.Array re-export)
from .types import CoxUnsupported, DType, Dim3, WARP_SIZE, as_dim3  # noqa: F401

# dtype shorthands (annotation + c.shared dtype arguments)
f32 = DType.f32
f16 = DType.f16
bf16 = DType.bf16
i32 = DType.i32
u32 = DType.u32
b1 = DType.b1


@dataclasses.dataclass
class KernelFn:
    """A parsed CUDA-style kernel plus the pass-pipeline cache
    (``compiled``), keyed by collapse choice and warp size."""

    ir: K.Kernel
    _cache: Dict[Any, CompiledKernel] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.ir.name

    def _compile_key(self, *, collapse: str, warp_size: int, block: Optional[int]):
        choice = _flat.choose_collapse(self.ir, collapse)
        if choice == "flat":
            if block is None:
                raise ValueError(
                    "flat collapsing specializes on block size; pass block="
                )
            return (choice, block)
        return (choice, warp_size)

    def _compiled_for(self, key: tuple) -> CompiledKernel:
        ck = self._cache.get(key)
        if ck is None:
            ck = self._cache[key] = compile_kernel(self.ir, warp_size=key[1])
        return ck

    def compiled(
        self, *, collapse: str = "hybrid", warp_size: int = WARP_SIZE, block=None
    ) -> CompiledKernel:
        """Run the pass pipeline.  collapse='flat' uses warp_size=block
        (one block-wide loop; requires ``block``); 'hier' is the paper's
        hierarchical collapsing; 'hybrid' picks automatically."""
        if block is not None:
            block = as_dim3(block, "block").total
        return self._compiled_for(
            self._compile_key(collapse=collapse, warp_size=warp_size, block=block)
        )

    def launch(
        self,
        *,
        grid,
        block,
        args: Sequence[Any],
        collapse: str = "hybrid",
        mode: str = "auto",
        simd: bool = True,
        warp_size: int = WARP_SIZE,
        mesh=None,
        backend: str = "auto",
        chunk=None,
        warp_exec: str = "auto",
        schedule: str = "auto",
        n_resident: Optional[int] = None,
        donate: bool = False,
        device=None,
        autotune: Optional[bool] = None,
        stream=None,
    ) -> Dict[str, Any]:
        """Launch ``kernel<<<grid, block>>>(*args)`` and return every
        array parameter's final value as a tensor.

        ``device`` is the torch device to run on: ``None`` means CUDA
        (and raises where there is none), ``"cpu"`` runs on the host.
        ``grid``/``block`` accept CUDA dim3 geometry (``int | (x, y[,
        z])``).  ``mode``, ``simd`` and ``collapse`` behave as in the
        reference.  The knobs of paths not ported yet --
        ``backend='vmap'|'sharded'``, ``warp_exec='batched'``, ``chunk``,
        ``schedule``, ``n_resident``, ``mesh``, ``donate``, ``autotune``,
        ``stream`` -- raise :class:`CoxUnsupported` naming the ROADMAP
        item that brings them."""
        if chunk is not None and chunk != "auto":
            raise _runtime.unported("chunk")
        if schedule != "auto":
            raise _runtime.unported("schedule")
        if n_resident is not None:
            raise _runtime.unported("n_resident")
        if autotune:
            raise _runtime.unported("autotune")
        if stream is not None:
            raise _runtime.unported("stream")
        block3 = as_dim3(block, "block")
        ck = self.compiled(collapse=collapse, warp_size=warp_size, block=block3)
        return _runtime.launch(
            ck,
            grid=grid,
            block=block3,
            args=args,
            mode=mode,
            simd=simd,
            backend=backend,
            warp_exec=warp_exec,
            device=device,
            mesh=mesh,
            donate=donate,
        )

    def uses_warp_features(self) -> bool:
        return K.uses_warp_features(self.ir)


def kernel(fn=None, *, name: Optional[str] = None):
    """Decorator: parse a restricted-Python CUDA-style kernel."""

    def wrap(f):
        return KernelFn(parse_kernel(f, name=name))

    if fn is None:
        return wrap
    return wrap(fn)
