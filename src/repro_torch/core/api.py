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
returns a dict of tensors.  Every launch goes through the stream
dispatcher (``streams.py``): ``launch`` enqueues on the default stream;
``cox.Stream``, ``cox.Event`` and ``cox.Graph`` are CUDA's streams,
events and graphs (``torch.cuda.Stream``/``Event``/``CUDAGraph`` on the
card).  Kernels are parsed from their source file
(``inspect.getsource``), so they must be defined in a file, not typed
into an interactive prompt or ``python -c``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

from . import autotune as _autotune
from . import costmodel  # noqa: F401  (cox.costmodel: op/mem estimates)
from . import errors  # noqa: F401  (cox.errors: typed error hierarchy)
from . import faults  # noqa: F401  (cox.faults: fault injection)
from . import flat as _flat
from . import kernel_ir as K
from . import placement  # noqa: F401  (cox.placement: device policies)
from . import runtime as _runtime
from . import streams as _streams
from .backends.plan import check_donate_supported, hold_kernel_args
from .errors import (  # noqa: F401
    CoxCompileError,
    CoxDependencyError,
    CoxDeviceError,
    CoxError,
    CoxLaunchError,
    CoxTimeoutError,
)
from .execute import CompiledKernel, compile_kernel
from .frontend import Array, parse_kernel  # noqa: F401  (cox.Array re-export)
from .graphs import Graph, GraphExec, GraphNodeHandle  # noqa: F401
from .placement import (  # noqa: F401
    AffinityPlacement,
    HealthAwarePlacement,
    PlacementPolicy,
    RoundRobinPlacement,
)
from .streams import (  # noqa: F401
    Event,
    LaunchHandle,
    Stream,
    default_stream,
    device_reset,
    get_dispatcher,
    get_last_error,
    peek_at_last_error,
    synchronize,
)
from .types import CoxUnsupported, DType, Dim3, GraphRef, WARP_SIZE, as_dim3  # noqa: F401

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
    (``compiled``), keyed by collapse choice and warp size.  The
    launch-level cache of staged plans lives behind the stream
    dispatcher (``streams.py``) and is shared by every stream;
    ``_launch_cache`` is a read view of this kernel's entries."""

    ir: K.Kernel
    _cache: Dict[Any, CompiledKernel] = dataclasses.field(default_factory=dict)

    @property
    def _launch_cache(self) -> Dict[Any, Any]:
        """This kernel's staged ``(plan, run)`` entries in the
        dispatcher's shared cache (compile token first, phase count
        second)."""
        return get_dispatcher().cache_view(self._cache.values())

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

    def make_request(
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
        axis: str = "data",
        backend: str = "auto",
        chunk=None,
        warp_exec: str = "auto",
        schedule: str = "auto",
        n_resident: Optional[int] = None,
        donate: bool = False,
        device=None,
        autotune: Optional[bool] = None,
        stream: Optional[Stream] = None,
    ) -> _streams.LaunchRequest:
        """Resolve the launch knobs and hold the arguments in a
        :class:`~streams.LaunchRequest`, the unit the dispatcher
        consumes.  Compilation and knob resolution happen here, so a bad
        launch fails at its call; the arguments reach the device at
        dispatch, on the launch's stream.

        ``chunk=`` takes an int (explicit, never overridden by the
        autotuner), ``None`` (the heuristic default) or ``'auto'`` (tune
        the chunk by measurement).  ``autotune=True`` measures every knob
        left on auto (``autotune.py``: candidate cells pruned by the
        cost model, winners kept in the on-disk cache), and
        ``autotune=None`` defers to ``COX_AUTOTUNE`` (and to
        ``chunk='auto'``, which always tunes).  Tuning measures on the
        launch's device, or on ``stream``'s (the stream the request will
        be enqueued on, which ``Stream.launch`` passes); a launch issued
        while ``stream`` captures a graph is not tuned.

        ``donate=True`` hands the launch the caller's flat device buffers:
        each 1-D contiguous tensor argument already on the launch's
        device in the kernel's storage dtype is consumed once the launch
        holds its own copy (its storage is released, and a later launch
        that binds it raises).  ``device=`` pins the launch to a torch
        device (``'cpu'``, or a card); left ``None`` the launch runs on
        its stream's device, by default the current CUDA device.

        ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, mutually
        exclusive with ``device=``) shards the grid over the mesh axis
        ``axis`` on the ``sharded`` backend: every rank of the mesh makes
        the same launch and gets the merged globals on its own device.
        A sharded launch is never tuned, donated or placed."""
        if mesh is not None:
            _runtime.launch_device(device, mesh, axis, self.name)
        dev = None if device is None else _runtime.resolve_entry(device)
        block3 = as_dim3(block, "block")
        token = self._compile_key(collapse=collapse, warp_size=warp_size, block=block3.total)
        ck = self._compiled_for(token)
        rl = _runtime.resolve_launch(
            ck,
            grid=grid,
            block=block3,
            mode=mode,
            backend=backend,
            warp_exec=warp_exec,
            chunk=chunk,
            schedule=schedule,
            n_resident=n_resident,
            mesh=mesh,
        )
        globals_, shapes, scalars = hold_kernel_args(ck, args)
        rl = _runtime.resolve_schedule(ck, rl, shapes)
        tune = autotune if autotune is not None else (chunk == "auto" or _autotune.enabled())
        if tune:
            tune_dev = _runtime.physical(dev)
            if tune_dev is None and stream is not None:
                tune_dev = stream.dispatcher._stream_device(stream)
            rl = _autotune.tune(
                ck,
                token,
                rl,
                shapes=shapes,
                scalars=scalars,
                globals_=globals_,
                simd=simd,
                mesh=mesh,
                req_backend=backend,
                req_warp_exec=warp_exec,
                device=tune_dev,
                capturing=stream is not None and stream.capturing,
            )
        if donate:
            # fail at the call, not at dispatch
            check_donate_supported(rl.backend, ck.kernel.name)
        return _streams.LaunchRequest(
            ck=ck,
            token=token,
            rl=rl,
            simd=simd,
            chunk=rl.chunk,
            mesh=mesh,
            axis=axis,
            donate=donate,
            globals_=globals_,
            shapes=shapes,
            scalars=scalars,
            device=dev,
            req_backend=backend,
            req_warp_exec=warp_exec,
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
        axis: str = "data",
        backend: str = "auto",
        chunk=None,
        warp_exec: str = "auto",
        schedule: str = "auto",
        n_resident: Optional[int] = None,
        donate: bool = False,
        device=None,
        autotune: Optional[bool] = None,
        stream: Optional[Stream] = None,
    ) -> Dict[str, Any]:
        """Launch ``kernel<<<grid, block>>>(*args)``: enqueue on the
        (default) stream and dispatch, and return every array
        parameter's final value as a tensor.  The launch is issued (host
        errors surface here) but the host does not wait for the card.

        ``device`` is the torch device to run on: ``None`` means the
        stream's device, by default CUDA (and raises where there is
        none), ``"cpu"`` runs on the host.  ``grid``/``block`` accept
        CUDA dim3 geometry (``int | (x, y[, z])``).  ``mode``, ``simd``
        and ``collapse`` behave as in the reference, and so do
        ``backend`` (``'scan'`` or the block-parallel ``'vmap'``),
        ``warp_exec`` (``'serial'`` or the ``'batched'`` warp plane),
        ``chunk`` (blocks a ``vmap`` wave), ``schedule`` (``'chunked'``
        or ``'grid_stride'``) and ``n_resident`` (the grid-stride wave
        width).  ``mesh``/``axis`` (the ``'sharded'`` backend),
        ``autotune`` and ``donate`` are described at :meth:`make_request`.
        ``stream=`` enqueues on a :class:`Stream` instead of the default
        one."""
        return self.launch_async(
            grid=grid,
            block=block,
            args=args,
            collapse=collapse,
            mode=mode,
            simd=simd,
            warp_size=warp_size,
            mesh=mesh,
            axis=axis,
            backend=backend,
            chunk=chunk,
            warp_exec=warp_exec,
            schedule=schedule,
            n_resident=n_resident,
            donate=donate,
            device=device,
            autotune=autotune,
            stream=stream,
        ).arrays()

    def launch_async(self, *, stream: Optional[Stream] = None, **knobs) -> LaunchHandle:
        """Enqueue on ``stream`` (default: the legacy-sync default
        stream) and return a :class:`LaunchHandle` future at once.
        Takes the keyword knobs of :meth:`launch`."""
        st = stream if stream is not None else get_dispatcher().default
        return st.launch(self, **knobs)

    def uses_warp_features(self) -> bool:
        return K.uses_warp_features(self.ir)


def kernel(fn=None, *, name: Optional[str] = None):
    """Decorator: parse a restricted-Python CUDA-style kernel."""

    def wrap(f):
        return KernelFn(parse_kernel(f, name=name))

    if fn is None:
        return wrap
    return wrap(fn)
