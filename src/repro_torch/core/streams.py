"""CUDA streams & events: the async launch-dispatch layer (port of the
reference's ``streams.py``).

Every COX launch is a request the dispatcher consumes:

* :class:`LaunchRequest` -- resolved knobs (:class:`~runtime.
  ResolvedLaunch`) plus the held arguments.  ``api.KernelFn.launch`` is
  "build a request, enqueue it on the default stream, dispatch"; the
  returned tensors are the launch's outputs, as before.
* :class:`Stream` -- an in-order launch queue.  ``stream.launch(...)``
  returns a :class:`LaunchHandle` future immediately; ``.result()``
  waits for the outputs.
* :class:`Event` -- ``record()`` captures a point in a stream's program
  order; ``wait(stream)`` makes another stream's *subsequent* launches
  depend on it; ``synchronize()`` blocks the host; ``elapsed(end)``
  reports the milliseconds between two recorded events.
* :class:`Dispatcher` -- the host-side scheduler.  Every flush orders
  the pending requests topologically (stream program order, event
  edges, data edges; a priority ready-set) and issues each one.  The
  launch-level stage cache lives here, so **all streams share staged
  plans**: identical geometry launched from two streams stages once.

**On the card** a cox stream issues on a ``torch.cuda.Stream`` of its
own (priority as given; CUDA's convention, lower is more urgent), and
the default cox stream issues on ``torch.cuda.current_stream()``, so it
orders with the model step and the kernel wrappers, which launch there.
Three things differ from the reference, where one XLA device runs one
program at a time and host dispatch order is execution order:

* *Host dispatch order is not GPU order.*  Two torch streams run
  concurrently whatever order the host issued them in, so every
  cross-stream edge the dispatcher knows becomes a device-side wait: the
  producer records a ``torch.cuda.Event`` after its launch and the
  consumer's stream waits on it.  That covers event edges,
  ``handle.outputs`` data edges and the default stream's legacy barrier
  (its launch depends on every other stream's tail).
* *Legacy default-stream semantics.*  Torch's pool streams are created
  non-blocking, so they do not synchronise with the legacy NULL stream.
  The other direction of the legacy rule -- every stream's next launch
  after the default stream's tail -- is a wait of the cox stream on the
  current stream at each dispatch, which also orders the launch after
  any torch work the caller issued there and whose tensors it may read.
* *The caching allocator across streams.*  A tensor made on one stream
  and read on another needs ``record_stream``, or its block can be
  reused on the first stream while the second still reads it.  Every
  CUDA tensor a request holds (a producer's output, a caller's tensor)
  is recorded on the stream that reads it; outputs are allocated on the
  launch's own stream.

*Host reads block the host, not the order*: the executor's peel and
masked-while flag reads (``execute._host_bool`` / ``_host_flags``)
synchronise the issuing stream, so two streams' launches overlap on the
card only where neither reads flags back.

**Error model**: failures are typed (``errors.py``) and follow CUDA's
contract -- a failed launch surfaces its error at *its own* sync, its
DAG descendants fail fast with :class:`~errors.CoxDependencyError`
instead of running on stale inputs, the failing stream is poisoned until
the error is surfaced (or ``stream.reset()``), sticky errors
(:class:`~errors.CoxDeviceError`, and a real CUDA fault, see
``errors.classify``) poison every enqueue until :func:`device_reset`,
and ``get_last_error()`` / ``peek_at_last_error()`` are the
``cudaGetLastError`` / ``cudaPeekAtLastError`` analogues.  Transient
failures get a bounded retry with backoff; non-transient failures on
auto-chosen knobs walk the degradation ladder (batched -> serial warp
execution, vmap -> scan backend; each rung re-staged, bitwise-correct by
the backend-equivalence contract, and logged).  Every attempt runs on
fresh device copies of the held arguments (``backends.plan.
materialize_args``), so a retry or a rung never sees an earlier
attempt's in-place writes.  A per-launch deadline (``launch_deadline_s``,
through ``ft.watchdog.StepWatchdog``) turns a hung launch into
:class:`~errors.CoxTimeoutError` at its sync.

**Buffer donation** (``donate=True``): once an attempt holds its own
device copies of the arguments, every held global the reference's flat
binding would alias (a 1-D contiguous tensor on the launch's device in
the kernel's storage dtype) is consumed: its storage goes back to the
allocator, so the launch body runs without the caller's copy, and a
later launch that binds it, or a handle whose output it was, raises
``CoxUnsupported``.  A donating request never shares a staged entry
with a non-donating one (``stage_key``), and a failed attempt that
already consumed its inputs is neither retried nor degraded: as the
reference's donated buffers, they are gone.  Readiness is an event per
launch, so a consumed output leaves the in-flight pruning and the syncs
untouched.

**Placement**: the pool is the current CUDA device (resolved lazily,
so building a dispatcher never touches CUDA; without a card it raises
as ``runtime.resolve_device`` does), or the devices given: torch
devices, or the logical devices of ``launch.mesh.device_pool(n,
logical=True)`` that share one physical device.  With more than one
device in the pool, each non-default stream is *placed* on one at its
first dispatch by a ``placement.py`` policy (round-robin by default)
and keeps it until the device is poisoned by a sticky error; then the
policy re-picks among the healthy devices.  ``device=`` on a launch or
a stream pins it.  The default stream, mesh (sharded) launches and a
one-device pool keep the legacy path (``req.device`` None).  Sticky
errors, the per-device health counters, ``device_reset(device=)`` and
the staging-cache keys key on the pool entry.  A data edge whose
producer ran on another device is an explicit transfer: the consumer's
stream waits on the producer's event, then copies the tensor onto its
device (non-blocking; host data through pinned memory).  On one
physical device the launch's own copy of its inputs is that transfer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import itertools
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from . import costmodel as _costmodel
from . import errors as _errors
from . import faults as _faults
from . import placement as _placement
from . import runtime as _runtime
from ..ft.watchdog import StepWatchdog
from .backends.plan import (
    _host_to_device,
    check_arg_device,
    consume_donated,
    flat_outputs,
    is_consumed,
    materialize_args,
)
from .errors import CoxDependencyError, CoxTimeoutError
from .types import CoxUnsupported, GraphRef

# staged-plan LRU bound: far above any real working set (every distinct
# (kernel, geometry, knobs, device) combination is one entry)
STAGE_CACHE_SIZE = 1024

# dispatch_log retention: a bounded deque of the most recent dispatches
DISPATCH_LOG_MAX = 8192

# errored-request retention: failed requests whose handle was dropped
# without a sync, newest kept
ERROR_LOG_MAX = 256

# structured degradation events (ladder fallbacks), bounded the same way
DEGRADATION_LOG_MAX = 1024

# transient-failure retry: attempts beyond the first, and the backoff
# base (sleep = base * 2**attempt)
RETRY_LIMIT = 3
RETRY_BACKOFF_S = 0.005

# deadline-wait poll period
DEADLINE_POLL_S = 0.001

# per-stage-key telemetry retention
TELEMETRY_MAX = 512


# A real CUDA fault is sticky: after an illegal address or a failed
# launch the CUDA context is unusable (every later call in the process
# returns the same error), so torch's RuntimeError / AcceleratorError
# carrying one of these texts classifies as CoxDeviceError -- the ladder
# must not retry on a broken context.  "CUDA out of memory" stays
# transient through errors._TRANSIENT_MARKERS.
STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "illegal instruction",
    "misaligned address",
    "device-side assert",
)


def classify(e: BaseException, *, site: str, what: str = "") -> BaseException:
    """``errors.classify`` (a verbatim copy of the reference's), with a
    real CUDA fault wrapped as the sticky :class:`~errors.
    CoxDeviceError`."""
    if not isinstance(e, (_errors.CoxError, CoxUnsupported)) and any(
        m in str(e) for m in STICKY_CUDA_MARKERS
    ):
        prefix = f"{what}: " if what else ""
        wrapped = _errors.CoxDeviceError(f"{prefix}{site} failed: {type(e).__name__}: {e}")
        wrapped.__cause__ = e
        return wrapped
    return _errors.classify(e, site=site, what=what)


def _is_cuda(dev) -> bool:
    return dev is not None and torch.device(_runtime.physical(dev)).type == "cuda"


def _outputs_ready(req: "LaunchRequest") -> bool:
    """Non-blocking readiness: the event recorded after the launch on
    the card; host launches are complete once issued."""
    return req.done is None or req.done.query()


def _block_outputs(req: "LaunchRequest") -> None:
    """Block the host until the launch completed (a CUDA fault of the
    launch raises here)."""
    if req.done is not None:
        req.done.synchronize()


def _dev_id(dev) -> Optional[str]:
    """A stable hashable stand-in for a pool entry in cache keys and the
    per-device sticky map (``None`` = unplaced / legacy path)."""
    return None if dev is None else str(dev)


def _mesh_key(mesh, axis: str) -> Any:
    """A hashable stand-in for a launch's mesh in staging-cache keys: its
    device type, dimension names, shape and ranks, and the mesh object's
    identity.  The staged runner holds the mesh (and through it the
    process groups), so while an entry lives its ``id`` cannot be
    reused: a group destroyed and made again comes with a new mesh and
    never hits a runner bound to the old one."""
    if mesh is None:
        return None
    return (
        "mesh",
        mesh.device_type,
        tuple(mesh.mesh_dim_names or ()),
        tuple(mesh.mesh.shape),
        tuple(mesh.mesh.reshape(-1).tolist()),
        axis,
        id(mesh),
    )


def _held_tensors(req: "LaunchRequest"):
    for v in list((req.globals_ or {}).values()) + list((req.scalars or {}).values()):
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            yield v


@dataclasses.dataclass
class LaunchRequest:
    """One ``kernel<<<grid, block, stream>>>(*args)`` as data: the
    resolved launch knobs plus the held arguments.  ``KernelFn.
    make_request`` builds one, a :class:`Stream` enqueues it, the
    dispatcher stages and issues it."""

    ck: Any  # CompiledKernel
    token: tuple  # pass-pipeline cache key (stable per ck)
    rl: Any  # runtime.ResolvedLaunch
    simd: bool
    chunk: Optional[int]
    donate: bool
    globals_: Optional[Dict[str, Any]]  # held arrays; dropped after dispatch
    shapes: Dict[str, tuple]
    scalars: Optional[Dict[str, Any]]
    # a sharded launch's DeviceMesh and axis (never placed)
    mesh: Any = None
    axis: str = "data"
    # the *requested* (pre-resolution) knobs: the degradation ladder only
    # falls back along rungs the caller left on 'auto'
    req_backend: str = "auto"
    req_warp_exec: str = "auto"
    # the pool entry the launch runs on: an explicit pin (the launch's or
    # its stream's device=), or the placement policy's pick at dispatch;
    # None on the legacy single-device path
    device: Any = None
    # dispatch priority, inherited from the stream at enqueue
    priority: int = 0
    # dispatcher bookkeeping (set at enqueue / dispatch)
    seq: int = -1
    stream: Optional["Stream"] = None
    deps: Tuple[int, ...] = ()
    data_deps: Tuple[int, ...] = ()  # handle.outputs edges
    outputs: Optional[Dict[str, Any]] = None  # flat output tensors
    dispatched: bool = False
    error: Optional[BaseException] = None
    surfaced: bool = False
    injected_hang: bool = False  # timeout-site fault: outputs never ready
    out_ids: List[int] = dataclasses.field(default_factory=list)
    # bytes of held inputs a donate=True attempt consumed: once set, a
    # failed attempt has no inputs left to retry or degrade with
    consumed: int = 0
    # the physical torch device the launch runs on
    target: Optional[torch.device] = None
    # on the card: the event recorded after the launch, and its stream
    done: Any = None
    tstream: Any = None

    def fn_key(self) -> tuple:
        """Everything that determines the request's staged runner.  The
        target device is part of it: a runner caches its constants on
        the device it first ran on."""
        rl = self.rl
        return (
            self.token,
            self.ck.n_phases,
            rl.backend,
            rl.mode,
            rl.grid.astuple(),
            rl.block.astuple(),
            rl.n_warps,
            self.simd,
            self.chunk,
            rl.warp_exec,
            rl.schedule,
            rl.n_resident,
            _mesh_key(self.mesh, self.axis),
            _dev_id(self.target),
        )

    def stage_key(self) -> tuple:
        """The staging-cache key without the kernel-identity element
        (the dispatcher prepends it): the compile token first, the phase
        count second, ``donate`` and the pool entry last."""
        return self.fn_key() + (self.donate, _dev_id(self.device))


class LaunchHandle:
    """Future for an enqueued launch.  ``.result()`` flushes the
    dispatcher, blocks until this launch completed and returns its
    outputs reshaped -- the synchronous endpoint.  ``.outputs`` is the
    async endpoint: it only guarantees the launch has been *issued* and
    hands back the flat output tensors, the currency for chaining
    dependent launches (on any stream) without a host sync."""

    __slots__ = ("_req", "_disp")

    def __init__(self, req: LaunchRequest, disp: "Dispatcher"):
        self._req = req
        self._disp = disp

    @property
    def stream(self) -> "Stream":
        return self._req.stream

    @property
    def request(self) -> LaunchRequest:
        return self._req

    def done(self) -> bool:
        """True once the launch has been issued and completed (never
        blocks)."""
        req = self._req
        if req.error is not None:
            return True
        if not req.dispatched or req.injected_hang:
            return False
        return _outputs_ready(req)

    @property
    def outputs(self) -> Dict[str, Any]:
        """Flat output tensors (async: issued, not awaited)."""
        self._disp.dispatch_through(self._req)
        if self._req.error is not None:
            self._disp.forget(self._req)
            raise self._req.error
        return self._req.outputs

    def _reshaped(self) -> Dict[str, Any]:
        req = self._req
        for k, v in req.outputs.items():
            if is_consumed(v):
                raise CoxUnsupported(
                    f"launch output '{k}' was donated to a later donate=True "
                    f"launch and its storage is gone -- materialize the handle "
                    f"before donating its outputs, or keep the downstream "
                    f"handle instead"
                )
        return {k: v.reshape(req.shapes[k]) for k, v in req.outputs.items()}

    def arrays(self) -> Dict[str, Any]:
        """Reshaped outputs *without* a host sync.  On the card the
        current stream waits for the launch (and its tensors are
        recorded there), so torch work the caller issues next reads
        them safely."""
        self.outputs  # issue + surface this request's error
        req = self._req
        if req.done is not None:
            cur = torch.cuda.current_stream(req.target)
            if req.tstream != cur:
                cur.wait_event(req.done)
                for v in req.outputs.values():
                    if not is_consumed(v):
                        v.record_stream(cur)
        return self._reshaped()

    def result(self) -> Dict[str, Any]:
        """Materialize: flush, block on this launch, reshape outputs."""
        self._disp.sync_request(self._req)
        return self._reshaped()


class Stream:
    """An in-order launch queue (CUDA ``cudaStream_t``).

    Launches on one stream dispatch in program order; launches on
    different streams are unordered unless an :class:`Event` edge, a
    data edge or the legacy default stream connects them.  The **default
    stream** has CUDA's legacy-sync semantics: a launch on it is ordered
    after the current tail of *every* stream, and every stream's next
    launch after the default stream's tail.

    While a stream is **capturing** into a :class:`~graphs.Graph`
    (``begin_capture()``/``end_capture()``), launches record graph nodes
    instead of dispatching, and host-blocking operations raise
    :class:`CoxUnsupported`."""

    _names = itertools.count()

    def __init__(
        self,
        name: Optional[str] = None,
        dispatcher: Optional["Dispatcher"] = None,
        *,
        priority: int = 0,
        device: Any = None,
        _default: bool = False,
    ):
        self._disp = dispatcher if dispatcher is not None else get_dispatcher()
        self._default = _default
        self.name = name or ("default" if _default else f"stream{next(self._names)}")
        self.priority = int(priority)
        # a pin (device=), or the placement policy's pick once the stream
        # first dispatches on a multi-device pool (kept until poisoned)
        self._device = None if device is None else _runtime.resolve_entry(device)
        self._device_pinned = device is not None
        self._wait_deps: List[int] = []  # event edges for the next launch
        self._capture = None  # Graph while capturing, else None
        self._capture_deps: List[int] = []
        self._error: Optional[BaseException] = None
        self._torch: Dict[Any, Any] = {}  # pool entry -> torch.cuda.Stream
        self._last_target: Any = None  # the pool entry it last ran on

    def __repr__(self):
        return f"Stream({self.name!r})"

    @property
    def is_default(self) -> bool:
        return self._default

    @property
    def device(self) -> Any:
        """The device this stream's launches run on: its pin, the
        placement policy's pick, or ``None`` (unplaced: the legacy
        single-device path)."""
        return self._device

    @property
    def dispatcher(self) -> "Dispatcher":
        return self._disp

    def torch_stream(self, entry) -> "torch.cuda.Stream":
        """The torch stream this cox stream issues on, for a pool entry on
        a CUDA device: the current stream for the default cox stream,
        else a stream of its own per entry (so logical devices of one
        card never share one), made at first use with this stream's
        priority (torch clamps it to the card's range; positive numbers
        are its lowest priority, 0)."""
        entry = _runtime.resolve_entry(entry)
        device = _runtime.physical(entry)
        if self._default:
            return torch.cuda.current_stream(device)
        s = self._torch.get(entry)
        if s is None:
            s = self._torch[entry] = torch.cuda.Stream(
                device=device, priority=min(self.priority, 0)
            )
        return s

    def launch(self, kern, *, grid, block, args, **knobs) -> LaunchHandle:
        """Enqueue ``kern<<<grid, block>>>(*args)`` on this stream and
        return a :class:`LaunchHandle` immediately.  Dispatch is eager,
        like a CUDA launch: the request (and anything still pending)
        goes straight through the dispatcher's flush.  While capturing,
        the request is recorded as a graph node instead, and the handle
        hands back :class:`~types.GraphRef` placeholders."""
        req = kern.make_request(grid=grid, block=block, args=args, stream=self, **knobs)
        if self._capture is not None:
            return self._capture.add_request(req, stream=self)
        handle = self._disp.enqueue(req, self)
        self._disp.flush()
        return handle

    # ---------------- stream capture (CUDA graphs) ----------------

    def begin_capture(self, graph=None):
        """Start capturing this stream's schedule into ``graph`` (a new
        :class:`~graphs.Graph` when ``None``), CUDA
        ``cudaStreamBeginCapture``.  Returns the graph."""
        from . import graphs as _graphs  # late: graphs imports streams

        if self._capture is not None:
            raise CoxUnsupported(
                f"{self!r} is already capturing into {self._capture!r} -- "
                f"end_capture() first"
            )
        g = graph if graph is not None else _graphs.Graph()
        g._attach_stream(self)
        self._capture = g
        self._capture_deps = []
        self._disp._capturing.add(self)
        return g

    def end_capture(self):
        """End capture and return the captured graph."""
        if self._capture is None:
            raise CoxUnsupported(f"{self!r}.end_capture() without begin_capture()")
        g = self._capture
        g._detach_stream(self)
        self._capture = None
        self._capture_deps = []
        self._disp._capturing.discard(self)
        return g

    @property
    def capturing(self) -> bool:
        return self._capture is not None

    def wait_event(self, event: "Event") -> None:
        """All *subsequent* launches on this stream wait for ``event``
        (CUDA ``cudaStreamWaitEvent``).  Waiting on an unrecorded event
        is a no-op, as on CUDA."""
        event.wait(self)

    def record_event(self, event: Optional["Event"] = None) -> "Event":
        """Record (a new) event at this stream's current tail."""
        ev = event if event is not None else Event()
        ev.record(self)
        return ev

    def synchronize(self) -> None:
        """Block the host until every launch enqueued on this stream has
        completed.  Idempotent; illegal during capture."""
        if self._capture is not None:
            raise CoxUnsupported(
                f"{self!r}.synchronize() during stream capture -- a capture "
                f"records the schedule without running it; end_capture() first "
                f"(cudaStreamSynchronize in a capture invalidates it)"
            )
        self._disp.sync_stream(self)

    # ---------------- error state (stream poisoning) ----------------

    @property
    def error(self) -> Optional[BaseException]:
        """The stream's first un-surfaced failure, or ``None``.  While
        set, every subsequent launch on this stream fails fast with
        :class:`~errors.CoxDependencyError`.  It clears when the error
        is surfaced or via :meth:`reset`."""
        return self._error

    def reset(self) -> "Stream":
        """Clear the stream's non-sticky error state and pending event
        edges.  A sticky device error is *not* cleared (only
        :func:`device_reset` is the ``cudaDeviceReset`` analogue)."""
        if self._capture is not None:
            raise CoxUnsupported(f"{self!r}.reset() during stream capture -- end_capture() first")
        self._error = None
        self._wait_deps = []
        self._disp.release_stream_errors(self)
        return self

    def _consume_wait_deps(self) -> List[int]:
        deps, self._wait_deps = self._wait_deps, []
        return deps

    def _consume_capture_deps(self) -> List[int]:
        deps, self._capture_deps = self._capture_deps, []
        return deps


class Event:
    """CUDA-style event: a recorded point in a stream's program order.

    ``record(stream)`` captures the stream's current tail; ``wait(
    stream)`` orders another stream's subsequent launches after it;
    ``synchronize()`` blocks the host until the recorded work completed;
    ``elapsed(end)`` returns the milliseconds between two events.  On the
    card that is ``torch.cuda.Event(enable_timing=True).elapsed_time``:
    device time between the records, CUDA's meaning.  On the host it is
    the host clock at the first observed completion (a ``synchronize``),
    as in the reference."""

    def __init__(self):
        self._req: Optional[LaunchRequest] = None
        self._disp: Optional[Dispatcher] = None
        self._recorded = False
        self._t_done: Optional[float] = None
        self._cuda = None  # torch.cuda.Event recorded on the card
        self._graph = None  # capture graph, when recorded there
        self._gnode = None  # captured tail node (None: idle)

    def record(self, stream: Optional[Stream] = None) -> "Event":
        stream = stream if stream is not None else get_dispatcher().default
        self._disp = stream.dispatcher
        self._cuda = None
        if stream._capture is not None:
            # capture-recorded: the event marks the stream's captured
            # tail node, a schedule edge, not a completion point
            self._graph = stream._capture
            self._gnode = stream._capture._tail_node(stream)
            self._req = None
            self._recorded = True
            self._t_done = None
            return self
        self._graph = self._gnode = None
        self._req = self._disp.tail_request(stream)  # None: empty stream
        self._recorded = True
        if self._req is not None and not self._req.dispatched:
            self._disp.flush()
        if self._req is not None and self._req.tstream is not None:
            ts = self._req.tstream  # the torch stream the tail ran on
        else:
            entry = self._disp._stream_entry(stream)
            ts = stream.torch_stream(entry) if _is_cuda(entry) else None
        if ts is not None:
            self._cuda = torch.cuda.Event(enable_timing=True)
            self._cuda.record(ts)
        # recording on an idle stream completes at once (CUDA: an event
        # completes once all preceding stream work has)
        self._t_done = None if self._req is not None else time.perf_counter()
        return self

    def wait(self, stream: Stream) -> None:
        if not self._recorded:
            return  # CUDA: wait-before-record is a no-op
        if self._graph is not None:  # capture-recorded event
            if stream._capture is None:
                raise CoxUnsupported(
                    f"eager stream {stream.name!r} cannot wait on an event "
                    f"recorded during capture -- the captured schedule has not "
                    f"run; wait inside the same capture or replay the graph first"
                )
            if stream._capture is not self._graph:
                raise CoxUnsupported(
                    f"stream {stream.name!r} is capturing into a different graph "
                    f"than the one this event was recorded in -- cross-graph "
                    f"event edges are not capturable"
                )
            if self._gnode is not None:
                stream._capture_deps.append(self._gnode.idx)
            return
        if stream._capture is not None:
            raise CoxUnsupported(
                f"capturing stream {stream.name!r} cannot wait on an event "
                f"recorded outside its capture -- CUDA invalidates the capture; "
                f"record the event inside the capture"
            )
        if self._req is None:
            return
        stream._wait_deps.append(self._req.seq)

    def query(self) -> bool:
        """True when the recorded work has completed (never blocks).
        Illegal for a capture-recorded event."""
        if self._graph is not None:
            raise CoxUnsupported(
                "Event.query() on an event recorded during stream capture -- the "
                "captured schedule runs only at graph.replay(); a capture event "
                "is a schedule edge, not a completion point"
            )
        if not self._recorded or self._req is None:
            return True
        if not self._req.dispatched or self._req.injected_hang:
            return False
        if self._req.error is not None:
            return True  # failed work is "complete"
        return _outputs_ready(self._req)

    def synchronize(self) -> "Event":
        """Block until the recorded work completed; idempotent."""
        if self._graph is not None:
            raise CoxUnsupported(
                "Event.synchronize() on an event recorded during stream capture "
                "-- the captured schedule runs only at graph.replay()"
            )
        if not self._recorded:
            raise CoxUnsupported("Event.synchronize() before record()")
        if self._req is not None:
            self._disp.sync_request(self._req)
        if self._cuda is not None:
            self._cuda.synchronize()
        if self._t_done is None:
            self._t_done = time.perf_counter()
        return self

    def elapsed(self, end: "Event") -> float:
        """Milliseconds between this (start) event and ``end``, CUDA
        ``cudaEventElapsedTime``: device time where both were recorded
        on the card, else the host clock.  Synchronizes both events."""
        self.synchronize()
        end.synchronize()
        if self._cuda is not None and end._cuda is not None:
            return float(self._cuda.elapsed_time(end._cuda))
        return (end._t_done - self._t_done) * 1e3

    elapsed_time = elapsed  # cupy-style alias


class Dispatcher:
    """Host-side launch scheduler + the shared staging cache.

    :meth:`flush` orders the pending request graph topologically --
    stream program order plus event and data edges, a priority ready-set
    with FIFO tie-break -- and issues each request.  On the card an
    issue returns once the work is queued on its stream, so a launch
    executes while the host binds and issues the next one.

    Staged plans are cached here, keyed on kernel identity plus the
    request's resolved geometry, knobs and device (``LaunchRequest.
    stage_key``), so every stream -- and ``KernelFn.launch`` -- shares
    one staging per distinct launch shape."""

    def __init__(
        self,
        stage_cache_size: int = STAGE_CACHE_SIZE,
        dispatch_log_max: int = DISPATCH_LOG_MAX,
        *,
        launch_deadline_s: Optional[float] = None,
        max_strikes: int = 8,
        error_log_max: int = ERROR_LOG_MAX,
        retry_limit: int = RETRY_LIMIT,
        retry_backoff_s: float = RETRY_BACKOFF_S,
        devices: Optional[Tuple[Any, ...]] = None,
        placement: Optional[Any] = None,
    ):
        self._lock = threading.RLock()
        self._dispatch_lock = threading.Lock()
        self._stage_cache_size = stage_cache_size
        self._staged: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._staged_fns: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._pending: "OrderedDict[int, LaunchRequest]" = OrderedDict()
        self._inflight: Dict[int, LaunchRequest] = {}
        # stream -> weakref to its tail request (a dead tail means the
        # work completed and was collected: no edge needed)
        self._tails: "weakref.WeakKeyDictionary[Stream, Any]" = weakref.WeakKeyDictionary()
        self._seq = itertools.count()
        self.dispatch_log: Deque[int] = deque(maxlen=dispatch_log_max)
        self.stage_hits = 0
        self.stage_misses = 0
        self.stage_fn_hits = 0
        self.stage_fn_misses = 0
        self._telemetry: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        self._capturing: "weakref.WeakSet[Stream]" = weakref.WeakSet()
        self.error_log_max = error_log_max
        self._errored: "OrderedDict[int, LaunchRequest]" = OrderedDict()
        # id(output tensor) -> (weakref, producer seq): the data edges
        # behind handle.outputs chaining
        self._out_producers: Dict[int, Tuple[Any, int]] = {}
        # device-poisoning errors, keyed by the failing request's pool
        # entry, or None for unplaced work (the process-wide CUDA
        # behavior); placement routes around a poisoned entry
        self._sticky: "OrderedDict[Optional[str], BaseException]" = OrderedDict()
        self._last_error: Optional[BaseException] = None
        # the device pool is lazy: this constructor runs at import (the
        # default dispatcher) and must not touch CUDA
        self._devices = (
            tuple(_runtime.resolve_entry(d) for d in devices) if devices is not None else None
        )
        if self._devices is not None and len(set(map(_dev_id, self._devices))) != len(self._devices):
            raise ValueError(
                f"the device pool names a device twice: {[str(d) for d in self._devices]} "
                f"-- ask device_pool(n, logical=True) for logical devices that share one"
            )
        self.placement = placement  # policy; round-robin at the first placement
        self.transfers = 0  # tensors copied onto another physical device
        self._dev_counters: Dict[str, Dict[str, int]] = {}
        self.launch_deadline_s = launch_deadline_s
        self.max_strikes = max_strikes
        self.retry_limit = retry_limit
        self.retry_backoff_s = retry_backoff_s
        self.failures = 0
        self.retries = 0
        self.degradations = 0
        self.timeouts = 0
        self.degradation_log: Deque[Dict[str, Any]] = deque(maxlen=DEGRADATION_LOG_MAX)
        self.watchdog: Optional[StepWatchdog] = None
        self._wd_lock = threading.Lock()
        self.default = Stream(dispatcher=self, _default=True)

    # ---------------- placement ----------------

    @property
    def devices(self) -> Tuple[Any, ...]:
        """The device pool: the entries given (torch devices or logical
        devices), else the current CUDA device (resolved lazily; raises
        where there is no card, as a launch with no device does)."""
        devs = self._devices
        if devs is None:
            devs = self._devices = (_runtime.resolve_device(None),)
        return devs

    def _pool_if_known(self) -> Optional[Tuple[Any, ...]]:
        """The pool, without raising where it cannot be resolved."""
        if self._devices is None and not torch.cuda.is_available():
            return None
        return self.devices

    def _stream_entry(self, stream: Stream) -> Any:
        """The pool entry an idle stream would run on, if known."""
        if stream._device is not None:
            return stream._device
        if stream._last_target is not None:
            return stream._last_target
        pool = self._pool_if_known()
        return pool[0] if pool else None

    def _stream_device(self, stream: Stream) -> Optional[torch.device]:
        """The physical device an idle stream would run on, if known."""
        return _runtime.physical(self._stream_entry(stream))

    def _healthy_devices(self) -> List[Any]:
        with self._lock:
            poisoned = set(self._sticky) - {None}
        return [d for d in (self._pool_if_known() or ()) if _dev_id(d) not in poisoned]

    def _sticky_blocking(self) -> Optional[BaseException]:
        """The sticky error that must fail an enqueue outright: an
        unplaced sticky fault poisons the process (the CUDA contract),
        and a pinned one once no healthy device is left in the pool."""
        with self._lock:
            if not self._sticky:
                return None
            glob = self._sticky.get(None)
            if glob is not None:
                return glob
            if not self._healthy_devices():
                return next(iter(self._sticky.values()))
            return None

    def _sticky_for(self, device) -> Optional[BaseException]:
        """The sticky error covering a request bound for ``device`` (a
        pool entry): its own, or -- for unplaced work, which runs on the
        pool's first device -- that device's.  Caller holds ``_lock``."""
        glob = self._sticky.get(None)
        if glob is not None:
            return glob
        if not self._sticky:
            return None
        if device is None:
            pool = self._pool_if_known()
            if not pool:
                return None
            device = pool[0]
        return self._sticky.get(_dev_id(device))

    def _place(self, req: LaunchRequest) -> None:
        """Assign the request its pool entry (``req.device``) and its
        physical device (``req.target``).  Pinned requests (their entry is
        set at enqueue), mesh (sharded) launches, default-stream launches
        and a one-device pool keep their path.  Raises the first sticky
        error when no healthy device remains."""
        if req.device is not None or req.mesh is not None:
            return
        s = req.stream
        if s is None or s.is_default:
            return  # CUDA: the default stream is the current device's
        devices = self._pool_if_known()
        if not devices or len(devices) <= 1:
            return
        healthy = self._healthy_devices()
        if not healthy:
            err = self._sticky_blocking()
            if err is not None:
                raise err
            healthy = list(devices)  # a racing device_reset: the pool is back
        if self.placement is None:
            self.placement = _placement.RoundRobinPlacement()
        req.device = self.placement.place(req, healthy, self)
        req.target = _runtime.physical(req.device)

    @staticmethod
    def _dev_of(req: LaunchRequest):
        if req.device is not None:
            return req.device
        s = req.stream
        return s._device if s is not None else None

    def _bump_dev(self, device, key: str) -> None:
        """Per-device health counter bump.  Caller holds ``_lock``."""
        name = str(device) if device is not None else "default"
        c = self._dev_counters.get(name)
        if c is None:
            c = self._dev_counters[name] = {"dispatches": 0, "failures": 0, "degradations": 0}
        c[key] += 1

    def device_health(self) -> Dict[str, Dict[str, int]]:
        """Per-device dispatch counters, keyed by ``str(device)``
        (``"default"`` collects unplaced work)."""
        with self._lock:
            return {k: dict(v) for k, v in self._dev_counters.items()}

    # ---------------- enqueue ----------------

    def resolve_target(self, req: LaunchRequest, stream: Stream) -> None:
        """Fill ``req.target``, the physical device the launch runs on: the
        mesh's for a sharded launch, else its pin's, its stream's or the
        pool's first (a multi-device pool re-places it at dispatch).  On
        the legacy path a tensor argument held on another device is
        refused, and so is one of the caller's on a pinned launch; a data
        edge from another device (a launch's output) is copied over at
        dispatch (the transfer node), as is every input of a launch the
        policy places."""
        if req.mesh is not None:
            from .backends import sharded

            req.target = sharded.mesh_device(req.mesh)
        else:
            if req.device is None and stream._device_pinned:
                req.device = stream._device
            entry = req.device if req.device is not None else stream._device
            if entry is None:
                entry = self.devices[0]
            req.target = _runtime.physical(entry)
            pool = self._pool_if_known() or ()
            if req.device is None and not stream.is_default and len(pool) > 1:
                return  # placed at dispatch
        for name, val in list((req.globals_ or {}).items()) + list((req.scalars or {}).items()):
            if req.device is not None and isinstance(val, torch.Tensor):
                with self._lock:
                    if self._producer_seq(val) is not None:
                        continue  # a data edge: transferred at dispatch
            check_arg_device(val, req.target, name)

    def enqueue(self, req: LaunchRequest, stream: Stream) -> LaunchHandle:
        """Assign the request its place in the launch order: program
        order on its stream, pending event edges, the default stream's
        legacy-sync edges and the data edges of its arguments."""
        if req.globals_:
            for name, val in req.globals_.items():
                if isinstance(val, GraphRef):
                    raise CoxUnsupported(
                        f"kernel '{req.ck.kernel.name}': argument '{name}' is a "
                        f"capture placeholder ({val!r}) that escaped its graph -- "
                        f"captured outputs only exist inside the capture; replay "
                        f"the graph and use its real outputs instead"
                    )
        blocking = self._sticky_blocking()
        if blocking is not None:
            raise blocking
        self.resolve_target(req, stream)
        with self._lock:
            req.seq = next(self._seq)
            req.stream = stream
            req.priority = stream.priority
            deps = []
            tail = self.tail_request(stream)
            if tail is not None:
                deps.append(tail.seq)  # in-order within the stream
            if stream.is_default:
                # legacy sync: after the current tail of every other stream
                for s in list(self._tails):
                    if s is stream:
                        continue
                    t = self._tails[s]()
                    if t is not None:
                        deps.append(t.seq)
            else:
                dt = self.tail_request(self.default)
                if dt is not None:
                    deps.append(dt.seq)  # ...and every stream after it
            deps.extend(stream._consume_wait_deps())
            req.deps = tuple(sorted(set(deps)))
            if req.globals_:
                ddeps = {self._producer_seq(v) for v in req.globals_.values()}
                ddeps.discard(None)
                req.data_deps = tuple(sorted(ddeps))
            self._pending[req.seq] = req
            self._tails[stream] = weakref.ref(req)
            return LaunchHandle(req, self)

    def _producer_seq(self, val) -> Optional[int]:
        """The in-flight/errored producer seq of ``val``, if ``val`` is
        one of its output tensors (identity-checked)."""
        entry = self._out_producers.get(id(val))
        if entry is None:
            return None
        ref, seq = entry
        if ref is not None and ref() is not val:
            return None
        return seq

    def tail_request(self, stream: Stream) -> Optional[LaunchRequest]:
        with self._lock:
            ref = self._tails.get(stream)
            return ref() if ref is not None else None

    # ---------------- staging (the shared launch cache) ----------------

    def stage(self, req: LaunchRequest):
        """Resolve the request to a staged ``(plan, run)``, shared across
        streams.  The port runs eagerly, so the staged runner is the raw
        one of :meth:`stage_fn`; the two caches keep the reference's
        counters (a graph over a launch shape the streams already ran
        stages nothing new)."""
        key = (id(req.ck),) + req.stage_key()
        with self._lock:
            hit = self._staged.get(key)
            if hit is not None:
                self._staged.move_to_end(key)
                self.stage_hits += 1
                return hit
        staged = self.stage_fn(req)
        with self._lock:
            self.stage_misses += 1
            self._staged[key] = staged
            while len(self._staged) > self._stage_cache_size:
                self._staged.popitem(last=False)
        return staged

    def stage_fn(self, req: LaunchRequest):
        """Resolve the request to its raw runner ``(plan, run)`` -- the
        form the graph layer walks -- shared by every graph that captures
        the same launch shape."""
        key = (id(req.ck),) + req.fn_key()
        with self._lock:
            hit = self._staged_fns.get(key)
            if hit is not None:
                self._staged_fns.move_to_end(key)
                self.stage_fn_hits += 1
                return hit
        staged = _runtime.build_resolved(
            req.ck, req.rl, simd=req.simd, mesh=req.mesh, axis=req.axis
        )
        with self._lock:
            self.stage_fn_misses += 1
            self._staged_fns[key] = staged
            while len(self._staged_fns) > self._stage_cache_size:
                self._staged_fns.popitem(last=False)
        return staged

    def stage_graph(self, key: tuple, builder):
        """Stage a captured graph's executable in the shared LRU.
        ``key`` starts with the literal ``"graph"`` tag followed by the
        DAG's per-node keys: two structurally identical captures share
        one executable.  ``builder()`` runs without the queue lock."""
        with self._lock:
            hit = self._staged.get(key)
            if hit is not None:
                self._staged.move_to_end(key)
                self.stage_hits += 1
                return hit
        staged = builder()
        with self._lock:
            self.stage_misses += 1
            self._staged[key] = staged
            while len(self._staged) > self._stage_cache_size:
                self._staged.popitem(last=False)
        return staged

    def cache_view(self, cks) -> Dict[tuple, tuple]:
        """The staged entries of the given compiled kernels, keyed
        without the kernel-identity element."""
        ids = {id(ck) for ck in cks}
        with self._lock:
            return {k[1:]: v for k, v in self._staged.items() if k[0] in ids}

    # ---------------- dispatch ----------------

    def _toposorted(self) -> List[LaunchRequest]:
        """Kahn's algorithm over the pending graph (edges: ``req.deps``
        restricted to still-pending requests).  The ready-set is a
        priority heap: the lowest stream priority number dispatches
        first, FIFO enqueue order breaks ties."""
        pending = self._pending
        indeg = {seq: sum(1 for d in r.deps if d in pending) for seq, r in pending.items()}
        ready = [(pending[seq].priority, seq) for seq, n in indeg.items() if n == 0]
        out: List[LaunchRequest] = []
        fwd: Dict[int, List[int]] = {}
        for seq, r in pending.items():
            for d in r.deps:
                if d in pending:
                    fwd.setdefault(d, []).append(seq)
        heapq.heapify(ready)
        while ready:
            _, seq = heapq.heappop(ready)
            out.append(pending[seq])
            for nxt in fwd.get(seq, ()):
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    heapq.heappush(ready, (pending[nxt].priority, nxt))
        if len(out) != len(pending):  # impossible by construction
            raise AssertionError("cycle in launch-dependency graph")
        return out

    def _dispatch(self, req: LaunchRequest) -> None:
        name = req.ck.kernel.name
        if req.error is not None:  # already failed fast (descendant)
            self._finish_failed(req)
            return
        with self._lock:
            dep_err = self._first_dep_error(req)
        if dep_err is not None:
            root = _errors.root_of(dep_err)
            self._fail_request(
                req,
                CoxDependencyError(
                    f"kernel '{name}' (seq {req.seq}) not dispatched: upstream "
                    f"failure {type(root).__name__}: {root}",
                    root=root,
                ),
            )
            return
        try:
            self._place(req)
        except Exception as e:
            self._fail_request(req, e)
            return
        with self._lock:
            sticky = self._sticky_for(req.device)
        if sticky is not None:
            self._fail_request(req, sticky)
            return
        try:
            outputs = self._run_attempts(req, name)
        except Exception as e:  # surfaces at *this* request's sync
            self._fail_request(req, e)
            return
        req.outputs = outputs
        req.dispatched = True
        req.globals_ = None  # release the held inputs
        req.scalars = None
        if req.stream is not None:
            req.stream._last_target = req.device if req.device is not None else req.target
        with self._lock:
            for o in outputs.values():
                self._out_producers[id(o)] = (weakref.ref(o), req.seq)
                req.out_ids.append(id(o))
            self._inflight[req.seq] = req
            self.dispatch_log.append(req.seq)
            self._bump_dev(self._dev_of(req), "dispatches")

    def _first_dep_error(self, req: LaunchRequest) -> Optional[BaseException]:
        """The first un-surfaced failure among the request's DAG parents
        or on its stream.  Caller holds ``_lock``."""
        for d in sorted(set(req.deps) | set(req.data_deps)):
            r = self._inflight.get(d) or self._errored.get(d) or self._pending.get(d)
            if r is not None and r.error is not None and not r.surfaced:
                return r.error
        s = req.stream
        if s is not None and s._error is not None:
            return s._error
        return None

    def _fail_request(self, req: LaunchRequest, err: BaseException) -> None:
        req.error = err
        self._finish_failed(req)

    def _finish_failed(self, req: LaunchRequest) -> None:
        """Bookkeeping for a request that failed at (or before) dispatch:
        record it, poison its stream, update the error registers."""
        req.dispatched = True
        req.globals_ = None
        req.scalars = None
        with self._lock:
            self._inflight[req.seq] = req
            self.dispatch_log.append(req.seq)
            self._last_error = req.error
            self.failures += 1
            self._bump_dev(self._dev_of(req), "failures")
            if _errors.is_sticky(req.error):
                self._note_sticky_locked(req.device, req.error)
            if req.stream is not None and req.stream._error is None:
                req.stream._error = req.error

    # -------- attempts: retry ladder + graceful degradation --------

    def _ladder(self, req: LaunchRequest) -> List[Tuple[Any, str]]:
        """The fallback rungs, most capable first.  Only knobs the caller
        left on ``'auto'`` may degrade; every rung computes bitwise the
        same outputs (scan/serial is the reference semantics)."""
        rungs: List[Tuple[Any, str]] = [(req.rl, "as-resolved")]
        rl = req.rl
        if rl.warp_exec == "batched" and req.req_warp_exec == "auto":
            rl = dataclasses.replace(rl, warp_exec="serial")
            rungs.append((rl, "warp_exec=serial"))
        if rl.backend == "vmap" and req.req_backend == "auto":
            rl = dataclasses.replace(rl, backend="scan")
            rungs.append((rl, "backend=scan"))
        return rungs

    def _run_attempts(self, req: LaunchRequest, name: str) -> Dict[str, Any]:
        """Try the request down its ladder; each rung gets the bounded
        transient retry.  A sticky error aborts the ladder."""
        rungs = self._ladder(req)
        last: Optional[BaseException] = None
        for i, (rl, tag) in enumerate(rungs):
            req.rl = rl
            try:
                return self._attempt_with_retry(req, name)
            except Exception as e:
                if _errors.is_sticky(e) or req.consumed:
                    raise
                last = e
                if i + 1 < len(rungs):
                    event = {
                        "kernel": name,
                        "seq": req.seq,
                        "from": tag,
                        "to": rungs[i + 1][1],
                        "error": repr(e),
                    }
                    with self._lock:
                        self.degradations += 1
                        self._bump_dev(self._dev_of(req), "degradations")
                        self.degradation_log.append(event)
        assert last is not None
        raise last

    def _attempt_with_retry(self, req: LaunchRequest, name: str) -> Dict[str, Any]:
        attempt = 0
        while True:
            try:
                return self._attempt(req, name)
            except Exception as e:
                if (
                    _errors.is_sticky(e)
                    or req.consumed
                    or not _errors.is_transient(e)
                    or attempt >= self.retry_limit
                ):
                    raise
                with self._lock:
                    self.retries += 1
                time.sleep(self.retry_backoff_s * (2**attempt))
                attempt += 1

    def _attempt(self, req: LaunchRequest, name: str) -> Dict[str, Any]:
        """One stage + issue attempt, with the fault-injection consults
        (``faults.py``) at each lifecycle site.  Injected dispatch faults
        fire before the runner runs."""
        fault = _faults.consume("stage", name)
        if fault is not None:
            raise fault
        try:
            _, run = self.stage(req)
        except Exception as e:
            raise classify(e, site="stage", what=f"kernel '{name}'")
        fault = _faults.consume("sticky-device", name)
        if fault is not None:
            raise fault
        fault = _faults.consume("dispatch", name)
        if fault is not None:
            raise fault
        try:
            t0 = time.perf_counter()
            if _is_cuda(req.target):
                outputs = self._issue_cuda(req, run)
            else:
                self._transfer(req)
                g, s = materialize_args(req.ck, req.globals_, req.scalars, req.target)
                if req.donate:
                    req.consumed = consume_donated(req.ck, req.globals_, req.target)
                outputs = flat_outputs(req.ck, run(g, s, req.target))
            dispatch_s = time.perf_counter() - t0
        except Exception as e:
            raise classify(e, site="dispatch", what=f"kernel '{name}'")
        self._note_telemetry(req, dispatch_s)
        if _faults.consume("timeout", name) is not None:
            req.injected_hang = True  # outputs never report ready
        return outputs

    def _issue_cuda(self, req: LaunchRequest, run) -> Dict[str, Any]:
        """Issue one launch on its cox stream's torch stream."""
        dev = req.target
        ts = req.stream.torch_stream(req.device if req.device is not None else dev)
        # host dispatch order is not GPU order: every edge to a launch
        # still running on another torch stream (event edges, data
        # edges, the default stream's legacy barrier on every other
        # stream's tail) becomes a wait on the producer's event
        with self._lock:
            producers = [
                self._inflight.get(d) for d in set(req.deps) | set(req.data_deps)
            ]
        for p in producers:
            if p is not None and p.done is not None and p.tstream != ts:
                ts.wait_event(p.done)
        if not req.stream.is_default:
            # legacy default-stream semantics, other direction: torch's
            # pool streams are non-blocking, so the stream waits on the
            # current stream (the default cox stream's tail, and torch
            # work the caller issued there)
            ts.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(ts):
            self._transfer(req)
            # the caching allocator across streams: a held tensor made on
            # another stream is read here, so its block must not be
            # reused there before this stream is done with it
            for v in _held_tensors(req):
                v.record_stream(ts)
            g, s = materialize_args(req.ck, req.globals_, req.scalars, dev)
            if req.donate:
                # the launch holds its own copies: the donated buffers'
                # blocks go back to the allocator (record_stream above
                # keeps a cross-stream one until this stream is done)
                req.consumed = consume_donated(req.ck, req.globals_, dev)
            outputs = flat_outputs(req.ck, run(g, s, dev))
            done = torch.cuda.Event()
            done.record(ts)
        req.done = done
        req.tstream = ts
        return outputs

    def _transfer(self, req: LaunchRequest) -> None:
        """The explicit transfer node of a pinned or placed launch: a held
        tensor on another physical device is copied onto the launch's, on
        the launch's stream (its producer's event already waited on), and
        written back onto the request so a retry or a rung reuses it.
        Between logical devices of one card the launch's own copy of its
        inputs (``materialize_args``) is the transfer."""
        if req.device is None:
            return
        dev = req.target
        for held in (req.globals_, req.scalars):
            for k, v in list((held or {}).items()):
                if not isinstance(v, torch.Tensor) or v.device == dev:
                    continue
                if dev.type == "cpu":
                    held[k] = v.to(dev)
                elif v.device.type == "cpu":
                    held[k] = _host_to_device(v, dev)
                else:
                    held[k] = v.to(dev, non_blocking=True)
                with self._lock:
                    self.transfers += 1

    def flush(self) -> None:
        """Dispatch every pending request in topological order."""
        with self._dispatch_lock:
            while True:
                with self._lock:
                    if not self._pending:
                        break
                    order = self._toposorted()
                    self._pending = OrderedDict()
                for req in order:
                    self._dispatch(req)
            with self._lock:
                self._prune_inflight()

    def dispatch_through(self, req: LaunchRequest) -> None:
        """Ensure ``req`` (and everything it depends on) was issued."""
        if not req.dispatched:
            self.flush()

    def _prune_inflight(self) -> None:
        # descendants of a still-hung launch stay resident even if their
        # own outputs report ready: when the hang resolves into
        # CoxTimeoutError, _fail_descendants_locked must find them
        blocked: set = set()
        for seq in list(self._inflight):
            r = self._inflight[seq]
            if r.error is not None:
                del self._inflight[seq]
                self._retain_errored(r)
                continue
            if r.injected_hang:
                blocked.add(seq)
                continue
            if blocked and not blocked.isdisjoint((*r.deps, *r.data_deps)):
                blocked.add(seq)
                continue
            if _outputs_ready(r):
                del self._inflight[seq]
                self._drop_producers(r)

    def _retain_errored(self, r: LaunchRequest) -> None:
        self._errored[r.seq] = r
        while len(self._errored) > self.error_log_max:
            _, old = self._errored.popitem(last=False)
            self._drop_producers(old)

    def _drop_producers(self, req: LaunchRequest) -> None:
        for i in req.out_ids:
            entry = self._out_producers.get(i)
            if entry is not None and entry[1] == req.seq:
                del self._out_producers[i]
        req.out_ids = []

    # ---------------- synchronization ----------------

    def _surface_locked(self, req: LaunchRequest) -> None:
        """The request's error reached the caller: mark it surfaced and
        un-poison its stream if this error poisoned it.  Caller holds
        ``_lock``."""
        req.surfaced = True
        s = req.stream
        if s is not None and s._error is req.error:
            s._error = None

    def forget(self, req: LaunchRequest) -> None:
        """Drop a request from the in-flight/errored sets."""
        with self._lock:
            self._inflight.pop(req.seq, None)
            self._errored.pop(req.seq, None)
            self._drop_producers(req)
            if req.error is not None:
                self._surface_locked(req)

    def sync_request(self, req: LaunchRequest) -> None:
        """Flush, then block until this request completed.  A failed
        request raises its typed error here, at its own sync."""
        self.dispatch_through(req)
        if req.error is None:
            self._await_request(req)
        self.forget(req)
        if req.error is not None:
            raise req.error

    def _await_request(
        self, req: LaunchRequest, extra: Optional[List[LaunchRequest]] = None
    ) -> None:
        """Block until the issued request completed, enforcing the
        per-launch deadline when set.  On failure the error is recorded
        on ``req`` and its DAG descendants fail fast."""
        deadline = self.launch_deadline_s
        if deadline is None and req.injected_hang:
            deadline = 0.0  # a hang with no deadline would spin
        name = req.ck.kernel.name
        if deadline is None:
            try:
                _block_outputs(req)
            except Exception as e:
                err = classify(e, site="dispatch", what=f"kernel '{name}'")
                self._record_async_failure(req, err, extra)
            return
        with self._wd_lock:
            wd = self.watchdog
            if wd is None or wd.deadline_s != deadline:
                wd = StepWatchdog(deadline_s=deadline, max_strikes=self.max_strikes)
                self.watchdog = wd
            wd.start(step=req.seq)
            try:
                while True:
                    if not req.injected_hang and _outputs_ready(req):
                        try:
                            _block_outputs(req)
                        except Exception as e:
                            err = classify(e, site="dispatch", what=f"kernel '{name}'")
                            self._record_async_failure(req, err, extra)
                        return
                    if wd.fired:
                        err = CoxTimeoutError(
                            f"kernel '{name}' (seq {req.seq}) exceeded its launch "
                            f"deadline of {deadline}s"
                        )
                        with self._lock:
                            self.timeouts += 1
                        self._record_async_failure(req, err, extra)
                        return
                    time.sleep(DEADLINE_POLL_S)
            finally:
                wd.stop()

    def _record_async_failure(
        self,
        req: LaunchRequest,
        err: BaseException,
        extra: Optional[List[LaunchRequest]] = None,
    ) -> None:
        """A failure detected *after* issue (deadline, async error in the
        wait): record it and fail the DAG descendants."""
        with self._lock:
            req.error = err
            self._last_error = err
            self.failures += 1
            self._bump_dev(self._dev_of(req), "failures")
            if _errors.is_sticky(err):
                self._note_sticky_locked(req.device, err)
            if req.stream is not None and req.stream._error is None:
                req.stream._error = err
            self._fail_descendants_locked(req, err, extra)

    def _fail_descendants_locked(
        self,
        req: LaunchRequest,
        err: BaseException,
        extra: Optional[List[LaunchRequest]] = None,
    ) -> None:
        """Mark every (transitive) DAG descendant of ``req`` failed with
        :class:`CoxDependencyError`.  Deps point to earlier seqs, so one
        ascending pass reaches the fixpoint."""
        root = _errors.root_of(err)
        failed = {req.seq}
        pool: Dict[int, LaunchRequest] = {}
        for r in list(self._pending.values()) + list(self._inflight.values()) + list(extra or ()):
            pool[r.seq] = r
        for seq in sorted(pool):
            r = pool[seq]
            if seq in failed or r.error is not None:
                continue
            if (set(r.deps) | set(r.data_deps)) & failed:
                r.error = CoxDependencyError(
                    f"kernel '{r.ck.kernel.name}' (seq {seq}) depends on failed "
                    f"launch seq {req.seq}: {type(root).__name__}: {root}",
                    root=root,
                )
                if r.stream is not None and r.stream._error is None:
                    r.stream._error = r.error
                failed.add(seq)

    def _take_inflight(self, stream: Optional[Stream]) -> List[LaunchRequest]:
        """Remove (and return, seq-ordered) the in-flight and retained
        errored requests of ``stream``, or of every stream when
        ``None``."""
        with self._lock:
            taken = []
            for pool in (self._inflight, self._errored):
                for seq in list(pool):
                    r = pool[seq]
                    if stream is None or r.stream is stream:
                        del pool[seq]
                        taken.append(r)
                        self._drop_producers(r)
            return sorted(taken, key=lambda r: r.seq)

    def sync_stream(self, stream: Optional[Stream]) -> None:
        """Block until every launch enqueued on ``stream`` completed
        (``None``: on any stream).  The earliest deferred launch error of
        the synced set is raised; every error in the set counts as
        surfaced.  Illegal while any stream of this dispatcher is
        capturing."""
        if stream is not None and stream._capture is not None:
            raise CoxUnsupported(
                f"cannot synchronize {stream!r} during stream capture -- end_capture() first"
            )
        if stream is None and self._capturing:
            names = sorted(s.name for s in self._capturing)
            raise CoxUnsupported(
                f"device-wide synchronize while stream(s) {names} are capturing "
                f"-- a capture records the schedule without running it; "
                f"end_capture() first"
            )
        self.flush()
        taken = self._take_inflight(stream)
        for r in taken:
            if r.error is None:
                self._await_request(r, extra=taken)
        pairs = [(r.seq, r.error) for r in taken if r.error is not None]
        with self._lock:
            for r in taken:
                if r.error is not None:
                    self._surface_locked(r)
            if stream is not None and stream._error is not None:
                pairs.append((float("inf"), stream._error))
                stream._error = None
        if pairs:
            raise min(pairs, key=lambda p: p[0])[1]
        blocking = self._sticky_blocking()
        if blocking is not None:
            raise blocking

    def sync_all(self) -> None:
        """Device-wide barrier (CUDA ``cudaDeviceSynchronize``)."""
        self.sync_stream(None)

    # ------------- error surface (cudaGetLastError analogues) -------------

    @property
    def error_log(self) -> List[LaunchRequest]:
        """The retained failed requests, oldest first."""
        with self._lock:
            return list(self._errored.values())

    def get_last_error(self) -> Optional[BaseException]:
        """Return and *clear* the last launch error (``cudaGetLastError``).
        A sticky error is returned but never cleared.  Consuming an error
        counts as surfacing it."""
        with self._lock:
            if self._sticky:
                return next(iter(self._sticky.values()))
            err = self._last_error
            self._last_error = None
            if err is not None:
                for pool in (self._errored, self._inflight):
                    for r in list(pool.values()):
                        if r.error is err:
                            self._surface_locked(r)
            return err

    def peek_at_last_error(self) -> Optional[BaseException]:
        """The last launch error without clearing it
        (``cudaPeekAtLastError``)."""
        with self._lock:
            return next(iter(self._sticky.values())) if self._sticky else self._last_error

    def release_stream_errors(self, stream: Stream) -> None:
        """Retire every failed request of ``stream`` (the dispatcher half
        of ``stream.reset()``)."""
        with self._lock:
            for pool in (self._inflight, self._errored):
                for seq in list(pool):
                    r = pool[seq]
                    if r.stream is stream and r.error is not None:
                        del pool[seq]
                        self._drop_producers(r)
                        r.surfaced = True
            for r in self._pending.values():
                if r.stream is stream and r.error is not None:
                    r.surfaced = True

    def device_reset(self, device: Any = None) -> "Dispatcher":
        """The ``cudaDeviceReset`` analogue *for this dispatcher's state*:
        with ``device=None`` clear every sticky error, the last-error
        register, every retained failed request and every stream's
        poisoned state; with ``device=`` only that device's sticky state.

        It does not, and cannot, revive a CUDA context in-process: after
        a real CUDA fault (an illegal address, a failed launch) the
        context stays unusable and only a new process recovers the card.
        Nothing here resets the device."""
        if device is not None:
            with self._lock:
                self._sticky.pop(_dev_id(_runtime.resolve_entry(device)), None)
            return self
        with self._lock:
            self._sticky.clear()
            self._last_error = None
            for r in self._errored.values():
                self._drop_producers(r)
                r.surfaced = True
            self._errored.clear()
            for seq in list(self._inflight):
                r = self._inflight[seq]
                if r.error is not None:
                    self._drop_producers(r)
                    r.surfaced = True
                    del self._inflight[seq]
            for r in self._pending.values():
                if r.error is not None:
                    r.surfaced = True
            for s in set(self._tails) | {self.default}:
                s._error = None
        return self

    def _note_sticky_locked(self, device, err: BaseException) -> None:
        """Record a sticky error against its device (``None`` = the
        process-wide CUDA contract).  Caller holds ``_lock``."""
        self._sticky.setdefault(_dev_id(device), err)

    # ---------------- telemetry (per-stage-key live counters) --------------

    @staticmethod
    def _telemetry_key(req: LaunchRequest) -> tuple:
        """One row per distinct (kernel, backend, warp_exec, chunk,
        schedule, geometry, device)."""
        rl = req.rl
        return (
            req.ck.kernel.name,
            rl.backend,
            rl.warp_exec,
            rl.chunk,
            rl.schedule,
            rl.n_resident,
            rl.grid.astuple(),
            rl.block.astuple(),
            _dev_id(req.device),
        )

    def _note_telemetry(self, req: LaunchRequest, dispatch_s: float) -> None:
        """Record one issued launch against its stage-key row, with its
        cost estimate (``costmodel.estimate``, cached per launch shape:
        'static' by default, ``COX_COSTMODEL=xla`` the counted launch,
        run on the launch's own stream).  A launch the counting pass
        refuses degrades to the static record; a CUDA error is not
        caught."""
        ctx = torch.cuda.stream(req.tstream) if req.tstream is not None else contextlib.nullcontext()
        with ctx:
            est = _costmodel.estimate_request(req)
        key = self._telemetry_key(req)
        with self._lock:
            rec = self._telemetry.get(key)
            if rec is None:
                rec = self._telemetry[key] = {
                    "launches": 0,
                    "dispatch_s": 0.0,
                    "bytes": 0.0,
                    "flops": 0.0,
                    "op_estimate": 0.0,
                    "mem_estimate": 0.0,
                    "estimate_source": None,
                    "chunk_source": req.rl.chunk_source,
                    "schedule_source": req.rl.schedule_source,
                    "measured_s": 0.0,
                    "measured_launches": 0,
                }
                while len(self._telemetry) > TELEMETRY_MAX:
                    self._telemetry.popitem(last=False)
            else:
                self._telemetry.move_to_end(key)
            rec["launches"] += 1
            rec["dispatch_s"] += dispatch_s
            rec["op_estimate"] = est.op_estimate
            rec["mem_estimate"] = est.mem_estimate
            rec["estimate_source"] = est.source
            rec["bytes"] += est.mem_estimate
            rec["flops"] += est.op_estimate

    def note_measurement(self, req: LaunchRequest, seconds: float, launches: int = 1) -> None:
        """Attach measured time to a request's stage-key row."""
        key = self._telemetry_key(req)
        with self._lock:
            rec = self._telemetry.get(key)
            if rec is None:
                return
            rec["measured_s"] += float(seconds)
            rec["measured_launches"] += int(launches)

    def telemetry(self) -> List[Dict[str, Any]]:
        """The per-stage-key counter rows, with achieved GFLOPS and GB/s
        where a measured time is known (else over the host issue time, a
        lower bound)."""
        with self._lock:
            rows = [(k, dict(v)) for k, v in self._telemetry.items()]
        out: List[Dict[str, Any]] = []
        for (name, backend, warp_exec, chunk, schedule, n_resident, grid, block, dev), rec in rows:
            rec.update(
                kernel=name,
                backend=backend,
                warp_exec=warp_exec,
                chunk=chunk,
                schedule=schedule,
                n_resident=n_resident,
                grid=grid,
                block=block,
                device=dev,
            )
            n = max(1, rec["launches"])
            if rec["measured_launches"] > 0 and rec["measured_s"] > 0:
                per = rec["measured_s"] / rec["measured_launches"]
                rec["time_basis"] = "measured"
            elif rec["dispatch_s"] > 0:
                per = rec["dispatch_s"] / n
                rec["time_basis"] = "dispatch"
            else:
                per = 0.0
                rec["time_basis"] = "none"
            rec["s_per_launch"] = per
            rec["gflops"] = (rec["op_estimate"] / per / 1e9) if per else 0.0
            rec["gbps"] = (rec["mem_estimate"] / per / 1e9) if per else 0.0
            out.append(rec)
        return out

    def health(self) -> Dict[str, Any]:
        """Counters for monitoring a long-lived dispatcher: what the
        serving layer prints and the chaos drill asserts on, with the
        knob tuner's counters (``autotune``)."""
        with self._lock:
            first_sticky = repr(next(iter(self._sticky.values()))) if self._sticky else None
            schedules: Dict[str, int] = {}
            for k in self._telemetry:  # k[4] is the schedule
                schedules[k[4]] = schedules.get(k[4], 0) + 1
            return {
                "failures": self.failures,
                "retries": self.retries,
                "degradations": self.degradations,
                "timeouts": self.timeouts,
                "errored_retained": len(self._errored),
                "inflight": len(self._inflight),
                "pending": len(self._pending),
                "sticky": first_sticky,
                "sticky_devices": {
                    ("unplaced" if k is None else k): repr(v) for k, v in self._sticky.items()
                },
                "devices": {k: dict(v) for k, v in self._dev_counters.items()},
                "watchdog_strikes": self.watchdog.strikes if self.watchdog else 0,
                "telemetry_keys": len(self._telemetry),
                "schedules": schedules,
                "dispatch_s": sum(r["dispatch_s"] for r in self._telemetry.values()),
                "bytes": sum(r["bytes"] for r in self._telemetry.values()),
                "autotune": _autotune_stats(),
            }


def _autotune_stats() -> Dict[str, int]:
    """The knob tuner's counters (a lazy import: health probes do not
    pay for the tuner eagerly)."""
    from . import autotune as _autotune

    return _autotune.stats()


# ---------------------------------------------------------------------------
# module singletons: the process-wide dispatcher and its default stream
# ---------------------------------------------------------------------------

_DISPATCHER = Dispatcher()
default_stream = _DISPATCHER.default


def get_dispatcher() -> Dispatcher:
    return _DISPATCHER


def synchronize() -> None:
    """Device-wide barrier over the default dispatcher."""
    _DISPATCHER.sync_all()


def get_last_error() -> Optional[BaseException]:
    """Return-and-clear the default dispatcher's last launch error, the
    ``cudaGetLastError`` analogue (sticky errors are never cleared)."""
    return _DISPATCHER.get_last_error()


def peek_at_last_error() -> Optional[BaseException]:
    """The default dispatcher's last launch error, not cleared."""
    return _DISPATCHER.peek_at_last_error()


def device_reset(device: Any = None) -> Dispatcher:
    """Clear sticky/poisoned error state on the default dispatcher (see
    :meth:`Dispatcher.device_reset`: the dispatcher's state only, never
    the CUDA context)."""
    return _DISPATCHER.device_reset(device)
