"""The port's span recorder: named spans around the parts of the train
step, in the profiler's trace and, for those a benchmark metric reads,
timed on the device.

``with obs.span("train.forward"):`` is off unless a torch profiler is
running or a :func:`recording` context turns spans on.  An off span checks
the profiler's flag and this module's, and does nothing else.  An on span
opens ``record_function("repro_torch.<name>")`` while a profiler runs, so
the span sits in the profiler's trace beside the kernels it launched.
That is all, unless its name is in :data:`TIMED`: such a span is also
recorded here, with its parent span, the step id (:func:`next_step`),
the host clock at entry and exit, a CUDA timing-event pair on the
current stream, for a name in :data:`MEMORY` the device's allocated
bytes at entry and exit (host reads, no sync), and the counters that
:func:`count` adds to it while it is open (numbers, or device tensors
left on the device until :func:`summary`).

Nothing syncs while spans are recorded: :func:`summary` syncs once and
resolves each event pair.  The events are a stopgap: the profiler's
trace holds the same times, as the kernels each span launched (a span's
copy on the trace's device timeline runs from the first to the last
kernel launched in it outside any inner span).  Once the benchmark's
trace reduction reads the ``repro_torch.*`` spans, the events go,
leaving the ``record_function`` and the memory read.

A span's step is the step id when it closes: ``steps.loss_and_grads``
calls :func:`next_step` first, so a step's forward, backward and update
share one id.  The parent is the innermost timed span open on the same
thread.  On a thread with none open (the autograd engine's, which runs
the backward of CUDA tensors and with it ``torch.utils.checkpoint``'s
recompute) it is the innermost open ``train.backward``.  Every timed span
opened while a ``train.backward`` is open carries ``recompute=True``:
under remat the model's forward runs again there.  One backward at a time
is assumed.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "repro_torch."
BACKWARD = "train.backward"
# The spans the benchmark's metrics read (portbench/metrics/): forward_ms,
# backward_ms, recompute_ms, adamw_roofline and, with the memory,
# activations_kept_gib; mamba_ms, moe_ms and, with its counters ``rows``
# and ``max_rows``, moe_experts_roofline.  A family opens those of its
# layers only.  The other spans cost only their record_function.
TIMED = frozenset(
    {"train.forward", BACKWARD, "model.block", "adamw.update", "model.mamba", "model.moe", "moe.experts"}
)
MEMORY = frozenset({"train.forward"})
# Steps kept: the newest ones, since a profiler window is a few steps (the
# benchmark's traced run profiles 3).  A step of a 52-layer model under
# remat holds 107 timed spans, each with two CUDA events (handles of the
# CUDA runtime); a bound in steps keeps them under a thousand however long
# spans stay on.
MAX_STEPS = 8

_profiler_enabled = torch._C._autograd._profiler_enabled
_mode: Optional[bool] = None  # recording(): on, off, or None (on while a profiler runs)
_step = 0
_ids = itertools.count()
_local = threading.local()
_backward: Optional["_Span"] = None
_lock = threading.Lock()
_steps: "collections.OrderedDict[int, List[_Span]]" = collections.OrderedDict()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording(on: bool = True):
    """Spans on (or, with ``on=False``, off even while a profiler runs)
    inside the context."""
    global _mode
    before, _mode = _mode, on
    try:
        yield
    finally:
        _mode = before


def next_step() -> int:
    """Start a new step id (cheap whether spans are on or not)."""
    global _step
    _step += 1
    return _step


def reset() -> None:
    """Drop every recorded span and start the step ids again."""
    global _step
    with _lock:
        _steps.clear()
        _step = 0


def span(name: str, **attrs):
    """A context manager for the span ``name``: recorded with ``attrs``
    if the name is in :data:`TIMED`, a ``record_function`` alone under a
    profiler otherwise, while spans are on; a shared no-op while off."""
    if _mode is None:
        if not _profiler_enabled():
            return _OFF
    elif not _mode:
        return _OFF
    if name in TIMED:
        return _Span(name, attrs)
    return torch.profiler.record_function(PREFIX + name) if _profiler_enabled() else _OFF


def recording_now() -> bool:
    """Whether a span opened now would be on."""
    return _profiler_enabled() if _mode is None else _mode


def count(**values) -> None:
    """Add ``values`` (numbers, or 0-dim tensors left where they are
    until :func:`summary` resolves them) to the counters of the innermost
    timed span open on this thread, summing into those it has; nothing
    when no timed span is open (spans off)."""
    stack = _stack()
    if not stack:
        return
    counters = stack[-1].counters
    for k, v in values.items():
        counters[k] = counters[k] + v if k in counters else v


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = (
        "name", "attrs", "id", "parent", "step", "t0", "t1", "dev", "ev0", "ev1",
        "mem0", "mem1", "counters", "_rf", "_outer_backward",
    )

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.id, self.counters = name, attrs, next(_ids), {}
        self.ev0 = self.ev1 = self.mem0 = self.mem1 = self.dev = self._rf = None

    def __enter__(self):
        global _backward
        stack = _stack()
        self.parent = stack[-1] if stack else _backward
        if _backward is not None:
            self.attrs["recompute"] = True
        self._outer_backward = _backward
        if self.name == BACKWARD:
            _backward = self
        stack.append(self)
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        if torch.cuda.is_initialized():
            self.dev = torch.cuda.current_device()
            if self.name in MEMORY:
                self.mem0 = _allocated(self.dev)
            self.ev0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _backward
        self.t1 = time.perf_counter_ns()
        if self.dev is not None:
            self.ev1 = _event()
            if self.name in MEMORY:
                self.mem1 = _allocated(self.dev)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().pop()
        if self.name == BACKWARD:
            _backward = self._outer_backward
        self.step = _step
        with _lock:
            _steps.setdefault(self.step, []).append(self)
            while len(_steps) > MAX_STEPS:
                _steps.popitem(last=False)
        return False


def _allocated(dev: int) -> int:
    """``torch.cuda.memory_allocated(dev)`` without its flattening of every
    allocator statistic into a new dict (116 us a call on an H100 host,
    against 16 for the nested dict)."""
    return torch.cuda.memory_stats_as_nested_dict(dev)["allocated_bytes"]["all"]["current"]


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def summary(last_steps: Optional[int] = None) -> Dict[int, List[dict]]:
    """The recorded (timed) spans of the newest ``last_steps`` steps (all
    that are kept, by default), ``{step id: [span, ...]}`` in step order,
    each step's spans in the order they opened.  A span is a dict:
    ``name``, ``attrs``, ``id``, ``parent`` (the parent's id, or None),
    ``step``, ``host_ms``, ``counters`` (:func:`count`'s, as numbers),
    and, for spans recorded on a CUDA device, ``device_ms`` and (names in
    :data:`MEMORY`) ``mem_delta``, bytes allocated at exit less at entry;
    these are None otherwise.  Syncs each device the spans ran on, once."""
    with _lock:
        steps = list(_steps.items())
    if last_steps is not None:
        steps = steps[-last_steps:] if last_steps > 0 else []
    spans = [s for _, group in steps for s in group]
    for dev in sorted({s.dev for s in spans if s.dev is not None}):
        torch.cuda.synchronize(dev)
    counted = dict(zip(map(id, spans), _resolve([s.counters for s in spans])))
    out = {}
    for step, group in steps:
        out[step] = [
            {
                "name": s.name,
                "attrs": dict(s.attrs),
                "id": s.id,
                "parent": None if s.parent is None else s.parent.id,
                "step": step,
                "host_ms": (s.t1 - s.t0) / 1e6,
                "device_ms": None if s.dev is None else s.ev0.elapsed_time(s.ev1),
                "mem_delta": None if s.mem0 is None else s.mem1 - s.mem0,
                "counters": counted[id(s)],
            }
            for s in sorted(group, key=lambda s: s.t0)
        ]
    return out


def _resolve(counters: List[dict]) -> List[dict]:
    """Each dict of counters with its tensors read back as numbers, one
    copy a device for all of them (ints stay ints)."""
    tensors = [v for c in counters for v in c.values() if torch.is_tensor(v)]
    values = {}
    for dev in {t.device for t in tensors}:
        mine = [t for t in tensors if t.device == dev]
        read = torch.stack([t.reshape(()).to(torch.float64) for t in mine]).tolist()
        for t, x in zip(mine, read):
            values[id(t)] = int(x) if not (t.is_floating_point() or t.is_complex()) else x
    return [{k: values[id(v)] if torch.is_tensor(v) else v for k, v in c.items()} for c in counters]
