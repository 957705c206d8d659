# fmt: off
"""Deterministic fault injection for the dispatch layer.

Chaos testing for a launch stack needs *deterministic* faults: a test
(or a drill against a live serving process) declares exactly which
launch fails, where in its lifecycle, and with what error — then
asserts the blast radius.  This module is the injection surface the
dispatcher (``repro.core.streams``), the graph replayer
(``repro.core.graphs``), and the chaos suite
(``tests/test_fault_tolerance.py``) share:

    with cox.faults.inject("my_kernel", site="stage",
                           transient=True, times=2):
        kern.launch(...)        # first two stage attempts fail,
                                # the bounded retry clears it

Faults are keyed by **kernel name** (or graph name for replay-site
faults), **launch index** (the Nth matching consult), and **site**:

* ``stage``         — raised while staging (trace/compile) the launch;
* ``dispatch``      — raised while calling the staged executable (for a
  graph name: while calling the fused replay executable);
* ``timeout``       — the launch "hangs": its outputs never report
  ready, so the dispatcher's per-launch deadline fires
  :class:`~repro.core.errors.CoxTimeoutError` at its sync;
* ``sticky-device`` — raises a sticky
  :class:`~repro.core.errors.CoxDeviceError`, poisoning the dispatcher
  until ``cox.device_reset()``.

Specs are consulted (``consume``) once per attempt, so ``times=N``
composes with the retry/degradation ladder: a ``times=1`` stage fault
fails the first rung and lets the fallback rung succeed; a transient
``times=2`` fault is cleared by the second retry.  Registration is
process-global and thread-safe; the ``inject`` context manager removes
its spec on exit, so no fault outlives its ``with`` block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, Optional, Union

from . import errors as _errors

SITES = ("stage", "dispatch", "timeout", "sticky-device")


@dataclasses.dataclass
class FaultSpec:
    """One armed fault.  ``kernel=None`` matches every name; ``index``
    selects the Nth matching consult (0-based, ``None`` = every);
    ``times`` caps how often it fires (``None`` = unlimited);
    ``error`` overrides the default error (an exception instance used
    as a prototype, or a zero-arg factory)."""

    kernel: Optional[str] = None
    site: str = "dispatch"
    index: Optional[int] = None
    times: Optional[int] = 1
    error: Union[BaseException, Callable[[], BaseException], None] = None
    transient: bool = False
    # bookkeeping
    seen: int = 0
    fired: int = 0
    hits: List[str] = dataclasses.field(default_factory=list)

    def make_error(self, name: str) -> BaseException:
        if callable(self.error):
            return self.error()
        if self.error is not None:
            return self.error
        if self.site == "sticky-device":
            return _errors.CoxDeviceError(
                f"injected sticky device fault at '{name}'")
        if self.site == "timeout":
            return _errors.CoxTimeoutError(
                f"injected hang at '{name}'")
        cls = (_errors.CoxCompileError if self.site == "stage"
               else _errors.CoxLaunchError)
        return cls(f"injected {self.site} fault at '{name}'",
                   transient=self.transient)


_lock = threading.Lock()
_active: List[FaultSpec] = []


def _register(spec: FaultSpec) -> FaultSpec:
    if spec.site not in SITES:
        raise ValueError(f"unknown fault site {spec.site!r}; "
                         f"sites: {SITES}")
    with _lock:
        _active.append(spec)
    return spec


def _unregister(spec: FaultSpec) -> None:
    with _lock:
        try:
            _active.remove(spec)
        except ValueError:
            pass


@contextlib.contextmanager
def inject(kernel: Optional[str] = None, *, site: str = "dispatch",
           index: Optional[int] = None, times: Optional[int] = 1,
           error: Union[BaseException, Callable[[], BaseException],
                        None] = None,
           transient: bool = False):
    """Arm a fault for the duration of the ``with`` block and yield the
    :class:`FaultSpec` (inspect ``spec.fired`` / ``spec.hits`` in
    assertions)."""
    spec = FaultSpec(kernel=kernel, site=site, index=index, times=times,
                     error=error, transient=transient)
    _register(spec)
    try:
        yield spec
    finally:
        _unregister(spec)


def consume(site: str, name: str) -> Optional[BaseException]:
    """Consult the armed faults for one attempt at ``site`` on
    ``name``; returns the error to apply (raise, or for the
    ``timeout`` site: treat the launch as hung), or ``None``.  Each
    matching consult advances the spec's ``seen`` counter so
    ``index``/``times`` stay deterministic under retries."""
    with _lock:
        for spec in _active:
            if spec.site != site:
                continue
            if spec.kernel is not None and spec.kernel != name:
                continue
            idx, spec.seen = spec.seen, spec.seen + 1
            if spec.index is not None and idx != spec.index:
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            spec.fired += 1
            spec.hits.append(f"{site}:{name}#{idx}")
            return spec.make_error(name)
    return None


def active() -> List[FaultSpec]:
    """Snapshot of the armed faults (for diagnostics)."""
    with _lock:
        return list(_active)
