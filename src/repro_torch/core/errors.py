# fmt: off
"""CUDA-faithful error model: the typed ``CoxError`` hierarchy.

CUDA ships a precise error contract that GPU-to-CPU frameworks
(CuPBoP, Polygeist's transpiler) inherit for free from the driver; a
pure-JAX substrate has to reproduce it deliberately.  The pieces:

* **Typed errors.**  Every failure the dispatch layer records is one of
  a small hierarchy rooted at :class:`CoxError`:
  :class:`CoxCompileError` (staging/trace/compile — CUDA's
  ``cudaErrorInvalidKernelImage`` class), :class:`CoxLaunchError`
  (dispatch/execution — ``cudaErrorLaunchFailure`` class),
  :class:`CoxTimeoutError` (per-launch deadline exceeded at sync —
  ``cudaErrorLaunchTimeout``), :class:`CoxDependencyError` (a DAG
  descendant of a failed launch, failed fast instead of dispatched on
  stale inputs — CUDA has no direct analogue because a poisoned stream
  simply never runs the dependents), and the **sticky**
  :class:`CoxDeviceError` (device/context corruption —
  ``cudaErrorIllegalAddress`` class: unrecoverable without a device
  reset).

* **Sticky vs. non-sticky.**  CUDA distinguishes errors that leave the
  context usable (non-sticky: cleared by ``cudaGetLastError``) from
  those that poison every subsequent call until ``cudaDeviceReset``
  (sticky).  Here :func:`is_sticky` keys the split; the dispatcher
  (``repro.core.streams``) poisons all enqueues after a sticky error
  and only :func:`~repro.core.streams.device_reset` clears it.

* **Transient errors.**  Resource-pressure failures worth a bounded
  retry-with-backoff (allocation pressure, injected transient faults)
  are flagged via :func:`is_transient`; everything else fails over to
  the graceful-degradation ladder or surfaces.

Pre-existing exception types stay meaningful: :class:`~repro.core.
types.CoxUnsupported` / :class:`~repro.core.types.CoxTypeError` are
*user* errors (bad kernel / bad knobs) — :func:`classify` passes them
through unchanged so call sites keep their historical exception types,
and wraps only foreign exceptions (XLA runtime errors, ``ValueError``
from a trace) into the typed hierarchy.
"""
from __future__ import annotations

from typing import Optional

from .types import CoxTypeError, CoxUnsupported


class CoxError(Exception):
    """Base of the typed launch-error hierarchy.

    ``sticky`` — the error poisons the whole dispatcher (device) until
    a reset; ``transient`` — the error is worth a bounded retry."""

    sticky = False
    transient = False

    def __init__(self, *args, transient: Optional[bool] = None):
        super().__init__(*args)
        if transient is not None:
            self.transient = transient


class CoxCompileError(CoxError):
    """Staging failed: the launch could not be traced/compiled."""


class CoxLaunchError(CoxError):
    """Dispatch/execution failed: the staged executable raised."""


class CoxTimeoutError(CoxError):
    """The launch exceeded its deadline (detected at its sync) —
    ``cudaErrorLaunchTimeout``.  Non-sticky here: the deadline is a
    host-side watchdog, not device corruption; the launch's stream is
    poisoned and its DAG descendants fail fast, but the device (the
    dispatcher) stays usable."""


class CoxDependencyError(CoxError):
    """A DAG descendant of a failed launch, failed fast instead of
    dispatched on stale inputs.  ``root`` is the originating error."""

    def __init__(self, *args, root: Optional[BaseException] = None):
        super().__init__(*args)
        self.root = root


class CoxDeviceError(CoxError):
    """Sticky device/context corruption — every subsequent enqueue
    fails with this error until ``cox.device_reset()``."""

    sticky = True


def is_sticky(e: BaseException) -> bool:
    return bool(getattr(e, "sticky", False))


# substrings that mark a foreign exception as resource pressure worth a
# retry (jaxlib surfaces allocation failures with these status tags)
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OOM")


def is_transient(e: BaseException) -> bool:
    """True for errors a bounded retry-with-backoff may clear."""
    if getattr(e, "transient", False):
        return True
    msg = str(e)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def root_of(e: BaseException) -> BaseException:
    """The originating failure behind a (possibly chained) dependency
    error — so a descendant-of-a-descendant still names the root."""
    while isinstance(e, CoxDependencyError) and e.root is not None:
        e = e.root
    return e


def classify(e: BaseException, *, site: str,
             what: str = "") -> BaseException:
    """Map an exception to its typed surface form.

    Cox-typed errors (the hierarchy above plus the user-error types
    ``CoxUnsupported``/``CoxTypeError``) pass through unchanged —
    call sites keep their historical exception types.  Foreign
    exceptions wrap into :class:`CoxCompileError` (``site='stage'``)
    or :class:`CoxLaunchError` (any other site), chained via
    ``__cause__`` so the original traceback survives."""
    if isinstance(e, (CoxError, CoxUnsupported, CoxTypeError)):
        return e
    cls = CoxCompileError if site == "stage" else CoxLaunchError
    prefix = f"{what}: " if what else ""
    wrapped = cls(f"{prefix}{site} failed: {type(e).__name__}: {e}")
    wrapped.__cause__ = e
    return wrapped
