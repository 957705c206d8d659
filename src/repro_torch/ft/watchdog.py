"""Fault-tolerance machinery (a copy of ``src/repro/ft/watchdog.py``,
which is pure Python: the port keeps its own, so that it imports nothing
of the JAX package).

* ``StepWatchdog`` — per-step deadline detection (straggler/hang): if a
  step exceeds ``deadline_s``, the registered callback fires (on a real
  cluster: re-dispatch the step's grid chunk / evict the slow host; here:
  record + raise after ``max_strikes``).
* ``FailureInjector`` — deterministic fault injection for tests and
  drills (fail at step N with an exception, or corrupt a device buffer).
* ``retry_loop`` — run a step function with restart-from-checkpoint
  semantics: on failure, reload the latest checkpoint and continue; the
  deterministic data pipeline guarantees no sample is skipped/replayed.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class StepWatchdog:
    """Arm with :meth:`start` before a step, disarm with :meth:`stop`
    after it; a step that outlives ``deadline_s`` is a *strike* (the
    timer fires, the event is recorded, ``on_straggler`` runs).  A
    generation counter makes the lifecycle safe against the three
    classic timer races: ``start()`` while armed cancels the leaked
    prior timer, a healthy ``stop()`` resets the strike count (only
    *consecutive* stragglers accumulate toward ``max_strikes``), and a
    ``_fire`` racing a concurrent ``stop()`` observes a stale
    generation and does nothing (no fire-after-cancel)."""

    def __init__(self, deadline_s: float, on_straggler: Optional[Callable] = None,
                 max_strikes: int = 3):
        self.deadline_s = deadline_s
        self.on_straggler = on_straggler
        self.max_strikes = max_strikes
        self.strikes = 0
        self.events: list = []
        self._timer: Optional[threading.Timer] = None
        self._step = -1
        self._lock = threading.Lock()
        self._gen = 0        # bumped by every start()/stop()
        self._fired_gen = -1  # generation whose timer fired

    def start(self, step: int):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()     # re-arm: drop the leaked timer
            self._gen += 1
            self._step = step
            timer = threading.Timer(self.deadline_s, self._fire,
                                    args=(self._gen,))
            timer.daemon = True
            self._timer = timer
        timer.start()

    def _fire(self, gen: int):
        with self._lock:
            if gen != self._gen:         # lost the race to stop()/start()
                return
            self._fired_gen = gen
            self.strikes += 1
            self.events.append({"step": self._step, "time": time.time(),
                                "strikes": self.strikes})
            cb, step, strikes = self.on_straggler, self._step, self.strikes
        if cb:                           # callback outside the lock
            cb(step, strikes)

    @property
    def fired(self) -> bool:
        """True once the *currently armed* step's deadline expired."""
        with self._lock:
            return self._fired_gen == self._gen

    def stop(self):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            healthy = self._fired_gen != self._gen
            self._gen += 1               # invalidate any in-flight _fire
            if healthy:
                self.strikes = 0         # a healthy step clears the count

    def check(self):
        if self.strikes >= self.max_strikes:
            raise TimeoutError(
                f"{self.strikes} straggler strikes (deadline "
                f"{self.deadline_s}s) — evicting this worker for restart")


class FailureInjector:
    """Deterministic failures for drills: fail_at={step: exception}."""

    def __init__(self, fail_at: Optional[Dict[int, Exception]] = None):
        self.fail_at = dict(fail_at or {})
        self.fired: set = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.fail_at[step]


def retry_loop(run_from: Callable[[int], int], *, ckpt_mgr,
               max_restarts: int = 3) -> int:
    """``run_from(start_step) -> final_step`` with restart-on-failure.
    Each restart resumes from the latest durable checkpoint."""
    restarts = 0
    start = (ckpt_mgr.latest_step() or -1) + 1
    while True:
        try:
            return run_from(start)
        except (RuntimeError, TimeoutError, ValueError) as e:  # worker fault
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt_mgr.wait()
            latest = ckpt_mgr.latest_step()
            start = (latest or -1) + 1 if latest is not None else 0
            print(f"[ft] restart {restarts}/{max_restarts} after "
                  f"{type(e).__name__}: resuming from step {start}",
                  flush=True)
