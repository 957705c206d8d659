"""The program's own record of its spans in a traced run: the second
module of the harness that imports the program (``src/repro_torch``).

``steps(run)`` reads ``repro_torch.obs.summary(last_steps=n)``, ``n`` the
run's traced steps: spans record only while a profiler runs, so the
buffer's newest steps are the traced ones.  It returns a list of steps,
each a list of spans as ``obs.summary`` gives them, or None where there
is nothing to read: a run not traced, a program without
``repro_torch.obs``, or spans without device times (a run on the CPU).
"""

from __future__ import annotations

import importlib
import sys

from . import program

OBS = "repro_torch.obs"


def steps(run):
    if run.trace is None or not run.trace.n_steps():
        return None
    if str(program.SRC) not in sys.path:
        sys.path.insert(0, str(program.SRC))
    try:
        obs = importlib.import_module(OBS)
    except ModuleNotFoundError as e:
        if e.name != OBS:  # a module the recorder imports is missing: a broken program
            raise
        return None
    found = list(obs.summary(last_steps=run.trace.n_steps()).values())
    spans = [s for step in found for s in step]
    if not spans or any(s["device_ms"] is None for s in spans):
        return None
    return found


def per_step(run, name: str, key: str = "device_ms", **attrs):
    """The mean over the traced steps of the sum of ``key`` over the spans
    named ``name`` whose attributes include ``attrs``; None where there is
    nothing to read or no step holds such a span."""
    found = steps(run)
    if not found:
        return None
    match = [[s[key] for s in step if s["name"] == name and _has(s["attrs"], attrs)] for step in found]
    if not any(match):
        return None
    return sum(map(sum, match)) / len(match)


def _has(attrs: dict, wanted: dict) -> bool:
    return all(attrs.get(k) == v for k, v in wanted.items())
