"""Stream -> device placement policies (port of the reference's
``placement.py``).

The dispatcher (``streams.Dispatcher(devices=..., placement=...)``)
places each non-default stream on one device of its pool, the first
time the stream's work is dispatched, and the stream keeps it (device
affinity) until the device is poisoned by a sticky
:class:`~errors.CoxDeviceError`; then the policy re-picks among the
healthy devices.  The default stream (CUDA's current device), mesh
(sharded) launches and a one-device pool keep ``device=None``: the
legacy path, no placement.

A pool's entries are torch devices or the logical devices of
``launch.mesh.device_pool(n, logical=True)``, several to one card; a
policy sees the pool entries and keys the health counters on them
(``str(entry)``).

Policies:

* :class:`RoundRobinPlacement` -- deal streams over the pool in arrival
  order; the default.
* :class:`AffinityPlacement` -- prefer the device the request's input
  tensors already live on, falling back to round-robin.
* :class:`HealthAwarePlacement` -- prefer the device with the cleanest
  per-device health counters (fewest failures + degradations),
  round-robin among ties.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional

import torch

from .runtime import physical


def resident_device(val) -> Optional[Any]:
    """The device a tensor lives on, else None (numpy data and Python
    values live on the host and carry no affinity)."""
    if isinstance(val, torch.Tensor):
        return val.device
    return None


class PlacementPolicy:
    """Base policy: stream affinity + a pluggable ``pick``.

    ``place(req, devices, disp)`` is the dispatcher's entry point:
    ``devices`` is the current *healthy* pool.  A stream that already
    holds a healthy device keeps it; otherwise ``pick`` chooses and the
    stream records the choice.  Subclasses implement :meth:`pick`."""

    name = "policy"

    def place(self, req, devices: List[Any], disp) -> Any:
        stream = getattr(req, "stream", None)
        if stream is not None:
            held = stream._device
            if held is not None and any(d == held for d in devices):
                return held
            dev = self.pick(req, devices, disp)
            stream._device = dev
            return dev
        return self.pick(req, devices, disp)

    def pick(self, req, devices: List[Any], disp) -> Any:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class RoundRobinPlacement(PlacementPolicy):
    """Deal streams over the healthy pool in arrival order."""

    name = "round-robin"

    def __init__(self):
        self._counter = itertools.count()

    def pick(self, req, devices, disp):
        return devices[next(self._counter) % len(devices)]


class AffinityPlacement(PlacementPolicy):
    """Prefer the device where most of the request's input tensors
    already live, so a stream relaunching over a previous launch's
    outputs lands where they are instead of paying a copy (the first
    pool entry on that physical device)."""

    name = "affinity"

    def __init__(self):
        self._fallback = RoundRobinPlacement()

    def pick(self, req, devices, disp):
        votes = {}
        for val in (req.globals_ or {}).values():
            dev = resident_device(val)
            if dev is not None:
                votes[dev] = votes.get(dev, 0) + 1
        if votes:
            best = max(votes, key=votes.get)
            for d in devices:
                if physical(d) == best:
                    return d
        return self._fallback.pick(req, devices, disp)


class HealthAwarePlacement(PlacementPolicy):
    """Prefer the device with the cleanest per-device health counters:
    fewest ``failures + degradations``, ties broken round-robin so clean
    devices still share load."""

    name = "health-aware"

    def __init__(self):
        self._counter = itertools.count()

    def pick(self, req, devices, disp):
        stats = disp.device_health()

        def load(dev):
            c = stats.get(str(dev), {})
            return c.get("failures", 0) + c.get("degradations", 0)

        best = min(load(d) for d in devices)
        clean = [d for d in devices if load(d) == best]
        return clean[next(self._counter) % len(clean)]
