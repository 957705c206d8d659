"""Grid-execution backends for the COX launcher.

A backend turns a :class:`~repro_torch.core.backends.plan.LaunchPlan`
into ``run(globals_, scalars, device) -> globals_`` via ``build_fn``:

* ``scan`` -- the loop-carried baseline: one block after another, in
  place (minimal memory, the grid fully serialized);
* ``vmap`` -- block-parallel: a wave of blocks runs at once as a leading
  copy axis of the executor's tensors, reconciled by the write-mask /
  atomic-delta merge (``merge.py``);
* ``sharded`` -- the grid dealt over a ``DeviceMesh`` axis, the ``vmap``
  executor within each rank, the devices' copies merged across the axis
  (``merge.cross_device_merge``).

``flat.choose_backend`` is the 'auto' heuristic; ``get_backend``
resolves a name to its module.
"""

from __future__ import annotations

from . import block_vmap, scan, sharded
from .plan import LaunchPlan  # noqa: F401

BACKENDS = {scan.name: scan, block_vmap.name: block_vmap, sharded.name: sharded}


def available_backends():
    return tuple(BACKENDS)


def get_backend(name: str):
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown launch backend {name!r}; available: {sorted(BACKENDS)}"
        ) from None
