"""Grid-execution backends for the COX launcher.

A backend turns a :class:`~repro_torch.core.backends.plan.LaunchPlan`
into ``run(globals_, scalars, device) -> globals_`` via ``build_fn``.  The port
has the loop-carried ``scan`` backend; the block-parallel ``vmap`` and
the multi-device ``sharded`` backends are ROADMAP queue items A.5 and
A.10.
"""

from __future__ import annotations

from . import scan
from .plan import LaunchPlan  # noqa: F401

BACKENDS = {scan.name: scan}


def available_backends():
    return tuple(BACKENDS)


def get_backend(name: str):
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown launch backend {name!r}; available: {sorted(BACKENDS)}"
        ) from None
