"""Functional parameter declarations and their initialisation (port of
``src/repro/models/params.py``).

Every parameter is declared as a :class:`ParamSpec` (shape, dtype, init
rule); a model's parameters are a nested dict of them, and
:func:`init_params` turns that tree into a nested dict of tensors on one
device.  The logical sharding axes and ``AxisRules`` of the reference are
not ported (ROADMAP A.10): the port runs on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to the leaves of nested dicts (and the matching leaves
    of ``rest``, trees of the same structure); returns the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys in sorted order (as
    ``jax.tree_util.tree_leaves`` orders a dict's)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_params(spec_tree, generator: torch.Generator, device) -> Any:
    """Tensors for every spec, on ``device``.

    ``normal`` leaves draw from N(0, 1) in f32 and are scaled by
    ``scale / sqrt(fan_in)`` with fan_in = ``shape[-2]`` (``shape[-1]``
    for a vector), as the reference does, then cast to the spec's dtype.
    ``generator`` must live on ``device``.  A stacked leaf is drawn one
    slice of its first axis at a time, so the f32 draw never needs more
    than one layer's worth of memory."""
    device = torch.device(device)

    def init(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        parts = out if len(spec.shape) >= 3 else [out]
        for part in parts:
            draw = torch.randn(
                part.shape, generator=generator, dtype=torch.float32, device=device
            )
            part.copy_(draw * std)
        return out

    return tree_map(init, spec_tree)
