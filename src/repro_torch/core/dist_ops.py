"""Which aten ops are collectives, and how many bytes each one yields.

Shared by the two counters that run under a ``TorchDispatchMode``: the
counted cost of a launch (``core/costmodel.py``, where a sharded launch's
merges are ``all_gather``s) and the counted cost of a model step
(``launch/hlo_analysis.py``).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# substrings of a collective op's name -> the reference's kind
_KINDS = (
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
)


def collective_kind(func) -> str:
    """The kind of a collective op (``""`` for any other op)."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return ""
    name = func.__name__
    for key, kind in _KINDS:
        if key in name:
            return kind
    return ""


def nbytes(tree) -> int:
    """The bytes of every tensor in a pytree."""
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def result_bytes(func, args, out) -> int:
    """A collective's result bytes: the in-place ``c10d`` ops write their
    first argument, the functional ones return their result."""
    return nbytes(args[0] if func.namespace == "c10d" else out)
