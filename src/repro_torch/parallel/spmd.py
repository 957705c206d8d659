"""The port's counterpart of ``shard_map`` and ``with_sharding_constraint``:
local functions over DTensor shards, and activation placements from the
logical-axis rules.

Parameters, activations, gradients, moments and caches on a mesh are
``torch.distributed.tensor.DTensor``s.  Matrix products and elementwise
work on whole layers run as plain torch on each rank's shards inside
:func:`local_call`, with the in- and out-placements written out by the
caller, because the CUDA kernels are ``ctypes`` calls through which
DTensor cannot propagate a sharding; every move of data between layouts
is an explicit ``redistribute`` (:func:`constrain`), so nothing is
gathered in silence.  ``to_local``, ``from_local`` and ``redistribute``
are autograd-aware, and :func:`local_call` gives each input's gradient
its true placement: ``Partial`` over a mesh dimension on which the input
is replicated while another input is sharded (each rank's gradient is
then its slab's contribution), the input's own placement otherwise.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from ..models.params import shard_full  # noqa: F401  (re-exported)


class Sharding(NamedTuple):
    """A mesh and a leaf's placements on it: the reference's
    ``NamedSharding``."""

    mesh: Any
    placements: tuple


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def dim_index(mesh, name: str) -> Optional[int]:
    """The mesh dimension called ``name``, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def axis_size(mesh, name: str) -> int:
    i = dim_index(mesh, name)
    return 1 if i is None else mesh.size(i)


def axis_rank(mesh, name: str) -> int:
    i = dim_index(mesh, name)
    return 0 if i is None else mesh.get_local_rank(i)


def with_axis(placements: Sequence, mesh, name: str, p) -> tuple:
    """``placements`` with mesh axis ``name``'s entry replaced by ``p``
    (unchanged when the mesh has no such axis)."""
    out = list(placements)
    i = dim_index(mesh, name)
    if i is not None:
        out[i] = p
    return tuple(out)


def shift(placements: Sequence, by: int = 1) -> tuple:
    """``placements`` of a tensor that gained ``by`` leading dimensions."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim + by) if p.is_shard() else p for p in placements)


def act_placements(rules, shape, axes) -> tuple:
    """The placements the reference's ``constrain(x, rules, axes)`` gives an
    activation of ``shape``: ``rules.pspec_for`` with its fallbacks."""
    return rules.placements_for(tuple(shape), axes, what="act")


def constrain(x, rules, axes):
    """The reference's ``constrain``: the identity without rules, else
    ``x`` redistributed to the rules' placements for ``axes``."""
    if rules is None:
        return x
    want = act_placements(rules, x.shape, axes)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def to(x, placements: Sequence):
    """``x`` redistributed to ``placements`` (no-op when already there)."""
    placements = tuple(placements)
    return x if tuple(x.placements) == placements else x.redistribute(x.device_mesh, placements)


def rows(x):
    """``x`` with its last dimension whole on every rank (a kernel reads
    whole rows): a shard of it is gathered."""
    from torch.distributed.tensor import Replicate

    last = x.dim() - 1
    return to(x, tuple(Replicate() if p.is_shard() and p.dim == last else p for p in x.placements))


def replicate(x):
    from torch.distributed.tensor import Replicate

    return to(x, (Replicate(),) * x.device_mesh.ndim)


def _grad_placements(mine: tuple, others: Sequence[tuple], split: Sequence[int] = ()) -> tuple:
    from torch.distributed.tensor import Partial

    out = []
    for i, p in enumerate(mine):
        if p.is_replicate() and (i in split or any(o[i].is_shard() for o in others)):
            out.append(Partial())
        else:
            out.append(p)
    return tuple(out)


def local_call(fn: Callable, mesh, args: Sequence, expect: Sequence, out, split: Sequence[str] = ()) -> Any:
    """Run ``fn`` on this rank's shards: the port's ``shard_map``.

    ``args`` are DTensors, nested dicts of them, or plain values passed
    through; ``expect`` gives each DTensor argument's placements (a dict
    of them for a dict argument; None for a plain value).  An argument at
    other placements raises: the caller redistributes first.  ``out``
    gives the placements of ``fn``'s result (a tuple of them for a tuple
    of results); the results are wrapped with ``DTensor.from_local``.
    ``split`` names the mesh axes over which ``fn`` computes only its
    rank's part of the work from replicated inputs (say, its share of the
    heads): every input replicated there gets a ``Partial`` gradient on
    them, even when no input is sharded there."""
    from torch.distributed.tensor import DTensor

    split_dims = [i for i in (dim_index(mesh, a) for a in split) if i is not None]

    flat = []  # (placements) of every DTensor input, for the gradient rule

    def collect(a, e):
        if isinstance(a, dict):
            for k in a:
                collect(a[k], e[k] if isinstance(e, dict) else e)
        elif isinstance(a, DTensor):
            if e is None or tuple(a.placements) != tuple(e):
                raise ValueError(
                    f"local_call: an input at {tuple(a.placements)}, expected {e}; "
                    "redistribute it first"
                )
            if a.device_mesh != mesh:
                raise ValueError("local_call: an input on another mesh")
            flat.append(tuple(a.placements))

    for a, e in zip(args, expect):
        collect(a, e)

    def localize(a):
        if isinstance(a, dict):
            return {k: localize(v) for k, v in a.items()}
        if isinstance(a, DTensor):
            mine = tuple(a.placements)
            others = list(flat)
            others.remove(mine)
            return a.to_local(grad_placements=_grad_placements(mine, others, split_dims))
        return a

    result = fn(*[localize(a) for a in args])

    def wrap(r, p):
        if p is None:
            return r
        return DTensor.from_local(r, mesh, tuple(p), run_check=False)

    if isinstance(result, tuple):
        return tuple(wrap(r, p) for r, p in zip(result, out))
    return wrap(result, out)
