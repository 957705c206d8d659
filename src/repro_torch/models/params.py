"""Functional parameter declarations, their initialisation, and their
logical-axis sharding (port of ``src/repro/models/params.py``).

Every parameter is declared as a :class:`ParamSpec` (shape, dtype,
logical axes, init rule); a model's parameters are a nested dict of them,
and :func:`init_params` turns that tree into a nested dict of tensors, on
one device or, given a mesh and its :class:`AxisRules`, as
``torch.distributed.tensor.DTensor`` shards.

Logical axes are resolved to mesh axes by :class:`AxisRules` with the
reference's divisible-or-replicate policy: a dimension that does not
divide its mesh axes' extent takes the longest prefix of them that it
divides, or is replicated, and the event is recorded in ``notes``.  The
result is a :class:`PartitionSpec`, a tuple with one entry per tensor
dimension (None, a mesh axis name, or a tuple of names, major first), as
the reference's ``jax.sharding.PartitionSpec``; :func:`placements` maps
it onto DTensor placements, one per mesh dimension.  ``AxisRules`` reads
only the mesh's dimension names and sizes, so it also takes a ``{name:
size}`` mapping in place of a ``DeviceMesh``, and resolves the production
shapes without their ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()  # logical axis names per dim
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape}")


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


def _init_leaf(spec: ParamSpec, generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    parts = out if len(spec.shape) >= 3 else [out]
    for part in parts:
        draw = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=device)
        part.copy_(draw * std)
    return out


def init_params(spec_tree, generator: torch.Generator, device, rules=None) -> Any:
    """Tensors for every spec, on ``device``.

    ``normal`` leaves draw from N(0, 1) in f32 and are scaled by
    ``scale / sqrt(fan_in)`` with fan_in = ``shape[-2]`` (``shape[-1]``
    for a vector), as the reference does, then cast to the spec's dtype.
    ``generator`` must live on ``device``.  A stacked leaf is drawn one
    slice of its first axis at a time, so the f32 draw never needs more
    than one layer's worth of memory.

    With ``rules`` (an :class:`AxisRules` over a ``DeviceMesh``) every
    rank draws each full leaf in the same order and keeps its shard, a
    DTensor at the leaf's placements: the shards are bitwise those of the
    one-device draw."""
    device = torch.device(device)
    if rules is None:
        return tree_map(lambda s: _init_leaf(s, generator, device), spec_tree)

    def sharded(spec: ParamSpec):
        full = _init_leaf(spec, generator, device)
        return shard_full(full, rules.mesh, rules.placements(spec))

    return tree_map(sharded, spec_tree)


# ---------------------------------------------------------------------------
# logical axes -> mesh axes
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (major first).  Equal, as a tuple, to the
    reference's ``jax.sharding.PartitionSpec`` of the same spec."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{name: size}`` of a ``DeviceMesh`` (or of a mapping, as given)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class AxisRules:
    """logical axis -> tuple of mesh axes (in priority order).

    ``strategy`` (a port addition) says which sharded dimensions the layers
    compute on in place: under ``"tp"`` every sharded weight is used as it
    is stored; under ``"fsdp"`` only the experts are, and every other
    weight is gathered at use."""

    rules: Dict[str, Tuple[str, ...]]
    mesh: Any
    notes: List[str] = dataclasses.field(default_factory=list)
    strategy: str = "tp"

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    def mesh_size(self, names: Tuple[str, ...]) -> int:
        n = 1
        shape = self.shape
        for m in names:
            n *= shape[m]
        return n

    def partition_spec(self, spec: ParamSpec) -> PartitionSpec:
        return self.pspec_for(spec.shape, spec.axes, what=str(spec.shape))

    def pspec_for(self, shape, axes, what: str = "") -> PartitionSpec:
        entries: List[Any] = []
        used: set = set()
        mshape = self.shape
        for dim, ax in zip(shape, axes or (None,) * len(shape)):
            if ax is None or ax not in self.rules:
                entries.append(None)
                continue
            names = tuple(m for m in self.rules[ax] if m not in used and m in mshape)
            if not names:
                entries.append(None)
                continue
            if dim % self.mesh_size(names) != 0:
                # divisible-or-replicate fallback: try prefixes
                ok = None
                for cut in range(len(names) - 1, 0, -1):
                    if dim % self.mesh_size(names[:cut]) == 0:
                        ok = names[:cut]
                        break
                if ok is None:
                    self.notes.append(
                        f"replicated {ax}={dim} of {what}: not divisible by "
                        f"mesh{names}={self.mesh_size(names)}"
                    )
                    entries.append(None)
                    continue
                names = ok
            used.update(names)
            entries.append(names if len(names) > 1 else names[0])
        return PartitionSpec(*entries)

    def placements(self, spec: ParamSpec) -> tuple:
        return placements(self.partition_spec(spec), self.mesh)

    def placements_for(self, shape, axes, what: str = "") -> tuple:
        return placements(self.pspec_for(shape, axes, what), self.mesh)

    def tree_pspecs(self, spec_tree):
        return tree_map(self.partition_spec, spec_tree)

    def tree_placements(self, spec_tree):
        return tree_map(self.placements, spec_tree)


def placements(pspec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``pspec`` on ``mesh``, one per mesh
    dimension in the mesh's order: ``Shard(i)`` on each mesh dimension that
    an entry of tensor dim ``i`` names, ``Replicate()`` on the others.

    DTensor splits a dimension sharded over several mesh dimensions in the
    mesh's dimension order; that is the reference's major-to-minor order
    only when the entry lists its axes in the mesh's order, so any other
    order raises rather than place the data wrongly."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"partition spec {pspec!r}: dim {dim} lists mesh axes {axes} out of "
                f"the mesh's order {tuple(names)}; DTensor would shard it minor-first"
            )
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def pspec_of(placements_: tuple, mesh, ndim: int) -> PartitionSpec:
    """The inverse of :func:`placements`: the partition spec of a
    ``ndim``-dimensional tensor at ``placements_`` on ``mesh``."""
    names = list(mesh_shape(mesh))
    entries: List[List[str]] = [[] for _ in range(ndim)]
    for name, p in zip(names, placements_):
        if p.is_shard():
            entries[p.dim % ndim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"{p} on mesh axis {name!r} is not a parameter placement")
    return PartitionSpec(*(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries))


def shard_full(full: torch.Tensor, mesh, placements_: tuple):
    """The DTensor at ``placements_`` on ``mesh`` whose shards are this
    rank's slices of ``full`` (every rank holds the same full tensor; no
    data moves).  A dimension sharded over several mesh dimensions is split
    by them in the mesh's order, as DTensor splits it."""
    from torch.distributed.tensor import DTensor

    local = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if p.is_shard():
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does not divide {n} ranks")
            local = local.chunk(n, dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements_, run_check=False)


# ---------------------------------------------------------------------------


def default_rules(mesh, strategy: str = "tp") -> AxisRules:
    """The framework's logical-axis tables (the reference's DESIGN.md §5).

    strategy="tp"   -- Megatron-style: batch->data, heads/mlp/experts->model,
                       sequence-parallel residuals.
    strategy="fsdp" -- fully-sharded data parallel: batch over EVERY mesh
                       axis and weights sharded over (data x model) on
                       their embed dim, gathered at use, their gradients
                       reduce-scattered back."""
    shape = mesh_shape(mesh)
    has_pod = "pod" in shape
    if strategy == "fsdp":
        everything = ("pod", "data", "model") if has_pod else ("data", "model")
        return AxisRules(
            rules={
                "batch": everything,
                "vocab": everything,  # embedding table fully sharded
                "heads": (),
                "kv_heads": (),
                "kv_embed": everything,
                "mlp": (),
                "experts": ("model",),
                "ssm_inner": (),
                "seq_kv": ("model",),
                "seq_act": (),
                "embed": everything,  # weight embed dims fully sharded
                "opt_data": (),
            },
            mesh=mesh,
            strategy="fsdp",
        )
    if strategy != "tp":
        raise ValueError(f"strategy must be 'tp' or 'fsdp', got {strategy!r}")
    batch = ("pod", "data") if has_pod else ("data",)
    return AxisRules(
        rules={
            "batch": batch,
            "vocab": ("model",),
            "heads": ("model",),
            "kv_heads": ("model",),
            "kv_embed": ("model",),  # row-parallel kv projections (TP > Hkv)
            "mlp": ("model",),
            "experts": ("model",),
            "ssm_inner": ("model",),
            "seq_kv": ("model",),  # decode KV caches shard on sequence
            "seq_act": ("model",),  # sequence-parallel layer-boundary residuals
            "embed": (),  # d_model replicated (activations row dim)
            "opt_data": ("data",),  # ZeRO-1 optimizer-state extra axis
        },
        mesh=mesh,
    )


def zero1_pspec(rules: AxisRules, spec: ParamSpec) -> PartitionSpec:
    """Optimizer-state sharding: the param's own spec, plus 'data' on the
    first still-unsharded divisible dimension (ZeRO-1)."""
    base = rules.partition_spec(spec)
    entries = list(base)
    used = set()
    for e in entries:
        if e is None:
            continue
        used.update((e,) if isinstance(e, str) else e)
    dsize = rules.shape.get("data", 1)
    if dsize == 1 or "data" in used:
        return base
    for i, (dim, cur) in enumerate(zip(spec.shape, entries)):
        if cur is None and dim % dsize == 0:
            entries[i] = "data"
            return PartitionSpec(*entries)
    return base
