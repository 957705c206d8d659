"""`sharded` backend -- the grid dealt over a device-mesh axis, the
``vmap`` executor within each device.

The reference runs this under ``shard_map``: one program over the mesh's
devices.  The port is SPMD over ``torch.distributed``: every rank calls
the launch with the same arguments and a
``torch.distributed.device_mesh.DeviceMesh``, runs its slice of the grid
on its own device, and gets back the merged globals, as the reference's
``out_specs=P()``.  The pieces map one to one:

* ``mesh.shape[axis]`` -- the mesh's size along ``axis``;
* ``lax.axis_index(axis)`` -- ``mesh.get_local_rank(axis)``;
* ``lax.psum(..., axis)`` -- a collective over ``mesh.get_group(axis)``
  (:class:`AxisGroup`).

Blocks are dealt round-robin-contiguously: device *d* owns the ids
``[d*per, (d+1)*per)``, ``per = ceil(grid / ndev)``.  A device runs its
slice with the chunked, grid-stride or cooperative executor of the
``vmap`` backend with ``fold_deltas=False`` (its later waves do not see
its earlier waves' atomic increments), and the devices' copies of
global memory are reconciled by :func:`merge.cross_device_merge`: the
masked sum of the stored values and the sum of the atomic deltas, taken
in mesh order from the gathered copies so that float sums round as the
reference's.  Cooperative launches merge at **every phase boundary**
(the grid barrier's guarantee across devices); the blocks' carried
state never leaves its rank.

The collective is one ``all_gather`` of a byte buffer per merge.  On a
gloo group a CUDA buffer goes through the host (gloo reduces CUDA
tensors there), which is how several ranks share one card.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import kernel_ir as K
from ..execute import walk_instrs
from . import block_vmap, merge
from .plan import LaunchPlan

name = "sharded"

_ALIGN = 8  # byte alignment of each tensor in the gathered buffer


def check_mesh(mesh, axis: str):
    """Refuse what is not a usable mesh: not a ``DeviceMesh``, an axis it
    does not name, a process group that is not initialized (never run
    as one device), or a rank outside the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= must be a torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}"
        )
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not a dimension of the mesh (dimensions: {names})")
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh's process group is not initialized (torch.distributed."
            "init_process_group): a sharded launch needs every rank of the mesh"
        )
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")


def mesh_device(mesh) -> torch.device:
    """The device this rank's slice runs on: a rank owns one device of
    the mesh (its current CUDA device, or the host)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class AxisGroup:
    """The mesh axis a launch is sharded over: its size, this rank's
    index along it and the collective over its group, with the group's
    ranks put in mesh order."""

    def __init__(self, mesh, axis: str):
        import torch.distributed as dist

        check_mesh(mesh, axis)
        dim = mesh.mesh_dim_names.index(axis)
        self.size = mesh.size(dim)
        self.rank = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        line = list(mesh.get_coordinate())
        line[dim] = slice(None)
        ranks = mesh.mesh[tuple(line)].reshape(-1).tolist()
        # position i of the gathered list holds group rank order[i]
        self.order = [dist.get_group_rank(self.group, r) for r in ranks]
        self.via_host = dist.get_backend(self.group) == "gloo"

    def gather(self, tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
        """Every device's copy of ``tensors`` (contiguous, on one device),
        in mesh order: ``out[d][i]`` is device *d*'s ``tensors[i]``.  One
        ``all_gather`` of the tensors packed as bytes."""
        import torch.distributed as dist

        dev = tensors[0].device
        spans, off = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            spans.append((off, n, t.dtype, t.shape))
            off += -(-n // _ALIGN) * _ALIGN
        buf = torch.zeros(off, dtype=torch.uint8, device=dev)
        for t, (o, n, _, _) in zip(tensors, spans):
            buf[o : o + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
        if self.via_host and buf.is_cuda:
            buf = buf.cpu()
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(outs, buf, group=self.group)
        parts = []
        for r in self.order:
            b = outs[r].to(dev, non_blocking=True) if outs[r].device != dev else outs[r]
            parts.append([b[o : o + n].view(dt).reshape(shape) for o, n, dt, shape in spans])
        return parts


def _merger(plan: LaunchPlan):
    """``merge(ax, g0, g, masks, deltas)`` for the plan: every rank
    gathers the same tensors -- a mask for each array the kernel stores
    to and a delta buffer for each atomic target -- so a rank whose
    blocks wrote nothing (or that holds no block) brings all-false masks
    and zero deltas to the collective."""
    instrs = list(walk_instrs(plan.ck))
    stored = sorted({s.array for s in instrs if isinstance(s, K.StoreGlobal)})
    targets = sorted({s.array for s in instrs if isinstance(s, K.AtomicRMW)})

    def merge_across(ax, g0, g, masks, deltas):
        masks = {k: masks[k] if k in masks else torch.zeros_like(g0[k], dtype=torch.bool) for k in stored}
        deltas = {
            k: deltas[k] if k in deltas else torch.zeros_like(g0[k], dtype=merge.num_dtype(g0[k].dtype))
            for k in targets
        }
        return merge.cross_device_merge(g0, g, masks, deltas, ax, has_atomics=plan.has_atomics)

    return merge_across


def _device_slice(plan: LaunchPlan, ax: AxisGroup):
    per = -(-plan.grid // ax.size)
    base = ax.rank * per
    return per, base, min(base + per, plan.grid)


def build_fn(plan: LaunchPlan, mesh=None, axis: str = "data"):
    """Return ``run(globals_, scalars, device) -> globals_``, which every
    rank of the mesh calls with the same arguments."""
    if mesh is None:
        raise ValueError("the sharded backend needs a mesh")
    plan.check_mergeable(name)
    check_mesh(mesh, axis)
    if plan.n_phases > 1:
        return _build_phased_fn(plan, mesh, axis)
    (block_fn,) = plan.block_fns(track_writes=True)
    if plan.schedule == "grid_stride":
        return _build_strided_fn(plan, mesh, axis, block_fn)
    merge_across = _merger(plan)

    def run(globals_: Dict[str, torch.Tensor], scalars, device):
        ax = AxisGroup(mesh, axis)
        table = plan.device_bid_table(ax.size)
        chunks = table[ax.rank].reshape(-1, plan.chunk)
        g, masks, deltas = block_vmap.run_chunked(
            plan, block_fn, chunks, globals_, scalars, device, fold_deltas=False
        )
        return merge_across(ax, globals_, g, masks, deltas)

    return run


def _build_strided_fn(plan: LaunchPlan, mesh, axis: str, block_fn):
    """Grid-stride over a mesh: device *d* loops its contiguous slice in
    waves of ``n_resident`` (the same deal as ``device_bid_table``, so
    the result is the chunked schedule's bitwise); no table is built."""
    merge_across = _merger(plan)

    def run(globals_: Dict[str, torch.Tensor], scalars, device):
        ax = AxisGroup(mesh, axis)
        per, base, _ = _device_slice(plan, ax)
        g, masks, deltas = block_vmap.run_strided(
            plan, block_fn, globals_, scalars, device, fold_deltas=False, base=base, total=per
        )
        return merge_across(ax, globals_, g, masks, deltas)

    return run


def _build_phased_fn(plan: LaunchPlan, mesh, axis: str):
    """Cooperative launch over a mesh: each device keeps its slice of the
    grid resident for the whole phase sequence, and global memory merges
    across the devices at every phase boundary, so a phase-*p+1* block
    on one device reads the phase-*p* writes of every other device."""
    if plan.schedule == "grid_stride":
        return _build_phased_strided_fn(plan, mesh, axis)
    fns = plan.block_fns(track_writes=True)
    merge_across = _merger(plan)

    def run(globals_: Dict[str, Any], scalars, device):
        ax = AxisGroup(mesh, axis)
        _, base, limit = _device_slice(plan, ax)
        n = max(0, limit - base)
        bids = torch.arange(base, base + n, dtype=torch.int32, device=device)
        u = block_vmap._uniforms(plan, scalars, device)
        state = plan.init_persist(device, n_blocks=n)
        g = globals_
        for fn in fns:
            if n:
                g2, wrote, dsum, state = block_vmap.run_phase_wave(
                    fn, bids, g, u, state, fold_deltas=False
                )
            else:
                g2, wrote, dsum = g, {}, {}
            g = merge_across(ax, g, g2, wrote, dsum)
        return g

    return run


def _build_phased_strided_fn(plan: LaunchPlan, mesh, axis: str):
    """Cooperative grid-stride over a mesh: each device pages its slice
    through waves of ``n_resident`` blocks a phase, OR-ing write masks
    and summing atomic deltas over its waves, and global memory merges
    across the devices at every phase boundary; the per-block carried
    state stays on its device in planes windowed by wave."""
    fns = plan.block_fns(track_writes=True)
    merge_across = _merger(plan)
    R = plan.n_resident

    def run(globals_: Dict[str, Any], scalars, device):
        ax = AxisGroup(mesh, axis)
        per, base, limit = _device_slice(plan, ax)
        u = block_vmap._uniforms(plan, scalars, device)
        state = plan.init_persist(device, n_blocks=per)
        g = globals_
        for fn in fns:
            t = block_vmap._Tracker(fold_deltas=False)
            g2 = g
            for i in range(plan.n_stride_waves(per)):
                ids = plan.stride_bids(i, base=base, limit=limit)
                if ids[0] < 0:
                    continue
                bids = block_vmap._wave_ids(ids, device)
                lo, hi = i * R, i * R + len(bids)
                window = {k: {n: v[lo:hi] for n, v in d.items()} for k, d in state.items()}
                g2, wrote, dsum, st2 = block_vmap.run_phase_wave(
                    fn, bids, g2, u, window, fold_deltas=False
                )
                t.add(wrote, dsum)
                for k, d in st2.items():
                    for n, v in d.items():
                        state[k][n][lo:hi] = v
            g = merge_across(ax, g, g2, t.masks, t.deltas)
        return g

    return run
