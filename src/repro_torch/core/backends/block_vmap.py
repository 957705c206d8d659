"""`vmap` backend -- block-parallel execution.

COX's host runtime (paper section 4) forks one pthread per CUDA block
because blocks are independent between grid-wide syncs.  The reference
renders that as ``jax.vmap`` over its block function; here a *wave* of
blocks runs as one more leading copy axis of every lane tensor of the
executor (``make_block_fn`` with a ``(C,)`` block id).  Each block of
the wave works on its own copy of the arrays the kernel stores to, with
write masks and atomic deltas, and the copies are reconciled by
``merge.py`` (single-writer stores selected bit-exactly, atomic deltas
summed) before the next wave starts, so memory stays bounded at
``chunk x |stored arrays|``.

Two schedules walk the grid in the same waves: ``chunked`` over the
rows of the ``(n_chunks, chunk)`` block-id table, ``grid_stride`` over
waves of ``n_resident`` ids made as they are needed.  A ragged last
wave's ``-1`` pad slots are dropped before it runs: in the reference
they run and their writes are masked out of the merge, which is the
same result.

Cooperative (grid-sync) launches run each phase as one all-resident
wave (``run_phase_wave``), or with ``grid_stride`` as waves of
``n_resident`` blocks whose carried state pages through windows of the
stacked per-block planes.  Every wave of phase *p* merges before phase
*p+1* starts: the grid barrier's guarantee.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import merge
from .plan import LaunchPlan

name = "vmap"


def _wave_ids(bids: np.ndarray, device) -> torch.Tensor:
    """The live block ids of one wave (its -1 pads dropped) on
    ``device``.  A wave is a contiguous run of ids, so they are made
    there rather than copied from the host."""
    lo = int(bids[0])
    return torch.arange(lo, lo + int((bids >= 0).sum()), dtype=torch.int32, device=device)


def _uniforms(plan: LaunchPlan, scalars, device):
    """The uniforms every wave shares, made on the device once a launch;
    a wave adds its ``bid``."""
    return plan.uniforms(torch.zeros((), dtype=torch.int32, device=device), scalars)


def _merge_wave(block_fn, bids: torch.Tensor, g, u, *, fold_deltas: bool = True):
    """One wave over the block ids ``bids`` and the merge of its copies
    into ``g`` -- the body both schedules run, so they compute the same
    thing over the same waves.  Returns ``(globals, wrote, deltas)``."""
    g2, m2, d2 = block_fn({**u, "bid": bids}, g)
    return merge.merge_chunk(g, g2, m2, d2, fold_deltas=fold_deltas)


class _Tracker:
    """The union of a device's write masks and the sum of its atomic
    deltas over its waves, for the cross-device merge
    (``fold_deltas=False``; the single-device path tracks nothing).  A
    delta buffer starts at zero and adds each wave's sum, as the
    reference's accumulator does."""

    def __init__(self, fold_deltas: bool):
        self.on = not fold_deltas
        self.masks: Dict[str, torch.Tensor] = {}
        self.deltas: Dict[str, torch.Tensor] = {}

    def add(self, wrote, dsum) -> None:
        if not self.on:
            return
        for k, m in wrote.items():
            self.masks[k] = self.masks[k] | m if k in self.masks else m
        for k, d in dsum.items():
            acc = self.deltas.get(k)
            if acc is None:
                acc = torch.zeros_like(d)
            self.deltas[k] = merge.wrap(acc + d)


def run_chunked(
    plan: LaunchPlan, block_fn, bid_chunks: np.ndarray, globals_, scalars, device, *, fold_deltas=True
):
    """The waves are the rows of ``bid_chunks`` (-1 marks pad slots; a
    row of pads runs nothing).  Returns ``(globals, masks, deltas)``:
    with ``fold_deltas=False`` the deltas stay out of ``globals``, so a
    later wave does not see an earlier wave's atomic increments, and the
    masks (OR-ed) and deltas (summed) over every wave are returned for
    :func:`merge.cross_device_merge`; with ``True`` both are empty."""
    g, u = globals_, _uniforms(plan, scalars, device)
    t = _Tracker(fold_deltas)
    for row in bid_chunks:
        if row[0] < 0:
            continue
        g, wrote, dsum = _merge_wave(block_fn, _wave_ids(row, device), g, u, fold_deltas=fold_deltas)
        t.add(wrote, dsum)
    return g, t.masks, t.deltas


def run_strided(
    plan: LaunchPlan, block_fn, globals_, scalars, device, *, fold_deltas=True, base=0, total=None
):
    """Grid-stride waves: wave *i* is ``plan.stride_bids(i)``, the
    contiguous ids ``base + [i*R, (i+1)*R)`` -- row *i* of the table a
    chunked plan with ``chunk=R`` walks, so the two are bitwise equal.
    ``base``/``total`` scope the loop to one device's slice of the grid
    (the defaults cover the whole grid).  Returns ``(globals, masks,
    deltas)`` as :func:`run_chunked`."""
    g, u = globals_, _uniforms(plan, scalars, device)
    t = _Tracker(fold_deltas)
    total = plan.grid if total is None else int(total)
    limit = min(base + total, plan.grid)
    for i in range(plan.n_stride_waves(total)):
        bids = plan.stride_bids(i, base=base, limit=limit)
        if bids[0] < 0:
            continue
        g, wrote, dsum = _merge_wave(block_fn, _wave_ids(bids, device), g, u, fold_deltas=fold_deltas)
        t.add(wrote, dsum)
    return g, t.masks, t.deltas


def run_phase_wave(fn, bids: torch.Tensor, globals_, u, state, *, fold_deltas=True):
    """One cooperative phase over the wave ``bids``, with the blocks'
    carried state on the wave axis.  Returns ``(globals, wrote, deltas,
    state)``, the masks and deltas merged over the wave
    (``fold_deltas=True`` applies the deltas to ``globals``)."""
    g2, m2, d2, st2 = fn({**u, "bid": bids}, globals_, state=state)
    g, wrote, dsum = merge.merge_chunk(globals_, g2, m2, d2, fold_deltas=fold_deltas)
    return g, wrote, dsum, st2


def build_fn(plan: LaunchPlan, mesh=None, axis: str = "data"):
    """Return ``run(globals_, scalars, device) -> globals_`` for the plan
    (``mesh``/``axis`` are the sharded backend's, unused here)."""
    plan.check_mergeable(name)
    if plan.n_phases > 1:
        return _build_phased_fn(plan)
    (block_fn,) = plan.block_fns(track_writes=True)
    if plan.schedule == "grid_stride":

        def run(globals_: Dict[str, torch.Tensor], scalars, device):
            return run_strided(plan, block_fn, globals_, scalars, device)[0]

        return run
    bid_chunks = plan.chunked_bids()

    def run(globals_: Dict[str, torch.Tensor], scalars, device):
        return run_chunked(plan, block_fn, bid_chunks, globals_, scalars, device)[0]

    return run


def _build_phased_fn(plan: LaunchPlan):
    """Cooperative launch: one all-resident wave per phase (the plan pins
    ``chunk == grid``), globals merged at every phase boundary so phase
    *p+1* observes all of phase *p*'s writes."""
    if plan.schedule == "grid_stride":
        return _build_phased_strided_fn(plan)
    fns = plan.block_fns(track_writes=True)

    def run(globals_: Dict[str, torch.Tensor], scalars, device):
        bids = torch.arange(plan.grid, dtype=torch.int32, device=device)
        u = _uniforms(plan, scalars, device)
        state = plan.init_persist(device)
        g = globals_
        for fn in fns:
            g, _, _, state = run_phase_wave(fn, bids, g, u, state)
        return g

    return run


def _build_phased_strided_fn(plan: LaunchPlan):
    """Cooperative grid-stride: each phase runs as waves of
    ``n_resident`` blocks, each block's carried state paged through a
    window of the stacked per-block planes.  All waves of phase *p*
    complete before phase *p+1* starts, so the grid barrier's guarantee
    holds beyond the all-resident capacity; single-writer stores and
    summed deltas make the result the one-wave schedule's."""
    fns = plan.block_fns(track_writes=True)

    def run(globals_: Dict[str, Any], scalars, device):
        u = _uniforms(plan, scalars, device)
        state = plan.init_persist(device)
        g = globals_
        for fn in fns:
            for i in range(plan.n_stride_waves()):
                bids = _wave_ids(plan.stride_bids(i), device)
                lo, hi = i * plan.n_resident, i * plan.n_resident + len(bids)
                window = {k: {n: v[lo:hi] for n, v in d.items()} for k, d in state.items()}
                g, _, _, st2 = run_phase_wave(fn, bids, g, u, window)
                for k, d in st2.items():
                    for n, v in d.items():
                        state[k][n][lo:hi] = v
        return g

    return run
