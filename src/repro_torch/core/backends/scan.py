"""`scan` backend -- the loop-carried baseline.

One loop over block ids, carrying global memory: block *i* observes
every write of blocks *< i* (a legal schedule; CUDA guarantees nothing
about cross-block ordering between grid-wide syncs).  The reference
scans with ``lax.scan``; here the loop is Python and the blocks update
the launch's own flat copies of global memory in place, in the
reference scan's order, so the results are the reference scan's.

Cooperative (grid-sync) launches run the loop once per phase: global
memory carries across (phase *p+1* blocks observe every phase-*p*
write -- the grid barrier's guarantee) while each block's persistent
state (carried locals + shared memory) is paged in and out by block id.

``schedule='grid_stride'`` changes nothing here: the reference swaps its
scanned ``arange(grid)`` for a counted loop in the same block order, and
this loop already is one.  With ``warp_exec='batched'`` the block
function merges each PR's per-warp copies into the carried arrays and
hands back the updated dict.
"""

from __future__ import annotations

from typing import Dict

import torch

from .plan import LaunchPlan

name = "scan"


def build_fn(plan: LaunchPlan, mesh=None, axis: str = "data"):
    """Return ``run(globals_, scalars, device) -> globals_`` for the plan
    (``mesh``/``axis`` are the sharded backend's, unused here)."""
    if plan.n_phases > 1:
        return _build_phased_fn(plan)
    (block_fn,) = plan.block_fns()

    def run(globals_: Dict[str, torch.Tensor], scalars, device):
        bids, base = _block_ids(plan, scalars, device)
        for b in range(plan.grid):
            globals_ = block_fn({**base, "bid": bids[b]}, globals_)
        return globals_

    return run


def _block_ids(plan: LaunchPlan, scalars, device):
    """Every block id as a 0-d device tensor (indexed, not copied from
    the host per block) and the uniforms every block shares."""
    bids = torch.arange(plan.grid, dtype=torch.int32, device=device)
    return bids, plan.uniforms(bids[0], scalars)


def _build_phased_fn(plan: LaunchPlan):
    fns = plan.block_fns()

    def run(globals_: Dict[str, torch.Tensor], scalars, device):
        bids, base = _block_ids(plan, scalars, device)
        state = plan.init_persist(device)
        g = globals_
        for fn in fns:
            for b in range(plan.grid):
                st_b = {k: {n: v[b] for n, v in d.items()} for k, d in state.items()}
                g, st2 = fn({**base, "bid": bids[b]}, g, state=st_b)
                for k, d in st2.items():
                    for n, v in d.items():
                        state[k][n][b] = v
        return g

    return run
