"""Counted cost of a step: matmul flops, collective bytes and touched bytes
a rank (the counterpart of the reference's ``launch/hlo_analysis.py``).

The port has no HLO.  The reference parses XLA's optimized module and
multiplies each while-loop body by its trip count, because
``cost_analysis()`` counts a scanned body once; the port runs its layers
as a Python loop, so each layer's ops are dispatched, and counted, once a
layer.  :class:`Counter` is a ``TorchDispatchMode`` that sees every aten
op a rank runs and adds up

* **matmul flops**: 2 * M * N * K a product, the reference's dot-only
  rule, from ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: mm, bmm, addmm, baddbmm and the products under ``einsum``);
* **collective bytes**: the result-shape bytes of each collective, by
  kind (all-gather, all-reduce, reduce-scatter, all-to-all), read from the
  ``_c10d_functional`` ops that DTensor's redistributes dispatch and the
  in-place ``c10d`` ops of ``torch.distributed`` (``CommDebugMode`` counts
  the calls, not their bytes);
* **touched bytes**: every op's output bytes times 2, the reference's
  read-plus-write proxy.

An op on a ``DTensor`` is left to DTensor, which runs it on this rank's
shards, so every count is one rank's (the reference's analysis of the
partitioned module is one device's too); the ops DTensor runs on fake
tensors to propagate shardings are not counted.  On ``meta`` tensors (the dry
run) the counts need no data.

Under ``remat="full"`` the backward recomputes each layer's forward
(``torch.utils.checkpoint``), and the recomputation is dispatched, so it
is counted as it runs.  XLA's module holds the rematerialized forward
too, but its count is of the optimized module, after fusion and the
removal of work whose result goes unused, so the two counts of a
checkpointed step can differ by what XLA drops.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.dist_ops import COLLECTIVES, collective_kind, nbytes, result_bytes


def _fake(tree) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    leaves, _ = tree_flatten(tree)
    return any(isinstance(t, FakeTensor) for t in leaves)


class Counter(TorchDispatchMode):
    """Counts one rank's matmul flops, collective bytes by kind and
    touched bytes over every aten op run under it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0.0
        self.out_bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = 0
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            # DTensor runs it on this rank's shards, whose ops come back
            # here (as ``CommDebugMode`` lets them)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _fake((args, out)):
            return out  # DTensor's sharding propagation, on fake tensors
        self.n_ops += 1
        kind = collective_kind(func)
        if kind:
            self.coll[kind] += result_bytes(func, args, out)
            self.coll_count += 1
            return out
        flop = self._flops.get(func._overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        self.out_bytes += 2 * nbytes(out)
        return out

    def totals(self) -> Dict[str, float]:
        """The reference's ``analyze`` keys: ``flops``, ``coll_bytes``,
        ``out_bytes`` and ``coll.<kind>``."""
        out = {"flops": self.flops, "coll_bytes": sum(self.coll.values()), "out_bytes": self.out_bytes}
        out.update({f"coll.{k}": v for k, v in self.coll.items()})
        return out


def analyze(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under a :class:`Counter` and return its
    totals (``flops``, ``coll_bytes``, ``out_bytes``, ``coll.<kind>``)."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.totals()
