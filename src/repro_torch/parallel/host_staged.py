"""gloo for CUDA tensors, staged through pinned host memory: the one place
where a collective on a card goes through the host.

Several gloo ranks can share one card, which NCCL refuses (it takes one
rank a GPU).  gloo itself reduces only host tensors here: a gloo
collective on a CUDA tensor ends the process (a segmentation fault on the
H100 under torch 2.11).  So a mesh of gloo ranks on a card registers
:class:`HostStagedGloo` for the ``cuda`` device (``init_process_group(
backend=BACKEND)``): every collective copies its CUDA inputs into pinned
host buffers, runs the same gloo collective there, and copies the results
back, synchronously.  DTensor's collectives reach it through
``torch.distributed``'s backend registry like any other backend, and
``staged`` counts the collectives that took this path.  A group on NCCL
never does; CPU tensors go to gloo directly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (
    AllgatherOptions,
    AllreduceCoalescedOptions,
    AllreduceOptions,
    AllToAllOptions,
    BarrierOptions,
    BroadcastOptions,
    ReduceScatterOptions,
)

NAME = "gloo_host_staged"
BACKEND = NAME  # init_process_group(backend=BACKEND)
staged = 0  # collectives staged through the host since import


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    h.copy_(t)
    return h


def _done(value=None):
    fut = torch.futures.Future()
    fut.set_result(value)
    return torch._C._distributed_c10d._create_work_from_future(fut)


class HostStagedGloo(dist.ProcessGroup):
    """A ``ProcessGroup`` for CUDA tensors that runs each collective on a
    gloo group over pinned host copies.  Synchronous: the returned work is
    already complete, and the outputs are on the card."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self):
        return NAME

    @property
    def group_name(self):
        # a Python process group's name lives in the c10d world's table
        return dist.distributed_c10d._world.pg_names[self]

    def _run(self, ins, outs, call):
        """``call(host_ins, host_outs)`` runs a gloo collective; the host
        outputs are copied back into ``outs``."""
        global staged
        hin = [_host(t) for t in ins]
        hout = [_host(t) for t in outs]
        call(hin, hout).wait()
        for t, h in zip(outs, hout):
            t.copy_(h)
        staged += 1
        return _done()

    def allreduce(self, tensors, opts=AllreduceOptions()):
        return self._run(tensors, tensors, lambda i, o: self._gloo.allreduce(o, opts))

    def allreduce_coalesced(self, tensors, opts=AllreduceCoalescedOptions()):
        for t in tensors:
            self.allreduce([t], _reduce_opts(opts.reduceOp))
        return _done()

    def broadcast(self, tensors, opts=BroadcastOptions()):
        return self._run(tensors, tensors, lambda i, o: self._gloo.broadcast(o, opts))

    def barrier(self, opts=BarrierOptions()):
        return self._gloo.barrier(opts)

    def allgather(self, output_lists, inputs, opts=AllgatherOptions()):
        outs = [t for lst in output_lists for t in lst]
        n = len(output_lists[0])

        def call(i, o):
            return self._gloo.allgather([o[k * n : (k + 1) * n] for k in range(len(output_lists))], i, opts)

        return self._run(inputs, outs, call)

    def all_gather_single(self, output, inp, opts=AllgatherOptions()):
        return self._run([inp], [output], lambda i, o: self._gloo._allgather_base(o[0], i[0], opts))

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=AllgatherOptions()):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done()

    def all_gather_single_coalesced(self, outputs, inputs, opts=AllgatherOptions()):
        return self.allgather_into_tensor_coalesced(outputs, inputs, opts)

    def reduce_scatter(self, outputs, input_lists, opts=ReduceScatterOptions()):
        ins = [t for lst in input_lists for t in lst]
        n = len(input_lists[0])

        def call(i, o):
            return self._gloo.reduce_scatter(o, [i[k * n : (k + 1) * n] for k in range(len(outputs))], opts)

        return self._run(ins, outputs, call)

    def reduce_scatter_single(self, output, inp, opts=ReduceScatterOptions()):
        return self._run([inp], [output], lambda i, o: self._gloo._reduce_scatter_base(o[0], i[0], opts))

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=ReduceScatterOptions()):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done()

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=ReduceScatterOptions()):
        return self.reduce_scatter_tensor_coalesced(outputs, inputs, opts)

    def alltoall(self, outputs, inputs, opts=AllToAllOptions()):
        return self._run(inputs, outputs, lambda i, o: self._gloo.alltoall(o, i, opts))

    def all_to_all_single(self, output, inp, out_splits, in_splits, opts=AllToAllOptions()):
        return self._run(
            [inp], [output], lambda i, o: self._gloo.alltoall_base(o[0], i[0], out_splits, in_splits, opts)
        )


def _reduce_opts(op):
    o = AllreduceOptions()
    o.reduceOp = op
    return o


def _create(store, rank, size, timeout):
    return HostStagedGloo(store, rank, size, timeout)


def register() -> str:
    """Register the backend (once a process) and return its name for
    ``init_process_group``: CUDA tensors are staged, CPU tensors go to gloo
    as they are."""
    if NAME not in dist.Backend.backend_list:
        dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
    return BACKEND
