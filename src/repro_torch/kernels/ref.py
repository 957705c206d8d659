"""Plain PyTorch versions of the ported kernels: the ground truth the
CUDA kernels are held against, and the path a CPU tensor takes.

They follow the TPU kernels' semantics (``src/repro/kernels``): f32
accumulation, and ``row_reduce(..., "sum")`` returns f32.  (The JAX
package's own ``ref.row_reduce`` sums in the input dtype, so for bf16 its
plain path and its Pallas kernel differ; the port follows the kernel.)
"""

from __future__ import annotations

import torch


def row_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(rows, cols) -> (rows,): f32 for ``sum``, x.dtype for ``max`` and
    ``absmax``."""
    x32 = x.to(torch.float32)
    if op == "sum":
        return x32.sum(dim=-1)
    if op == "max":
        return x32.amax(dim=-1).to(x.dtype)
    if op == "absmax":
        return x32.abs().amax(dim=-1).to(x.dtype)
    raise ValueError(op)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax over the last axis, in f32."""
    x32 = x.to(torch.float32)
    m = x32.amax(dim=-1, keepdim=True)
    e = torch.exp(x32 - m)
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)
