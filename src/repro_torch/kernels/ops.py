"""Kernel dispatch layer: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The route follows the tensor's device and nothing else: there is no
override that sends a CUDA tensor to the plain path, and no interpret
mode (a CUDA kernel has none).  The other TPU kernels of the reference's
``ops.py`` (norms, attention, the SSD scan) are still to be ported.
"""

from __future__ import annotations

import torch

from . import softmax as _sm
from . import warp_reduce as _wr


def resolve(x: torch.Tensor) -> str:
    """The route a tensor takes: ``"cuda"`` (the kernel) or ``"torch"``
    (the plain version on the CPU)."""
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel route for device {x.device}")


def softmax(x: torch.Tensor) -> torch.Tensor:
    return _sm.softmax(x)


def row_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return _wr.row_reduce(x, op)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {"softmax": _sm.launches, "row_reduce": _wr.launches}


def reset_launch_counts() -> None:
    _sm.launches = 0
    _wr.launches = 0
