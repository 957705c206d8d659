"""Row softmax: the CUDA kernel ``csrc/softmax.cu`` and its wrapper.

Replaces the TPU kernel ``src/repro/kernels/softmax.py::_softmax_kernel``.
A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``ref.softmax``).  ``launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from . import build, ref
from .common import check_cuda_input, stream_of

launches = 0


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of ``x`` (any leading shape), computed
    in f32 and returned in ``x.dtype``."""
    if x.device.type == "cpu":
        return ref.softmax(x)
    return softmax_cuda(x)


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    global launches
    check_cuda_input(x, "softmax", build.DTYPE_CODES)
    if x.dim() < 1:
        raise ValueError("softmax: expected at least one axis")
    cols = x.shape[-1]
    rows = x.numel() // cols
    y = torch.empty_like(x)
    fn = build.library("softmax").cox_softmax
    code = build.DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), rows, cols, code, stream_of(x))
    build.check(err, "cox_softmax")
    launches += 1
    return y
