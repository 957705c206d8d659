"""Row reduction: the CUDA kernel ``csrc/row_reduce.cu`` and its wrapper.

Replaces the TPU kernel ``src/repro/kernels/warp_reduce.py::_reduce_kernel``.
A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``ref.row_reduce``).  ``launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from . import build, ref
from .common import check_cuda_input, stream_of

OPS = {"sum": 0, "max": 1, "absmax": 2}

launches = 0


def row_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """(rows, cols) -> (rows,); op in {sum, max, absmax}.  ``sum`` returns
    f32, ``max`` and ``absmax`` return ``x.dtype``."""
    if op not in OPS:
        raise ValueError(f"row_reduce: unknown op {op!r}; expected one of {list(OPS)}")
    if x.device.type == "cpu":
        return ref.row_reduce(x, op)
    return row_reduce_cuda(x, op)


def row_reduce_cuda(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    global launches
    check_cuda_input(x, "row_reduce", build.DTYPE_CODES)
    if x.dim() != 2:
        raise ValueError(f"row_reduce: expected (rows, cols), got {tuple(x.shape)}")
    rows, cols = x.shape
    out_dtype = torch.float32 if op == "sum" else x.dtype
    out = torch.empty(rows, dtype=out_dtype, device=x.device)
    fn = build.library("row_reduce").cox_row_reduce
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            out.data_ptr(),
            rows,
            cols,
            build.DTYPE_CODES[x.dtype],
            OPS[op],
            stream_of(x),
        )
    build.check(err, "cox_row_reduce")
    launches += 1
    return out
