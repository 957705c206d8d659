"""RMS norm: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the TPU kernel ``src/repro/kernels/norms.py::_rmsnorm_kernel``.
A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``ref.rmsnorm``).  ``launches`` counts kernel launches, and only those.
The reference's ``layernorm`` kernel is not ported yet (ROADMAP B.4).
"""

from __future__ import annotations

import torch

from . import build, ref
from .common import check_cuda_input, stream_of

launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis of ``x`` (any
    leading shape), in f32, returned in ``x.dtype``.  ``w`` has the width
    of that axis and may have a dtype of its own (f32 beside a bf16 ``x``
    on the serving path)."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps)
    return rmsnorm_cuda(x, w, eps)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    global launches
    check_cuda_input(x, "rmsnorm x", build.DTYPE_CODES)
    check_cuda_input(w, "rmsnorm w", build.DTYPE_CODES)
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(
            f"rmsnorm: w {tuple(w.shape)} must match the last axis of x {tuple(x.shape)}"
        )
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    cols = x.shape[-1]
    rows = x.numel() // cols
    y = torch.empty_like(x)
    fn = build.library("rmsnorm").cox_rmsnorm
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            w.data_ptr(),
            y.data_ptr(),
            rows,
            cols,
            float(eps),
            build.DTYPE_CODES[x.dtype],
            build.DTYPE_CODES[w.dtype],
            stream_of(x),
        )
    build.check(err, "cox_rmsnorm")
    launches += 1
    return y
