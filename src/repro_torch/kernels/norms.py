"""RMS norm: the CUDA kernels of ``csrc/rmsnorm.cu`` and their wrappers.

The forward replaces the TPU kernel
``src/repro/kernels/norms.py::_rmsnorm_kernel``; the backward
(``cox_rmsnorm_bwd``) is its gradient, which has no TPU kernel.  A CUDA
tensor launches the kernels, through :class:`RMSNormFn` where autograd
records the call; a CPU tensor takes the plain version (``ref.rmsnorm``),
whose gradient is autograd's.  ``launches`` and ``bwd_launches`` count
the launches of each kernel, and only those.  The reference's
``layernorm`` kernel is not ported yet (ROADMAP B.4).
"""

from __future__ import annotations

import torch

from . import build, ref
from .common import check_cuda_input, sm_count, stream_of

launches = bwd_launches = 0

BWD_BLOCKS_PER_SM = 4  # the backward's row ranges: about this many blocks per SM
MAX_BWD_COLS = 56 * 1024  # its partial dw row lives in a block's shared memory


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis of ``x`` (any
    leading shape), in f32, returned in ``x.dtype``.  ``w`` has the width
    of that axis and may have a dtype of its own (f32 beside a bf16 ``x``
    on the serving path)."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, eps)
    return rmsnorm_cuda(x, w, eps)


class RMSNormFn(torch.autograd.Function):
    """The CUDA rmsnorm with its hand-written backward: dx in x's dtype,
    dw in w's (f32 beside a bf16 x on the training path)."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(x, w, dy, ctx.eps)
        return dx, dw, None


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


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """The backward kernels: ``(dx, dw)`` of ``rmsnorm(x, w, eps)`` for the
    output gradient ``dy``; dx in x's dtype and shape, dw in w's.
    Launched on the current stream of x's device, which the autograd
    engine sets for the backward."""
    global bwd_launches
    check_cuda_input(x, "rmsnorm_bwd x", build.DTYPE_CODES)
    check_cuda_input(w, "rmsnorm_bwd w", build.DTYPE_CODES)
    dy = dy.contiguous()
    check_cuda_input(dy, "rmsnorm_bwd dy", (x.dtype,))
    if w.dim() != 1 or w.shape[0] != x.shape[-1] or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm_bwd: x {tuple(x.shape)}, w {tuple(w.shape)}, dy {tuple(dy.shape)}"
        )
    if w.device != x.device or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: x on {x.device}, w on {w.device}, dy on {dy.device}")
    cols = x.shape[-1]
    rows = x.numel() // cols
    if cols > MAX_BWD_COLS:
        raise ValueError(f"rmsnorm_bwd: width {cols} > {MAX_BWD_COLS}")
    nblk = min(rows, BWD_BLOCKS_PER_SM * sm_count(x.device))
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    part = torch.empty(nblk, cols, dtype=torch.float32, device=x.device)
    fn = build.library("rmsnorm").cox_rmsnorm_bwd
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            w.data_ptr(),
            dy.data_ptr(),
            dx.data_ptr(),
            dw.data_ptr(),
            part.data_ptr(),
            nblk,
            rows,
            cols,
            float(eps),
            build.DTYPE_CODES[x.dtype],
            build.DTYPE_CODES[w.dtype],
            stream_of(x),
        )
    build.check(err, "cox_rmsnorm_bwd")
    bwd_launches += 1
    return dx, dw
