"""Mamba2 SSD scan: the CUDA kernels of ``csrc/ssd_scan.cu`` and their
wrappers.

The forward (``cox_ssd_scan``) replaces the TPU kernel
``src/repro/kernels/ssd_scan.py::_ssd_kernel``; the backward
(``cox_ssd_scan_bwd``) is its gradient, which has no TPU kernel (the
reference trains through autodiff of its plain chunked form).  The TPU
wrapper takes one sequence and is vmapped over the batch; this one takes
the batch natively: x (B, S, H, P), a (B, S, H), b and c (B, S, N).

A CUDA tensor launches the kernels, through :class:`SSDScanFn` where
autograd records the call (the forward then also keeps the state entering
each of its tiles for the backward); a CPU tensor takes the plain chunked
form (``ref.ssd_scan_chunked``), whose gradient is autograd's.

Each wrapper call launches one kernel, after a zero fill of its sync words
(a ticket counter and one flag per (batch, head, tile)): the blocks of a
tile pass the state, or the backward's dL/dstate, to the next tile through
global memory behind those flags.  ``launches`` and ``bwd_launches`` count
the wrapper calls that launch a kernel, and only those.
"""

from __future__ import annotations

import torch

from . import build, ref
from .common import check_cuda_input, plain_route, stream_of

launches = bwd_launches = 0

DEFAULT_CHUNK = 128  # the reference's (configs/base.py ssd_chunk)
# what the kernels are built for: mamba2-130m's N = 128 and P = 64,
# zamba2's N = 64, the smoke configs' 16 and the reference sweeps'
STATE_SIZES = HEAD_DIMS = (16, 32, 64, 128)


def ssd_scan(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int = DEFAULT_CHUNK
) -> torch.Tensor:
    """y (B, S, H, P) in x's dtype: per head ``h_t = exp(a_t) h_{t-1} + b_t
    x_t^T``, ``y_t = c_t^T h_t`` from ``h = 0``.  x: (B, S, H, P); a: (B,
    S, H), the log-decay (<= 0); b, c: (B, S, N), shared by the heads.

    ``chunk = min(chunk, S)`` must divide S, the reference's rule.  On the
    CPU the result is the plain chunked form at that chunk; the kernels'
    tile is their own (the dual form is exact for any tile: the result
    differs only by rounding)."""
    if plain_route(x):
        return ref.ssd_scan_chunked(x, a, b, c, chunk=chunk)
    S = x.shape[1]
    if S % min(chunk, S):
        raise ValueError(f"ssd_scan: S = {S} must divide by chunk = {chunk}: pad the sequence")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b, c)):
        return SSDScanFn.apply(x, a, b, c)
    return ssd_scan_cuda(x, a, b, c)[0]


class SSDScanFn(torch.autograd.Function):
    """The CUDA SSD scan with its hand-written backward; the forward keeps
    the state entering each tile (``(B, H, tiles, N, P)`` f32, tiles of
    :func:`tile_rows` rows)."""

    @staticmethod
    def forward(ctx, x, a, b, c):
        y, states = ssd_scan_cuda(x, a, b, c, keep_states=True)
        ctx.save_for_backward(x, a, b, c, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ssd_scan_bwd_cuda(*ctx.saved_tensors, dy)


def tile_rows(n_state: int, head_dim: int) -> int:
    """The kernels' tile length T for (N, P): 64 rows, 32 at N = P = 128.
    The states buffer ``(B, H, ceil(S / T), N, P)`` holds the state
    entering each tile (zero for the first)."""
    return build.library("ssd_scan").cox_ssd_scan_tile(n_state, head_dim)


def _sync_words(B: int, H: int, tiles: int, device) -> torch.Tensor:
    """The chain's sync words, zero: the blocks' ticket counter, then one
    flag per (batch, head, tile)."""
    return torch.zeros(1 + B * H * tiles, dtype=torch.int32, device=device)


def _check(x, a, b, c) -> tuple:
    """Raise on inputs the kernels do not take; ``(B, S, H, P, N)``."""
    for name, t in (("x", x), ("a", a), ("b", b), ("c", c)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan {name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan {name}: dtype {t.dtype}, the kernels take float32")
        if t.numel() == 0:
            raise ValueError(f"ssd_scan {name}: empty input")
        if t.device != x.device:
            raise ValueError(f"ssd_scan {name}: on {t.device}, x on {x.device}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError(
            f"ssd_scan: expected x (B, S, H, P), a (B, S, H), b and c (B, S, N); got "
            f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}"
        )
    B, S, H, P = x.shape
    N = b.shape[2]
    if a.shape != (B, S, H) or b.shape != (B, S, N) or c.shape != (B, S, N):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"c {tuple(c.shape)}"
        )
    if P not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(
            f"ssd_scan: head dim {P} / state size {N} not built (P in {HEAD_DIMS}, "
            f"N in {STATE_SIZES})"
        )
    if x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("ssd_scan: the last axis of x, b and c must be contiguous")
    return B, S, H, P, N


def _strides(x, a, b, c) -> tuple:
    return (*x.stride()[:3], *a.stride(), *b.stride()[:2], *c.stride()[:2])


def ssd_scan_cuda(x, a, b, c, keep_states: bool = False):
    """The forward kernel: ``(y, states)``, y (B, S, H, P) f32 and, with
    ``keep_states``, the state entering each tile (else None; the kernel
    needs the buffer either way, as the chain's exchange)."""
    global launches
    B, S, H, P, N = _check(x, a, b, c)
    tiles = -(-S // tile_rows(N, P))
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    states = torch.empty(B, H, tiles, N, P, dtype=torch.float32, device=x.device)
    fn = build.library("ssd_scan").cox_ssd_scan
    with torch.cuda.device(x.device):
        sync = _sync_words(B, H, tiles, x.device)
        err = fn(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            states.data_ptr(), sync.data_ptr(),
            B, S, H, P, N, *_strides(x, a, b, c), stream_of(x),
        )
    build.check(err, "cox_ssd_scan")
    launches += 1
    return y, states if keep_states else None


def ssd_scan_bwd_cuda(x, a, b, c, states, dy):
    """The backward kernel: ``(dx, da, db, dc)``, each f32 in its input's
    shape, from the forward's inputs, the states it kept and the output
    gradient ``dy``; db and dc summed over the heads inside the kernel, in
    order.  Launched on the current stream of x's device, which the
    autograd engine sets for the backward."""
    global bwd_launches
    B, S, H, P, N = _check(x, a, b, c)
    dy = dy.contiguous()
    check_cuda_input(dy, "ssd_scan_bwd dy", (torch.float32,))
    tiles = -(-S // tile_rows(N, P))
    check_cuda_input(states, "ssd_scan_bwd states", (torch.float32,))
    if dy.shape != x.shape or states.shape != (B, H, tiles, N, P):
        raise ValueError(
            f"ssd_scan_bwd: dy {tuple(dy.shape)}, states {tuple(states.shape)} for x "
            f"{tuple(x.shape)}"
        )
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(B, S, H, P, **f32)
    da = torch.empty(B, S, H, **f32)
    db = torch.empty(B, S, N, **f32)
    dc = torch.empty(B, S, N, **f32)
    dh_x = torch.empty(B, H, tiles, N, P, **f32)  # dL/d(the state leaving each tile)
    fn = build.library("ssd_scan").cox_ssd_scan_bwd
    with torch.cuda.device(x.device):
        sync = _sync_words(B, H, tiles, x.device)
        err = fn(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
            states.data_ptr(), dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
            dh_x.data_ptr(), sync.data_ptr(),
            B, S, H, P, N, *_strides(x, a, b, c), stream_of(x),
        )
    build.check(err, "cox_ssd_scan_bwd")
    bwd_launches += 1
    return dx, da, db, dc
