"""RMS norm and layer norm: the CUDA kernels of ``csrc/rmsnorm.cu`` and
``csrc/layernorm.cu`` (one templated kernel, ``csrc/norm.cuh``) and their
wrappers.

The forwards replace the TPU kernels
``src/repro/kernels/norms.py::_rmsnorm_kernel`` and ``_layernorm_kernel``;
the backwards (``cox_rmsnorm_bwd``, ``cox_layernorm_bwd``) are their
gradients, which have no TPU kernel.  A CUDA tensor launches the kernels,
through :class:`RMSNormFn` or :class:`LayerNormFn` where autograd records
the call; a CPU tensor takes the plain version (``ref.rmsnorm``,
``ref.layernorm``), whose gradient is autograd's.  ``launches`` and
``bwd_launches`` count the rmsnorm kernels' launches, ``ln_launches``
and ``ln_bwd_launches`` the layernorm kernels', and only those.
"""

from __future__ import annotations

import functools

import torch

from . import build, ref
from .common import check_cuda_input, plain_route, sm_count, stream_of

launches = bwd_launches = ln_launches = ln_bwd_launches = 0

# the forward (csrc/norm.cuh norm_kernel): x values a thread keeps in
# registers, warps a row at most, threads a block at most, rows a team
# walks at most
NORM_HELD = 24
NORM_MAX_WARPS = 8
NORM_BLOCK = 256
NORM_ROWS = 4
# the backwards (csrc/norm.cuh norm_bwd_kernel, the forward's layout): at
# most this many blocks an SM, each a range of rows and one partial row of
# dw (and db); a ring of BWD_RING rows of x and dy in shared memory; pass 2
# (partial_reduce_kernel) sums at most BWD_SUM_VALUES partial rows a
# thread, with at most BWD_MAX_SPLITS warps a block
BWD_BLOCKS_PER_SM = 2
BWD_RING = 2
BWD_SUM_VALUES = 16
BWD_MAX_SPLITS = 32
# the partial rows of the columns that a row does not hold in registers
# (dw, and the layer norm's db) live in a block's shared memory: their
# widths together at most this
MAX_BWD_COLS = 56 * 1024
MAX_SMEM = 232448  # a block's shared memory on sm_90
BWD_STATIC_SMEM = 1024  # room left for the backward's static shared memory


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis of ``x`` (any
    leading shape), in f32, returned in ``x.dtype``.  ``w`` has the width
    of that axis and may have a dtype of its own (f32 beside a bf16 ``x``
    on the serving path)."""
    if plain_route(x):
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


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    """``(x - mean) * rsqrt(var + eps) * w + b`` over the last axis of ``x``
    (any leading shape), in f32, returned in ``x.dtype``.  ``w`` and ``b``
    have the width of that axis and share a dtype, which may differ from
    x's (f32 beside a bf16 ``x`` on the serving and training paths)."""
    if plain_route(x):
        return ref.layernorm(x, w, b, eps)
    needs_grad = x.requires_grad or w.requires_grad or b.requires_grad
    if torch.is_grad_enabled() and needs_grad:
        return LayerNormFn.apply(x, w, b, eps)
    return layernorm_cuda(x, w, b, eps)


class LayerNormFn(torch.autograd.Function):
    """The CUDA layernorm with its hand-written backward: dx in x's dtype,
    dw and db in w's (f32 beside a bf16 x on the training path)."""

    @staticmethod
    def forward(ctx, x, w, b, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return layernorm_cuda(x, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = layernorm_bwd_cuda(x, w, dy, ctx.eps)
        return dx, dw, db, None


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    global launches
    y = _norm_cuda("rmsnorm", x, w, None, eps)
    launches += 1
    return y


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """The backward kernels: ``(dx, dw)`` of ``rmsnorm(x, w, eps)`` for the
    output gradient ``dy``; dx in x's dtype and shape, dw in w's.
    Launched on the current stream of x's device, which the autograd
    engine sets for the backward."""
    global bwd_launches
    grads = _norm_bwd_cuda("rmsnorm_bwd", x, w, dy, eps, centred=False)
    bwd_launches += 1
    return grads


def layernorm_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    global ln_launches
    y = _norm_cuda("layernorm", x, w, b, eps)
    ln_launches += 1
    return y


def layernorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """The backward kernels: ``(dx, dw, db)`` of ``layernorm(x, w, b, eps)``
    for the output gradient ``dy`` (b does not enter them); dx in x's
    dtype and shape, dw and db in w's.  Launched on the current stream of
    x's device, which the autograd engine sets for the backward."""
    global ln_bwd_launches
    grads = _norm_bwd_cuda("layernorm_bwd", x, w, dy, eps, centred=True)
    ln_bwd_launches += 1
    return grads


def _check_params(x: torch.Tensor, w: torch.Tensor, b, what: str) -> None:
    check_cuda_input(x, f"{what} x", build.DTYPE_CODES)
    check_cuda_input(w, f"{what} w", build.DTYPE_CODES)
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1] or w.device != x.device:
        raise ValueError(
            f"{what}: w {tuple(w.shape)} on {w.device} must match the last axis of "
            f"x {tuple(x.shape)} on {x.device}"
        )
    if b is not None:
        check_cuda_input(b, f"{what} b", (w.dtype,))
        if b.shape != w.shape or b.device != w.device:
            raise ValueError(f"{what}: b {tuple(b.shape)} on {b.device}, w {tuple(w.shape)}")


def norm_plan(rows: int, cols: int, device: torch.device) -> tuple:
    """The forward's launch: ``(warps a row, teams a block, blocks)``.  A
    warp holds 32 x NORM_HELD columns in registers, so a row takes that
    many warps (at most NORM_MAX_WARPS; a wider row re-reads the rest); a
    block holds as many such teams as fit NORM_BLOCK threads; each team
    walks NORM_ROWS rows (fewer where that leaves SMs idle), the next
    one's loads in flight, and the card's scheduler balances the blocks."""
    return _norm_plan(rows, cols, sm_count(device))


@functools.lru_cache(maxsize=256)  # a decode step asks the same, twice a layer
def _norm_plan(rows: int, cols: int, sms: int) -> tuple:
    warps = min(NORM_MAX_WARPS, -(-cols // (32 * NORM_HELD)))
    teams = max(1, NORM_BLOCK // (32 * warps))
    per_team = min(NORM_ROWS, -(-rows // (teams * sms)))
    return warps, teams, -(-rows // (teams * per_team))


def _norm_cuda(what: str, x, w, b, eps: float) -> torch.Tensor:
    """cox_rmsnorm (b None) or cox_layernorm."""
    _check_params(x, w, b, what)
    cols = x.shape[-1]
    rows = x.numel() // cols
    y = torch.empty_like(x)
    if b is None:
        fn, bias = build.library("rmsnorm").cox_rmsnorm, ()
    else:
        fn, bias = build.library("layernorm").cox_layernorm, (b.data_ptr(),)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            w.data_ptr(),
            *bias,
            y.data_ptr(),
            rows,
            cols,
            float(eps),
            build.DTYPE_CODES[x.dtype],
            build.DTYPE_CODES[w.dtype],
            *norm_plan(rows, cols, x.device),
            stream_of(x),
        )
    build.check(err, f"cox_{what}")
    return y


def norm_bwd_plan(rows: int, cols: int, device: torch.device, x_itemsize: int,
                  w_itemsize: int, nr: int) -> tuple:
    """The backward's launch, for x and w of these item sizes and ``nr``
    partial rows (dw, and the layer norm's db): ``(warps a row, teams a
    block, blocks, rows a block, whether the rows' vectors are held, pass
    2's warps a block)``.  Warps and teams are the forward's; each block
    takes a contiguous range of rows (a multiple of the teams, which
    interleave in it), at most BWD_BLOCKS_PER_SM blocks an SM, so that
    pass 2 sums a few hundred partial rows; a row's 16-byte vectors are
    held (through the ring) unless the widest rows' partial rows leave no
    room; pass 2 splits the partial rows among enough warps that a thread
    sums at most BWD_SUM_VALUES."""
    return _norm_bwd_plan(
        rows, cols, sm_count(device), BWD_BLOCKS_PER_SM, x_itemsize, w_itemsize, nr
    )


@functools.lru_cache(maxsize=256)
def _norm_bwd_plan(rows, cols, sms, blocks_per_sm, x_itemsize, w_itemsize, nr) -> tuple:
    warps = min(NORM_MAX_WARPS, -(-cols // (32 * NORM_HELD)))
    teams = max(1, NORM_BLOCK // (32 * warps))
    blocks = max(1, min(-(-rows // teams), blocks_per_sm * sms))
    per = teams * -(-rows // (blocks * teams))
    blocks = -(-rows // per)
    smem = bwd_smem(cols, warps, teams, nr, x_itemsize, w_itemsize, True)
    hold = int(smem <= MAX_SMEM - BWD_STATIC_SMEM)
    splits = min(BWD_MAX_SPLITS, -(-blocks // BWD_SUM_VALUES))
    return warps, teams, blocks, per, hold, splits


def bwd_smem(cols: int, warps: int, teams: int, nr: int, x_itemsize: int, w_itemsize: int,
             hold: bool, aligned: bool = True) -> int:
    """Pass 1's dynamic shared memory in bytes (csrc/norm.cuh bwd_smem),
    for rows on a 16-byte boundary (``aligned``) or not: w of the columns
    held in registers (``hold``), the ring of their x and dy, then each
    team's f32 partial rows of the columns it does not hold (of every
    column where the block has several teams)."""
    n = 16 // x_itemsize
    held = 0
    if aligned and hold and cols % n == 0:
        held = min(cols // n, NORM_HELD // n * 32 * warps)
    hc = held * n
    nw = 16 // w_itemsize
    ring = BWD_RING * teams * 2 * held  # 16-byte vectors
    return 16 * (-(-hc // nw) + ring) + 4 * teams * nr * (cols - (hc if teams == 1 else 0))


def _norm_bwd_cuda(what: str, x, w, dy, eps: float, *, centred: bool) -> tuple:
    """cox_rmsnorm_bwd, or with ``centred`` cox_layernorm_bwd: ``(dx, dw)``
    or ``(dx, dw, db)``."""
    _check_params(x, w, None, what)
    dy = dy.contiguous()
    check_cuda_input(dy, f"{what} dy", (x.dtype,))
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(
            f"{what}: x {tuple(x.shape)} on {x.device}, dy {tuple(dy.shape)} on {dy.device}"
        )
    nr = 2 if centred else 1  # partial rows: dw, and db
    cols = x.shape[-1]
    rows = x.numel() // cols
    if nr * cols > MAX_BWD_COLS:
        raise ValueError(f"{what}: width {cols} > {MAX_BWD_COLS // nr}")
    warps, teams, nblk, per, hold, splits = norm_bwd_plan(
        rows, cols, x.device, x.element_size(), w.element_size(), nr
    )
    dx = torch.empty_like(x)
    dwb = [torch.empty_like(w) for _ in range(nr)]
    part = torch.empty(nblk, nr * cols, dtype=torch.float32, device=x.device)
    if centred:
        fn = build.library("layernorm").cox_layernorm_bwd
    else:
        fn = build.library("rmsnorm").cox_rmsnorm_bwd
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            w.data_ptr(),
            dy.data_ptr(),
            dx.data_ptr(),
            *(t.data_ptr() for t in dwb),
            part.data_ptr(),
            rows,
            cols,
            float(eps),
            build.DTYPE_CODES[x.dtype],
            build.DTYPE_CODES[w.dtype],
            warps,
            teams,
            nblk,
            per,
            hold,
            splits,
            stream_of(x),
        )
    build.check(err, f"cox_{what}")
    return (dx, *dwb)
