"""AdamW's step on CUDA tensors: the multi-tensor kernels of
``csrc/adamw.cu`` and their wrappers, beside the plain arithmetic.

``cox_adamw_sumsq`` reads every gradient once, in its own dtype, and
writes one partial sum of squares a block; ``cox_adamw_finalize`` (one
block, not counted) sums them in a fixed order into the global norm and
the clip scale, on the device.  ``cox_adamw_apply`` then updates every
leaf in place, reading ``g``, ``p``, ``m`` and ``v`` once and writing
``p``, ``m`` and ``v`` once, with :func:`apply_plain`'s arithmetic in its
order.  Neither allocates anything at a parameter's width, copies
anything to the device or waits on the host.

Replaces no TPU kernel: the JAX package leaves the update to XLA's
fusion (``src/repro/optim/adamw.py``).  :func:`apply_plain` is the eager
update of one leaf, which ``optim/adamw.py`` runs for CPU and DTensor
leaves.  :func:`plan` groups the leaves by (parameter dtype, gradient
dtype), splits a group whose table would not fit a launch's argument,
and counts each leaf's chunks, in plain Python; :func:`layout` reads the
chunk and the grids' sizes from the library.
``launches`` counts ``cox_adamw_sumsq``'s launches and
``apply_launches`` ``cox_adamw_apply``'s, and only those.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

from . import build
from .common import sm_count, stream_of

launches = apply_launches = 0

# the dtypes the kernels take for a parameter and its gradient (the
# moments are f32)
DTYPES = (torch.float32, torch.bfloat16)


def apply_plain(p32, m, v, g, scale, lr, b1c, b2c, *, b1, b2, eps, weight_decay):
    """One leaf's AdamW update in f32: ``m`` and ``v`` in place, the new
    parameter returned (f32).  ``g`` is the f32 gradient, ``scale`` the
    clip scale, ``lr``, ``b1c`` and ``b2c`` the learning rate and the bias
    corrections; ``cox_adamw_apply`` rounds each step as this does."""
    g = g * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
    return p32 - lr * delta


@dataclasses.dataclass(frozen=True)
class Layout:
    """``csrc/adamw.cu``'s numbers: the elements of a block's chunk of a
    leaf, and the blocks an SM holds of each kernel (the persistent
    grids' size)."""

    chunk: int
    sumsq_blocks_per_sm: int
    apply_blocks_per_sm: int


@functools.cache
def layout() -> Layout:
    """The library's :class:`Layout`; raises where its table is not
    ``build.AdamWTable``."""
    out = (ctypes.c_longlong * 5)()
    build.check(build.library("adamw").cox_adamw_layout(out), "cox_adamw_layout")
    chunk, sumsq, apply, leaves, size = out
    if (leaves, size) != (build.ADAMW_MAX_LEAVES, ctypes.sizeof(build.AdamWTable)):
        raise RuntimeError(
            f"csrc/adamw.cu's table holds {leaves} leaves in {size} B; build.AdamWTable "
            f"{build.ADAMW_MAX_LEAVES} in {ctypes.sizeof(build.AdamWTable)} B"
        )
    return Layout(chunk, sumsq, apply)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of each kernel: a group's leaves (indices into the
    tree's leaves) and their chunks, leaf i's being ``[chunk_start[i],
    chunk_start[i + 1])``."""

    p_dtype: torch.dtype
    g_dtype: torch.dtype
    leaves: Tuple[int, ...]
    chunk_start: Tuple[int, ...]

    @property
    def chunks(self) -> int:
        return self.chunk_start[-1]


def plan(leaves: Sequence[Tuple[int, torch.dtype, torch.dtype]], chunk: int) -> List[Launch]:
    """The launches for leaves given as (elements, parameter dtype,
    gradient dtype), in chunks of ``chunk`` elements (the kernels':
    ``layout().chunk``): one a dtype group, in the order the groups first
    appear, and more where a group holds over ``ADAMW_MAX_LEAVES``."""
    groups: dict = {}
    for i, (_, p_dtype, g_dtype) in enumerate(leaves):
        groups.setdefault((p_dtype, g_dtype), []).append(i)
    out = []
    for (p_dtype, g_dtype), idx in groups.items():
        for j in range(0, len(idx), build.ADAMW_MAX_LEAVES):
            part = tuple(idx[j : j + build.ADAMW_MAX_LEAVES])
            start = [0]
            for i in part:
                start.append(start[-1] + -(-leaves[i][0] // chunk))
            out.append(Launch(p_dtype, g_dtype, part, tuple(start)))
    return out


def check_leaves(params, grads, ms, vs) -> None:
    """Raise on leaves the kernels do not take: every tensor on the first
    parameter's CUDA device and contiguous, a parameter and its gradient
    f32 or bf16 and of one shape with the f32 moments."""
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"adamw: expected CUDA tensors, got {dev}")
    f32 = (torch.float32,)
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs, strict=True)):
        for what, t, dtypes in (("param", p, DTYPES), ("grad", g, DTYPES), ("m", m, f32), ("v", v, f32)):
            where = f"adamw: leaf {i}'s {what}"
            if t.device != dev:
                raise ValueError(f"{where} is on {t.device}, the first parameter on {dev}")
            if t.dtype not in dtypes:
                raise TypeError(f"{where} dtype {t.dtype} not in {sorted(map(str, dtypes))}")
            if not t.is_contiguous():
                raise ValueError(f"{where} is not contiguous")
            if t.shape != p.shape:
                raise ValueError(f"{where} shape {tuple(t.shape)}, the parameter's {tuple(p.shape)}")


def _table(launch: Launch, grads, params=None, ms=None, vs=None) -> build.AdamWTable:
    t = build.AdamWTable()
    t.n = len(launch.leaves)
    t.chunk_start[t.n] = launch.chunk_start[t.n]
    for k, i in enumerate(launch.leaves):
        t.chunk_start[k] = launch.chunk_start[k]
        t.numel[k] = grads[i].numel()
        t.g[k] = grads[i].data_ptr()
        if params is not None:
            t.p[k], t.m[k], t.v[k] = params[i].data_ptr(), ms[i].data_ptr(), vs[i].data_ptr()
    return t


def global_norm_cuda(grads, launch_plan: List[Launch], clip_norm: float) -> torch.Tensor:
    """The gradients' global norm and the clip scale ``min(clip_norm /
    max(norm, 1e-12), 1)`` (1 where ``clip_norm`` is 0), as an f32 tensor
    of 2 on the device; bitwise the same on every call."""
    global launches
    dev = grads[0].device
    lib = build.library("adamw")
    grids = [min(L.chunks, sm_count(dev) * layout().sumsq_blocks_per_sm) for L in launch_plan]
    partials = torch.empty(max(sum(grids), 1), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    stream = stream_of(out)
    slot = 0
    with torch.cuda.device(dev):
        for L, grid in zip(launch_plan, grids):
            if grid == 0:
                continue
            at = partials.data_ptr() + 4 * slot
            err = lib.cox_adamw_sumsq(_table(L, grads), at, grid, build.DTYPE_CODES[L.g_dtype], stream)
            build.check(err, "cox_adamw_sumsq")
            launches += 1
            slot += grid
        clip = float(clip_norm or 0.0)
        err = lib.cox_adamw_finalize(partials.data_ptr(), slot, out.data_ptr(), clip, stream)
    build.check(err, "cox_adamw_finalize")
    return out


def apply_cuda(
    launch_plan: List[Launch], params, grads, ms, vs, scale, lr, b1c, b2c, *, b1, b2, eps, weight_decay
):
    """Every leaf's update in place; ``scale``, ``lr``, ``b1c`` and
    ``b2c`` are f32 scalars on the leaves' device, read there."""
    global apply_launches
    dev = params[0].device
    for what, t in (("scale", scale), ("lr", lr), ("b1c", b1c), ("b2c", b2c)):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"adamw: {what} must be one f32 value on {dev}, got {t.dtype} on {t.device}")
    lib = build.library("adamw")
    blocks = sm_count(dev) * layout().apply_blocks_per_sm
    stream = stream_of(params[0])
    with torch.cuda.device(dev):
        for L in launch_plan:
            if L.chunks == 0:
                continue
            err = lib.cox_adamw_apply(
                _table(L, grads, params, ms, vs),
                scale.data_ptr(),
                lr.data_ptr(),
                b1c.data_ptr(),
                b2c.data_ptr(),
                b1,
                1 - b1,
                b2,
                1 - b2,
                eps,
                weight_decay,
                min(L.chunks, blocks),
                build.DTYPE_CODES[L.p_dtype],
                build.DTYPE_CODES[L.g_dtype],
                stream,
            )
            build.check(err, "cox_adamw_apply")
            apply_launches += 1
