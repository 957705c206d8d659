"""AdamW with warmup-cosine schedule, global-norm clipping, and optional
int8 gradient compression with error feedback (port of
``src/repro/optim/adamw.py``: the wire-format trick, numerics simulated
exactly).

Parameters, gradients and optimizer state are nested dicts of tensors;
the moments are one f32 tensor a leaf, in the parameters' layout.  The
arithmetic is the reference's, in f32, in the same order.  One
difference: :func:`update` writes the new moments and parameters into the
tensors it was given (JAX makes new arrays), which saves a copy of the
optimizer state at full width, and returns them.

:func:`update` routes by what its leaves are.  Plain CUDA tensors take
the two multi-tensor kernels of ``csrc/adamw.cu``
(``kernels/adamw.py``): ``cox_adamw_sumsq`` reads each gradient once in
its own dtype for the global norm, and ``cox_adamw_apply`` reads ``g``,
``p``, ``m`` and ``v`` once and writes ``p``, ``m`` and ``v`` once, one
launch each a (parameter dtype, gradient dtype) group.  No f32 copy of a
gradient and no temporary at a parameter's width is made, and nothing
waits on the host: the norm, the clip scale, the learning rate and the
bias corrections stay on the device.  CPU and meta leaves, and DTensor
leaves (the mesh paths, ZeRO-1/2, whose redistributions stay in
``update_eager``), take the eager arithmetic (``kernels.adamw.apply_plain``
a leaf after f32 copies of the gradients).  The spans: ``adamw.update``
around the whole; ``adamw.norm`` (the norm, the clip scale, the
schedule); ``adamw.apply`` (the update); ``adamw.cast`` where a cast runs
(the eager path's f32 gradients, and the int8 round trip under
``grad_compress`` on either path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from .. import obs
from ..kernels import adamw as kadamw
from ..models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0
    grad_compress: bool = False  # int8 + error feedback


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int), f32: a linear
    warmup, then a cosine down to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / span, 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params, cfg: AdamWConfig, shardings=None) -> Dict[str, Any]:
    """Zero f32 moments shaped like ``params``, and step 0 (int32), on the
    parameters' device; on a mesh, at ``shardings`` (a tree like the
    parameters of ``spmd.Sharding``: the ZeRO-1 placements)."""
    leaf0 = tree_leaves(params)[0]
    device = leaf0.to_local().device if _is_dt(leaf0) else leaf0.device

    def zeros32(p, sh=None):
        if sh is None:
            return torch.zeros(p.shape, dtype=torch.float32, device=device)
        from torch.distributed.tensor import zeros

        return zeros(p.shape, dtype=torch.float32, device_mesh=sh.mesh, placements=sh.placements)

    if shardings is not None:
        mom = lambda: tree_map(zeros32, params, shardings)  # noqa: E731
        st = {"m": mom(), "v": mom(), "step": torch.zeros((), dtype=torch.int32, device=device)}
        if cfg.grad_compress:
            st["err"] = mom()
        return st
    st = {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.grad_compress:
        st["err"] = tree_map(zeros32, params)
    return st


def _is_dt(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A reduction of a DTensor leaf, reduced over every rank that holds a
    part of it (a plain tensor, the same on every rank); ``x`` itself
    otherwise."""
    if not _is_dt(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()


def _quantize_int8(g: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 round-trip (the wire format); the scale
    is the max over the whole leaf."""
    scale = torch.clamp(_whole(g.abs().max()), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    return q * scale


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(
        sum(_whole(torch.sum(torch.square(x.to(torch.float32)))) for x in tree_leaves(tree))
    )


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """Returns ``(new_params, new_state, metrics)``; the moments and the
    parameters are updated in place.  Gradients may be in the parameters'
    dtype (bf16).  Runs in the span ``adamw.update``: plain CUDA leaves
    take the kernels, CPU, meta and DTensor leaves :func:`update_eager`
    (the module's docstring).  A CUDA leaf the kernels do not take (not
    contiguous, a dtype they lack) raises, as do CUDA parameters beside
    parameters elsewhere."""
    with obs.span("adamw.update"):
        leaves = tree_leaves(params)
        on_cuda = [x.device.type == "cuda" for x in leaves]
        if any(_is_dt(x) for x in leaves) or not any(on_cuda):
            return update_eager(grads, state, params, cfg)
        if not all(on_cuda):
            raise ValueError("adamw.update: parameters on CUDA and on another device")
        return _update_cuda(grads, state, params, cfg)


def _cast(grads, state, cfg: AdamWConfig):
    """The f32 gradients, and under ``grad_compress`` their int8 round
    trip: ``(gradients to apply, new error feedback)``."""
    g32 = tree_map(lambda g: g.to(torch.float32), grads)
    if not cfg.grad_compress:
        return g32, state.get("err")
    # error feedback: transmit quant(g + e); keep the residual
    sent = tree_map(lambda g, e: _quantize_int8(g + e), g32, state["err"])
    new_err = tree_map(lambda g, e, s: g + e - s, g32, state["err"], sent)
    return sent, new_err


def _scalars(cfg: AdamWConfig, step):
    """The bias corrections and the learning rate at ``step``."""
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    return b1c, b2c, schedule(cfg, step)


def _hyper(cfg: AdamWConfig) -> dict:
    return dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)


def _new_state(state, step, new_err, cfg: AdamWConfig):
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if cfg.grad_compress:
        new_state["err"] = new_err
    return new_state


def _update_cuda(grads, state, params, cfg: AdamWConfig):
    step = state["step"] + 1
    gs, new_err = grads, state.get("err")
    if cfg.grad_compress:
        with obs.span("adamw.cast"):
            gs, new_err = _cast(grads, state, cfg)
    ps, gs = tree_leaves(params), tree_leaves(gs)
    ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
    kadamw.check_leaves(ps, gs, ms, vs)
    launch_plan = kadamw.plan([(p.numel(), p.dtype, g.dtype) for p, g in zip(ps, gs)], kadamw.layout().chunk)
    with obs.span("adamw.norm"):
        norm = kadamw.global_norm_cuda(gs, launch_plan, cfg.clip_norm)
        b1c, b2c, lr = _scalars(cfg, step.to(ps[0].device))
    with obs.span("adamw.apply"):
        kadamw.apply_cuda(launch_plan, ps, gs, ms, vs, norm[1], lr, b1c, b2c, **_hyper(cfg))
    return params, _new_state(state, step, new_err, cfg), {"grad_norm": norm[0], "lr": lr}


@torch.no_grad()
def update_eager(grads, state, params, cfg: AdamWConfig):
    """:func:`update`'s eager path, which CPU, meta and DTensor leaves
    take (and which a test may run on plain CUDA leaves, as the
    reference of the kernels' path)."""
    step = state["step"] + 1
    with obs.span("adamw.cast"):
        g32, new_err = _cast(grads, state, cfg)

    with obs.span("adamw.norm"):
        gnorm = _global_norm(g32)
        scale = (
            torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.clip_norm
            else 1.0
        )
        b1c, b2c, lr = _scalars(cfg, step)

    def upd(p, mm, vv, g):
        p32 = p.to(torch.float32)
        zero1 = _is_dt(p) and tuple(p.placements) != tuple(mm.placements)
        if zero1:  # the moments' slice of the parameter: no communication
            p32 = p32.redistribute(mm.device_mesh, mm.placements)
        new = kadamw.apply_plain(p32, mm, vv, g, scale, lr, b1c, b2c, **_hyper(cfg)).to(p.dtype)
        if zero1:  # ZeRO-1's all-gather of the updated parameter
            new = new.redistribute(p.device_mesh, p.placements)
        p.copy_(new)

    with obs.span("adamw.apply"):
        tree_map(upd, params, state["m"], state["v"], g32)
    return params, _new_state(state, step, new_err, cfg), {"grad_norm": gnorm, "lr": lr}
