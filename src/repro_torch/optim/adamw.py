"""AdamW with warmup-cosine schedule, global-norm clipping, and optional
int8 gradient compression with error feedback (port of
``src/repro/optim/adamw.py``: the wire-format trick, numerics simulated
exactly).

Parameters, gradients and optimizer state are nested dicts of tensors.
The arithmetic is the reference's, in f32, in the same order.  One
difference: :func:`update` writes the new moments and parameters into the
tensors it was given (JAX makes new arrays), which saves a copy of the
optimizer state at full width, and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from .. import obs
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
    dtype (bf16): they are cast to f32 first.  Runs in the span
    ``adamw.update``, its parts in ``adamw.cast`` (the f32 gradients, and
    their int8 round trip under ``grad_compress``), ``adamw.norm`` (the
    global norm, the clip scale and the schedule) and ``adamw.apply`` (the
    update of each leaf)."""
    with obs.span("adamw.update"):
        return _update(grads, state, params, cfg)


def _update(grads, state, params, cfg: AdamWConfig):
    step = state["step"] + 1
    with obs.span("adamw.cast"):
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        if cfg.grad_compress:
            # error feedback: transmit quant(g + e); keep the residual
            sent = tree_map(lambda g, e: _quantize_int8(g + e), g32, state["err"])
            new_err = tree_map(lambda g, e, s: g + e - s, g32, state["err"], sent)
            g32 = sent
        else:
            new_err = state.get("err")

    with obs.span("adamw.norm"):
        gnorm = _global_norm(g32)
        scale = (
            torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.clip_norm
            else 1.0
        )
        b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
        b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
        lr = schedule(cfg, step)

    def upd(p, mm, vv, g):
        g = g * scale
        mm.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        vv.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = mm / b1c
        vhat = vv / b2c
        p32 = p.to(torch.float32)
        zero1 = _is_dt(p) and tuple(p.placements) != tuple(mm.placements)
        if zero1:  # the moments' slice of the parameter: no communication
            p32 = p32.redistribute(mm.device_mesh, mm.placements)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        new = (p32 - lr * delta).to(p.dtype)
        if zero1:  # ZeRO-1's all-gather of the updated parameter
            new = new.redistribute(p.device_mesh, p.placements)
        p.copy_(new)

    with obs.span("adamw.apply"):
        tree_map(upd, params, state["m"], state["v"], g32)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if cfg.grad_compress:
        new_state["err"] = new_err
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
