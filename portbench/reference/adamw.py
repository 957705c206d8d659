"""AdamW as the configuration states it, in plain float32: global-norm
clipping, bias-corrected moments, decoupled weight decay, and a linear
warm-up into a cosine schedule."""

from __future__ import annotations

import math

import torch


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


@torch.no_grad()
def update(opt: dict, params: dict, grads: dict, m: dict, v: dict, step: int, stored: dict) -> float:
    """One update of the float32 ``params`` (dicts by leaf path) in place;
    ``step`` counts from 1.  Each new value is computed in float32 and
    kept as the configuration stores that leaf (``stored``: its dtype), as
    a bfloat16 parameter is.  Returns the global gradient norm."""
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0) if opt["clip_norm"] else 1.0
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1**step, 1 - b2**step
    lr = lr_at(opt, step)
    for path, p in params.items():
        g = grads[path] * scale
        m[path].mul_(b1).add_((1 - b1) * g)
        v[path].mul_(b2).add_((1 - b2) * g * g)
        delta = (m[path] / b1c) / (torch.sqrt(v[path] / b2c) + opt["eps"]) + opt["weight_decay"] * p
        p.copy_((p - lr * delta).to(stored[path]).float())
    return gnorm
