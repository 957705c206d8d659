"""The Mamba2 mixer as Mamba2 publishes it (granite-4.0-h's), in plain
float32 PyTorch: ``x W_in`` split into ``z | x B C | dt``, a depthwise
causal convolution with a bias and SiLU on ``x B C``, ``dt = softplus(dt +
dt_bias)``, ``a = -exp(A_log) dt``, the SSD recurrence ``h_t = e^{a_t}
h_{t-1} + B_t (dt x)_t^T``, ``y_t = C_t^T h_t + D x_t`` (the skip on x
itself, where ``model.mamba2`` takes the dt-scaled x), gated by
``silu(z)``, an rmsnorm over the inner width (one group) with the
configuration's eps, then ``W_out``.  The scan is ``model.ssd``'s dual form
at a tile of :data:`CHUNK` rows, exact for any tile, which bounds its
working set at a full-size step."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layout as L
from .model import rmsnorm, ssd

CHUNK = 128


def leaves(cfg, stack=()) -> dict:
    """``layout.mamba2``'s leaves and the convolution's bias, drawn
    N(0, 1/K) as the convolution is."""
    out = L.mamba2(cfg, stack)
    out["conv_b"] = L.Leaf(stack + (cfg["ssm_inner"] + 2 * cfg["ssm_state"],), L.DTYPES[cfg["param_dtype"]], "normal",
                           cfg["conv_k"])
    return out


def block(cfg, num, p, x):
    B, S, _ = x.shape
    di, N, H, P, K = cfg["ssm_inner"], cfg["ssm_state"], cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["conv_k"]
    proj = num.mm(x, p["w_in"])
    z, xBC, dtp = proj[..., :di], proj[..., di : 2 * di + 2 * N], proj[..., 2 * di + 2 * N :]
    xp = torch.cat([xBC.new_zeros(B, K - 1, xBC.shape[-1]), xBC], dim=1)
    xBC = F.silu(sum(xp[:, i : i + S] * p["conv"][i] for i in range(K)) + p["conv_b"])
    xs, Bm, Cm = xBC[..., :di].unflatten(-1, (H, P)), xBC[..., di : di + N], xBC[..., di + N :]
    dt = torch.logaddexp(dtp + p["dt_bias"], dtp.new_zeros(()))
    a = -torch.exp(p["A_log"]) * dt
    y = ssd(xs * dt[..., None], a, Bm, Cm, CHUNK) + xs * p["D"][:, None]
    y = y.reshape(B, S, di) * F.silu(z)
    return num.mm(rmsnorm(y, p["norm"], cfg["norm_eps"]), p["w_out"])
