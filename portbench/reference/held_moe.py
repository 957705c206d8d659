"""The MoE block of one card's share of the experts, dropless, with the
shared expert, in plain float32 PyTorch (granite-4.0-h's, cut as a card of
an expert-parallel deployment holds it).

The router (float32, never rounded by the control) scores all
``n_experts``; each token keeps its top ``top_k`` with a softmax over the
chosen logits.  The experts held here, ``[e_lo, e_lo + experts_held)``,
compute every token routed to them, with no capacity, each a SwiGLU of
width ``d_expert`` weighted by its gate; tokens routed elsewhere get
nothing from them (that part is the other cards').  The shared SwiGLU
expert, of width ``shared_intermediate_size``, adds to every token."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layout as L


def leaves(cfg, stack=()) -> dict:
    d, fe, fs = cfg["d_model"], cfg["d_expert"], cfg["shared_intermediate_size"]
    E, Eh = cfg["n_experts"], cfg["experts_held"]
    dt = L.DTYPES[cfg["param_dtype"]]
    return {
        "router": L.Leaf(stack + (d, E), torch.float32, "normal", d),
        "w_gate": L.Leaf(stack + (Eh, d, fe), dt, "normal", d),
        "w_up": L.Leaf(stack + (Eh, d, fe), dt, "normal", d),
        "w_down": L.Leaf(stack + (Eh, fe, d), dt, "normal", fe),
        "s_gate": L.Leaf(stack + (d, fs), dt, "normal", d),
        "s_up": L.Leaf(stack + (d, fs), dt, "normal", d),
        "s_down": L.Leaf(stack + (fs, d), dt, "normal", fs),
    }


def _swiglu(num, x, w_gate, w_up, w_down):
    return num.mm(F.silu(num.mm(x, w_gate)) * num.mm(x, w_up), w_down)


def routed(cfg, num, p, x, e_lo: int = 0):
    """The held experts' gated sum for x (T, d): (T, d)."""
    gates, idx = _route(cfg, p, x)
    y = torch.zeros_like(x)
    for j in range(p["w_gate"].shape[0]):
        hit = idx == e_lo + j  # (T, k): a token picks an expert once at most
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            g = (gates * hit).sum(-1)[rows]
            out = _swiglu(num, x[rows], p["w_gate"][j], p["w_up"][j], p["w_down"][j])
            y = y.index_add(0, rows, g[:, None] * out)
    return y


def _route(cfg, p, x):
    top, idx = (x @ p["router"]).topk(cfg["top_k"], dim=-1)
    return torch.softmax(top, dim=-1), idx


def shared(num, p, x):
    return _swiglu(num, x, p["s_gate"], p["s_up"], p["s_down"])


def block(cfg, num, p, x):
    """x (B, S, d) -> the routed share plus the shared expert."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    return (routed(cfg, num, p, xt) + shared(num, p, xt)).reshape(B, S, d)
