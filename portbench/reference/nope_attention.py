"""Causal attention with no rotary embedding and a scale of its own (NoPE,
granite-4.0-h's ``attention_multiplier`` in place of ``1/sqrt(Dh)``), in
plain float32 PyTorch: grouped-query heads (query head h reads kv head
``h // (H / Hkv)``), each query chunk under ``torch.utils.checkpoint`` as
``model.attention`` runs them.  Its leaves are ``layout.attention``'s."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .model import ATTN_CHUNK, NEG_INF


def _attend(q, k, v, q0: int, scale: float):
    """Queries ``q0 ..`` of q (B, c, Hkv, g, D) over the keys k, v (B, s,
    Hkv, D) up to the chunk's last query."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q * scale, k)
    qi = q0 + torch.arange(q.shape[1], device=q.device)[:, None]
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    p = torch.softmax(torch.where(qi >= kj, logits, NEG_INF), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


def attention(q, k, v, scale: float, chunk: int = ATTN_CHUNK):
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) -> (B, S, H, D), causal."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    outs = []
    for q0 in range(0, S, chunk):
        q1 = min(S, q0 + chunk)
        args = (qg[:, q0:q1], k[:, :q1], v[:, :q1], q0, scale)
        outs.append(checkpoint(_attend, *args, use_reentrant=False) if torch.is_grad_enabled() else _attend(*args))
    return torch.cat(outs, dim=1).reshape(B, S, H, D)


def block(cfg, num, p, x):
    """The attention mixer of a layer: q, k, v projected from x (B, S, d),
    no position embedding, logits scaled by ``attention_multiplier``, then
    the output projection."""
    B, S, d = x.shape
    H, Hkv, Dh = cfg["n_heads"], cfg["n_kv"], cfg["d_head"]
    q = num.mm(x, p["wq"].reshape(d, H * Dh)).reshape(B, S, H, Dh)
    k = num.mm(x, p["wk"].reshape(d, Hkv * Dh)).reshape(B, S, Hkv, Dh)
    v = num.mm(x, p["wv"].reshape(d, Hkv * Dh)).reshape(B, S, Hkv, Dh)
    att = attention(num.op(q), num.op(k), num.op(v), cfg["attention_multiplier"])
    return num.mm(att.reshape(B, S, H * Dh), p["wo"].reshape(H * Dh, d))
