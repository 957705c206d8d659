"""Model building blocks: spec builders and apply functions (port of
``src/repro/models/layers.py``: the parts the dense, MoE, SSM, hybrid
and VLM families' decode and training paths run).

Parameters are nested dicts of tensors; every apply function takes them
and plain tensors.  The norms, both attentions and the SSD scan call the
kernel dispatch layer (``repro_torch.kernels.ops``), which launches the
CUDA kernels for CUDA tensors and runs their plain versions for CPU
tensors; the norms, the training attention and the SSD scan are
differentiable on both.  Matrix products, the MoE router and expert
products, the Mamba2 projections and its depthwise convolution are plain
torch, as the reference leaves them to XLA.  There is no sharding
(ROADMAP A.10): the reference's ``constrain`` is the identity on one
device and is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.runtime import unported
from ..kernels import ops
from ..kernels.ref import NEG_INF, compute_dtype
from .params import ParamSpec


def round_up(a: int, b: int) -> int:
    return -(-a // b) * b


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0):
    """x: (..., S, H, D) or (..., H, D) with positions broadcastable.

    Angles in f32 (f64 for an f64 ``x``), result cast back to ``x.dtype``;
    base 10000 whatever the model, as in the reference."""
    D = x.shape[-1]
    half = D // 2
    # log(base) rounded to f32 as a Python number: a tensor made on the host
    # and copied to the card would block the host on every call
    neg_log_base = -float(np.float32(math.log(base)))
    ct = compute_dtype(x)
    idx = torch.arange(half, dtype=ct, device=x.device)
    freqs = torch.exp(neg_log_base * idx / half)
    ang = positions[..., None].to(ct) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_spec(cfg) -> ParamSpec:
    return ParamSpec((cfg.d_model,), torch.float32, init="ones")


def apply_norm(w, x, kind: str = "rms", b=None):
    """``kind="rms"``: rmsnorm; anything else: layernorm with bias ``b``
    (zeros when None), as the reference.  Both with eps 1e-6."""
    if kind == "rms":
        return ops.rmsnorm(x, w)
    return ops.layernorm(x, w, b if b is not None else torch.zeros_like(w))


# ---------------------------------------------------------------------------
# attention (GQA, rope, optional window) -- training and decode paths
# ---------------------------------------------------------------------------


def attention_specs(cfg, d_model: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = d_model or cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    if cfg.head_padding()[0] != H:
        raise unported("tp_pad (q-head padding)")
    dt = cfg.param_dtype
    sp = {
        "wq": ParamSpec((d, H, Dh), dt),
        "wk": ParamSpec((d, Hkv, Dh), dt),
        "wv": ParamSpec((d, Hkv, Dh), dt),
        "wo": ParamSpec((H, Dh, d), dt),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((H, Dh), dt, init="zeros")
        sp["bk"] = ParamSpec((Hkv, Dh), dt, init="zeros")
        sp["bv"] = ParamSpec((Hkv, Dh), dt, init="zeros")
    return sp


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk"): x (..., d) by w (d, H, K)."""
    d, H, K = w.shape
    return (x @ w.reshape(d, H * K)).reshape(*x.shape[:-1], H, K)


def attention_apply(p, x, positions, *, cfg, causal=True, window: int = 0):
    """x: (B, S, d) -> (B, S, d); positions: (B, S) int32 (for RoPE).

    The reference's activation sharding constraints are the identity on
    one card, and its padded-head mask is None there, so neither is
    ported."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = rope(q, positions)
    k = rope(k, positions)
    att = ops.attention(q, k, v, causal=causal, window=window)  # (B, S, H, Dh)
    B, S, H, Dh = att.shape
    return att.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, -1)


def attention_decode(p, x, cache, pos, *, slot=None, kv_len=None):
    """One-token decode.  x: (B, d); cache: {k: (B, S, Hkv, Dh), v: ...};
    pos: (B,) int32 absolute positions (for RoPE); slot: (B,) cache write
    slots (defaults to pos); kv_len: (B,) valid cache length (defaults to
    pos + 1).

    Writes the token's K/V into ``cache`` in place (the reference returns
    a new cache) and returns ``(y, cache)``."""
    B, d = x.shape
    slot = pos if slot is None else slot
    kv_len = pos + 1 if kv_len is None else kv_len
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # rope wants (..., S, H, D): add a singleton S axis
    qr = rope(q[:, None], pos[:, None])[:, 0]
    kr = rope(k[:, None], pos[:, None])[:, 0]
    _scatter_token(cache["k"], kr, slot)
    _scatter_token(cache["v"], v, slot)
    out = ops.decode_attention(qr, cache["k"], cache["v"], kv_len.to(torch.int32))
    H, Dh = out.shape[1], out.shape[2]
    y = out.reshape(B, H * Dh) @ p["wo"].reshape(H * Dh, d)
    return y, cache


def _scatter_token(cache: torch.Tensor, token: torch.Tensor, pos: torch.Tensor) -> None:
    """cache: (B, S, H, D); token: (B, H, D); pos: (B,).  Writes
    ``cache[b, pos[b]] = token[b]`` in place, with the start index clamped
    to ``[0, S-1]`` as ``lax.dynamic_update_slice_in_dim`` clamps it (an
    index out of range would be a device-side assert on CUDA)."""
    B, S = cache.shape[0], cache.shape[1]
    idx = pos.to(torch.int64).clamp(0, S - 1)
    rows = torch.arange(B, device=cache.device)
    cache[rows, idx] = token.to(cache.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_specs(cfg) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), dt),
            "w_up": ParamSpec((d, f), dt),
            "w_down": ParamSpec((f, d), dt),
        }
    return {"w_in": ParamSpec((d, f), dt), "w_out": ParamSpec((f, d), dt)}


def mlp_apply(p, x, *, cfg):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity dispatch)
# ---------------------------------------------------------------------------


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, fe = cfg.d_model, cfg.d_expert or cfg.d_ff
    E = cfg.n_experts
    dt = cfg.param_dtype
    sp = {
        "router": ParamSpec((d, E), torch.float32),
        "w_gate": ParamSpec((E, d, fe), dt),
        "w_up": ParamSpec((E, d, fe), dt),
        "w_down": ParamSpec((E, fe, d), dt),
    }
    if cfg.n_shared:
        fs = fe * cfg.n_shared
        sp.update(
            {
                "s_gate": ParamSpec((d, fs), dt),
                "s_up": ParamSpec((d, fs), dt),
                "s_down": ParamSpec((fs, d), dt),
            }
        )
    return sp


def moe_capacity(cfg, n_tokens: int) -> int:
    """Rows an expert takes from ``n_tokens`` tokens: ``top_k x n_tokens x
    capacity_factor / n_experts`` rounded up to a multiple of 8, at least 8
    (the reference's float arithmetic, verbatim)."""
    c = int(-(-cfg.top_k * n_tokens * cfg.capacity_factor // cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def _gshard_slots(idx, *, E: int, C: int, e_lo: int, E_loc: int):
    """GShard positions, as the reference: for each choice j of idx (T, k)
    a running ``cumsum`` over the tokens, offset by ``base_count``, the
    rows the choices before j took in each expert.  Returns ``(slots,
    keeps)``, k tensors of (T,) each: the dispatch row of each (token, j)
    pair, and whether it is kept.  A pair past its expert's capacity C, or
    for an expert outside ``[e_lo, e_lo + E_loc)``, goes to the trash row
    ``E_loc * C``."""
    base_count = torch.zeros(E, dtype=torch.int64, device=idx.device)
    slots, keeps = [], []
    for j in range(idx.shape[1]):
        mask_j = F.one_hot(idx[:, j], E)
        pos_in_e = torch.cumsum(mask_j, dim=0) - mask_j
        pos_j = (pos_in_e * mask_j).sum(-1) + base_count[idx[:, j]]
        base_count = base_count + mask_j.sum(0)
        rel_e = idx[:, j] - e_lo
        mine = (pos_j < C) & (rel_e >= 0) & (rel_e < E_loc)
        slots.append(torch.where(mine, rel_e * C + pos_j, E_loc * C))
        keeps.append(mine)
    return slots, keeps


def _moe_local(p, xt, *, cfg, C: int, e_lo: int, E_loc: int):
    """Token-choice top-k over a token slab xt (T, d), computing only the
    experts ``[e_lo, e_lo + E_loc)``; returns their combined output (T, d)
    in f32 (f64 for f64 weights).  The trash row of the dropped pairs
    (:func:`_gshard_slots`) is cut before the products.  The dispatch
    buffer is built out of place, so autograd reaches xt and, through the
    gate weights, the router."""
    T, d = xt.shape
    k = cfg.top_k
    ct = compute_dtype(xt)
    logits = xt.to(ct) @ p["router"]  # (T, E)
    w, idx = ops.topk_gate(logits, k)  # (T, k)
    slots, keeps = _gshard_slots(idx, E=cfg.n_experts, C=C, e_lo=e_lo, E_loc=E_loc)

    xe = xt.new_zeros(E_loc * C + 1, d)
    for j in range(k):
        xe = xe.index_put((slots[j],), xt)
    xe = xe[: E_loc * C].reshape(E_loc, C, d)

    # the reference's einsums, outside any kernel there too
    h = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(F.silu(h) * u, p["w_down"]).to(ct)
    ye_flat = torch.cat([ye.reshape(E_loc * C, d), ye.new_zeros(1, d)], dim=0)

    y = xt.new_zeros(T, d, dtype=ct)
    for j in range(k):
        y = y + ye_flat[slots[j]] * (w[:, j] * keeps[j])[:, None]
    return y


def _shared_experts(p, xt):
    return (F.silu(xt @ p["s_gate"]) * (xt @ p["s_up"])) @ p["s_down"]


def moe_apply(p, x, *, cfg, mesh=None):
    """Capacity-based token-choice top-k MoE: x (B, S, d) -> (B, S, d),
    the reference's single-device path (all experts local, capacity from
    the B x S tokens).  The k contributions are summed in f32 in choice
    order, cast to x's dtype, then the shared experts are added.  The
    reference's expert-parallel ``shard_map`` path is not ported: a
    ``mesh`` raises ``CoxUnsupported``."""
    if mesh is not None:
        raise unported("moe_apply over a mesh (expert parallelism)")
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    C = moe_capacity(cfg, B * S)
    y = _moe_local(p, xt, cfg=cfg, C=C, e_lo=0, E_loc=cfg.n_experts)
    out = y.to(x.dtype)
    if cfg.n_shared:
        out = out + _shared_experts(p, xt)
    return out.reshape(B, S, d)


def moe_apply_dense(p, x, *, cfg):
    """Dense-dispatch oracle (exact, no capacity): every token through
    every expert, combined by its gate weights."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    ct = compute_dtype(x)
    xt = x.reshape(B * S, d)
    w, idx = ops.topk_gate(xt.to(ct) @ p["router"], k)
    combine = (w[..., None] * F.one_hot(idx, E).to(ct)).sum(1)  # (T, E)
    h = torch.einsum("td,edf->tef", xt, p["w_gate"])
    u = torch.einsum("td,edf->tef", xt, p["w_up"])
    yv = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"]).to(ct)
    out = torch.einsum("ted,te->td", yv, combine).to(x.dtype)
    if cfg.n_shared:
        out = out + _shared_experts(p, xt)
    return out.reshape(B, S, d)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


def mamba2_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di = cfg.ssm_inner
    H, N = cfg.ssm_heads, cfg.ssm_state
    dt = cfg.param_dtype
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": ParamSpec((d, 2 * di + 2 * N + H), dt),
        "conv": ParamSpec((cfg.conv_k, di + 2 * N), dt),
        "A_log": ParamSpec((H,), torch.float32, init="zeros"),
        "D": ParamSpec((H,), torch.float32, init="ones"),
        "dt_bias": ParamSpec((H,), torch.float32, init="zeros"),
        "norm": ParamSpec((di,), torch.float32, init="ones"),
        "w_out": ParamSpec((di, d), dt),
    }


def _mamba_split(cfg, proj):
    di, N = cfg.ssm_inner, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di : di + di + 2 * N]
    dt = proj[..., di + di + 2 * N :]
    return z, xBC, dt


def _causal_conv(xBC, conv, state=None):
    """Depthwise causal conv along S.  xBC: (B, S, C); conv: (K, C).  With
    ``state`` (B, K-1, C) it runs in streaming mode and returns the new
    state.  The K shifted products are summed in the input dtype, in the
    reference's order (``F.conv1d`` would accumulate otherwise)."""
    K = conv.shape[0]
    if state is None:
        xp = torch.cat([torch.zeros_like(xBC[:, : K - 1]), xBC], dim=1)
    else:
        xp = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xp[:, i : i + S] * conv[i] for i in range(K))
    new_state = xp[:, -(K - 1) :] if K > 1 else None
    return F.silu(out), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(p, xBC, dtp, cfg):
    """The scan's inputs from the conv output and the dt projection, in
    f32, as the reference builds them: ``(xh, a, Bm, Cm)``, xh the
    dt-scaled heads and a the log-decay."""
    di, N = cfg.ssm_inner, cfg.ssm_state
    xs = xBC[..., :di]
    Bm = xBC[..., di : di + N].to(torch.float32)
    Cm = xBC[..., di + N :].to(torch.float32)
    dt = _softplus(dtp.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"]) * dt  # <= 0
    xh = xs.unflatten(-1, (cfg.ssm_heads, cfg.ssm_head_dim)).to(torch.float32) * dt[..., None]
    return xh, a, Bm, Cm


def mamba2_apply(p, x, *, cfg):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    proj = x @ p["w_in"]
    z, xBC, dtp = _mamba_split(cfg, proj)
    xBC, _ = _causal_conv(xBC, p["conv"])
    xh, a, Bm, Cm = _ssm_inputs(p, xBC, dtp, cfg)
    y = ops.ssd_scan(xh, a, Bm, Cm, chunk=min(cfg.ssd_chunk, S))
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, cfg.ssm_inner).to(x.dtype)
    y = y * F.silu(z)
    y = ops.rmsnorm(y, p["norm"])
    return y @ p["w_out"]


def mamba2_decode(p, x, state, *, cfg):
    """One-token recurrent step.  x: (B, d); state: ``{"h": (B, H, N, P)
    f32, "conv": (B, K-1, C)}``.  Returns ``(y, new state)``; the state
    tensors given are not written (the caller copies the new state into
    its cache)."""
    B, _ = x.shape
    proj = x @ p["w_in"]
    z, xBC, dtp = _mamba_split(cfg, proj[:, None])
    xBC, conv_state = _causal_conv(xBC, p["conv"], state["conv"])
    z, xBC, dtp = z[:, 0], xBC[:, 0], dtp[:, 0]
    xh, a, Bm, Cm = _ssm_inputs(p, xBC, dtp, cfg)
    decay = torch.exp(a)  # (B, H)
    h = state["h"] * decay[..., None, None] + torch.einsum("bn,bhp->bhnp", Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + xh * p["D"][None, :, None]
    y = y.reshape(B, cfg.ssm_inner).to(x.dtype) * F.silu(z)
    y = ops.rmsnorm(y, p["norm"])
    return y @ p["w_out"], {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg) -> Dict[str, ParamSpec]:
    vpad = round_up(cfg.vocab, 256)
    sp = {"tok": ParamSpec((vpad, cfg.d_model), cfg.param_dtype, scale=1.0)}
    if not cfg.tie_embeddings:
        sp["unembed"] = ParamSpec((cfg.d_model, vpad), cfg.param_dtype)
    return sp


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def unembed_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    w = p.get("unembed")
    if w is None:
        w = p["tok"].t()
    return (x @ w).to(compute_dtype(x))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """logits: (B, S, Vpad) f32; labels: (B, S) int; the mean negative
    log-likelihood over the labels in ``[0, vocab)``, with the padded
    vocabulary columns masked to -1e30."""
    vpad = logits.shape[-1]
    mask = torch.arange(vpad, device=logits.device) < vocab
    logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    valid = (labels >= 0) & (labels < vocab)
    idx = torch.where(valid, labels, 0).to(torch.int64)
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    nll = torch.where(valid, lse - ll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
