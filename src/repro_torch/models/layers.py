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
torch, as the reference leaves them to XLA.

On a mesh (``rules=``, an ``AxisRules`` over a ``DeviceMesh``) the
activations and weights are DTensors, and each layer runs its local
arithmetic on this rank's shards inside ``spmd.local_call``, the port's
``shard_map``, with every change of layout an explicit redistribute
(``spmd.constrain``, the reference's ``constrain``): tensor-parallel
attention (q heads, with padded heads masked, and kv heads or the
row-parallel ``kv_embed`` fallback), column- then row-parallel MLPs,
expert-parallel MoE, a vocab-parallel embedding, unembedding,
cross-entropy and argmax, and the decode attention over a
sequence-sharded cache combined by log-sum-exp, and the Mamba2 block on
its SSM heads (its own compute layout, the parameters and caches kept at
the reference's placements).  Every apply function returns its output at
its input's placements.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..kernels import ops
from ..kernels.ref import NEG_INF, compute_dtype
from ..parallel import spmd
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
    return ParamSpec((cfg.d_model,), torch.float32, ("embed",), init="ones")


def apply_norm(w, x, kind: str = "rms", b=None, rules=None, eps: float = 1e-6):
    """``kind="rms"``: rmsnorm; anything else: layernorm with bias ``b``
    (zeros when None), as the reference.  Both with eps 1e-6 (the
    reference's) unless the model gives its own (``cfg.norm_eps``).  On a
    mesh the kernel runs on this rank's rows (any row sharding of
    ``x``)."""
    if rules is not None:
        ws = weights(rules, {"w": w} if b is None else {"w": w, "b": b})
        h = spmd.rows(x)
        out = spmd.local_call(
            lambda x, ws: apply_norm(ws["w"], x, kind, ws.get("b"), eps=eps),
            x.device_mesh,
            [h, ws],
            [h.placements, _placements(ws)],
            h.placements,
        )
        return spmd.to(out, x.placements)
    if kind == "rms":
        return ops.rmsnorm(x, w, eps)
    return ops.layernorm(x, w, b if b is not None else torch.zeros_like(w), eps)


# ---------------------------------------------------------------------------
# weights on a mesh
# ---------------------------------------------------------------------------


def _placements(tree):
    if isinstance(tree, dict):
        return {k: _placements(v) for k, v in tree.items()}
    return tuple(tree.placements)


def weights(rules, tree):
    """The weights of ``tree`` at the placements a layer computes with:
    under ``"tp"`` as they are stored, under ``"fsdp"`` gathered (the
    experts, kept sharded over "model", are placed by ``moe_apply``)."""
    if rules.strategy == "tp":
        return tree
    return {k: spmd.replicate(w) for k, w in tree.items()}


def _model_dim(t) -> Optional[int]:
    """The tensor dimension that a DTensor shards over the "model" axis
    (None when it is replicated there, or partial)."""
    i = spmd.dim_index(t.device_mesh, "model")
    if i is None:
        return None
    p = t.placements[i]
    return p.dim if p.is_shard() else None


def _partial_over_model(placements, mesh):
    from torch.distributed.tensor import Partial

    return spmd.with_axis(placements, mesh, "model", Partial())


# ---------------------------------------------------------------------------
# attention (GQA, rope, optional window) -- training and decode paths
# ---------------------------------------------------------------------------


def attention_specs(cfg, d_model: Optional[int] = None) -> Dict[str, ParamSpec]:
    """The attention weights, with the reference's logical axes.  With
    ``cfg.tp_pad`` the q heads are padded inside each kv group to Hp
    (``cfg.head_padding``), so that they divide the tensor-parallel
    degree; the KV projections are column-parallel over kv heads when
    Hkv divides it, else row-parallel over d_model (``kv_embed``)."""
    d = d_model or cfg.d_model
    Hp, _, _ = cfg.head_padding()
    Hkv, Dh = cfg.n_kv, cfg.d_head
    dt = cfg.param_dtype
    kv_col = (not cfg.tp_pad) or (Hkv % cfg.tp_pad == 0)
    kv_axes = ("embed", "kv_heads", None) if kv_col else ("kv_embed", None, None)
    sp = {
        "wq": ParamSpec((d, Hp, Dh), dt, ("embed", "heads", None)),
        "wk": ParamSpec((d, Hkv, Dh), dt, kv_axes),
        "wv": ParamSpec((d, Hkv, Dh), dt, kv_axes),
        "wo": ParamSpec((Hp, Dh, d), dt, ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((Hp, Dh), dt, ("heads", None), init="zeros")
        sp["bk"] = ParamSpec((Hkv, Dh), dt, ("kv_heads", None), init="zeros")
        sp["bv"] = ParamSpec((Hkv, Dh), dt, ("kv_heads", None), init="zeros")
    return sp


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk"): x (..., d) by w (d, H, K)."""
    d, H, K = w.shape
    return (x @ w.reshape(d, H * K)).reshape(*x.shape[:-1], H, K)


def _head_mask(cfg, lo: int, n: int, device):
    """(n,) validity of the q heads ``[lo, lo + n)`` of the padded layout
    (the reference's ``_head_mask``): a padded slot of a kv group
    contributes zero before the output projection, so padded execution
    equals the true architecture.  None when nothing is padded."""
    Hp, gp, g = cfg.head_padding()
    if Hp == cfg.n_heads:
        return None
    return (torch.arange(lo, lo + n, device=device) % gp) < g


def _apply_mask(att: torch.Tensor, mask, head_dim: int) -> torch.Tensor:
    if mask is None:
        return att
    shape = [1] * att.dim()
    shape[head_dim] = mask.shape[0]
    return att * mask.reshape(shape).to(att.dtype)


def _kv_for_heads(k, v, cfg, h_lo: int, n: int, kv_lo: int):
    """The K and V that the q heads ``[h_lo, h_lo + n)`` read, given the kv
    heads ``[kv_lo, kv_lo + k.shape[-2])``: as they are when those heads
    form whole groups of their own, else one kv head per q head (q head h
    reads kv head ``h // gp``)."""
    _, gp, _ = cfg.head_padding()
    nkv = k.shape[-2]
    if h_lo % gp == 0 and n == gp * nkv and h_lo // gp == kv_lo:
        return k, v
    idx = torch.div(torch.arange(h_lo, h_lo + n, device=k.device), gp, rounding_mode="floor") - kv_lo
    return k.index_select(-2, idx), v.index_select(-2, idx)


class _Heads:
    """Which heads this rank holds on a mesh: ``n`` q heads from ``lo``
    (all Hp when the q heads are not sharded), and the kv layout: ``"col"``
    (kv heads sharded with them, ``kv_n`` from ``kv_lo``), ``"row"``
    (``kv_embed``: K and V come out partial over "model" and are reduced)
    or ``"full"``."""

    def __init__(self, cfg, w, mesh):
        Hp, _, _ = cfg.head_padding()
        tp, r = spmd.axis_size(mesh, "model"), spmd.axis_rank(mesh, "model")
        sharded = _model_dim(w["wq"]) == 1
        self.n = Hp // tp if sharded else Hp
        self.lo = r * self.n if sharded else 0
        kd = _model_dim(w["wk"])
        self.kv = {1: "col", 0: "row", None: "full"}[kd]
        self.kv_n = cfg.n_kv // tp if self.kv == "col" else cfg.n_kv
        self.kv_lo = r * self.kv_n if self.kv == "col" else 0
        d = w["wk"].shape[0]
        self.d_lo, self.d_n = (r * (d // tp), d // tp) if self.kv == "row" else (0, d)
        self.sharded = sharded


def _kv_local(x, wk, wv, d_lo: int, d_n: int):
    """K and V from x's columns ``[d_lo, d_lo + d_n)`` (all of them unless
    the KV projections are row-parallel, when they are partial sums)."""
    xs = x if d_n == x.shape[-1] else x[..., d_lo : d_lo + d_n]
    return _project(xs, wk), _project(xs, wv)


def _attention_core(p, x, positions, cfg, causal, window, lo=0, kv_lo=0, k=None, v=None):
    """The attention of the q heads ``p["wq"]`` holds (from global head
    ``lo``) and its output projection; K and V are projected here unless
    given (reduced from a row-parallel projection, biases not yet
    added)."""
    q = _project(x, p["wq"])
    if k is None:
        k = _project(x, p["wk"])
        v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.position_embedding_type != "nope":
        q = rope(q, positions)
        k = rope(k, positions)
    H = q.shape[-2]
    k, v = _kv_for_heads(k, v, cfg, lo, H, kv_lo)
    scale = cfg.attention_multiplier or None
    att = ops.attention(q, k, v, causal=causal, window=window, scale=scale)  # (B, S, H, Dh)
    att = _apply_mask(att, _head_mask(cfg, lo, H, att.device), 2)
    B, S, _, Dh = att.shape
    return att.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, -1)


def attention_apply(p, x, positions, *, cfg, rules=None, causal=True, window: int = 0):
    """x: (B, S, d) -> (B, S, d); positions: (B, S) int32 (for RoPE), or
    (1, S) when every row takes the same.  Padded q heads (``cfg.tp_pad``)
    are masked before ``wo``.  With ``cfg.position_embedding_type ==
    "nope"`` no rotary embedding is applied, and a nonzero
    ``cfg.attention_multiplier`` is the logits' scale in place of
    ``1/sqrt(Dh)``.

    On a mesh the input is gathered to ``("batch", None, "embed")``, every
    rank runs ``flash_attention`` on its q heads over the whole sequence,
    and ``wo``'s output (partial over "model" when the heads are sharded)
    goes back to ``x``'s placements: a reduce-scatter onto the sequence
    slabs of the residual stream."""
    if rules is None:
        return _attention_core(p, x, positions, cfg, causal, window)
    mesh = x.device_mesh
    h = spmd.constrain(x, rules, ("batch", None, None))
    w = weights(rules, p)
    hd = _Heads(cfg, w, mesh)
    k = v = None
    if hd.kv == "row":
        kv_pl = _partial_over_model(h.placements, mesh)
        k, v = spmd.local_call(
            lambda x, wk, wv: _kv_local(x, wk, wv, hd.d_lo, hd.d_n),
            mesh,
            [h, w["wk"], w["wv"]],
            [h.placements, w["wk"].placements, w["wv"].placements],
            (kv_pl, kv_pl),
        )
        full = spmd.with_axis(h.placements, mesh, "model", _replicate())
        k, v = spmd.to(k, full), spmd.to(v, full)
    core = {n: w[n] for n in ("wq", "wo", "bq", "bk", "bv") if n in w}
    if k is None:
        core.update(wk=w["wk"], wv=w["wv"])
    out_pl = _partial_over_model(h.placements, mesh) if hd.sharded else h.placements
    out = spmd.local_call(
        lambda x, ws, k, v: _attention_core(ws, x, positions, cfg, causal, window, hd.lo, hd.kv_lo, k, v),
        mesh,
        [h, core, k, v],
        [h.placements, _placements(core), None if k is None else k.placements, None if v is None else v.placements],
        out_pl,
    )
    return spmd.to(out, x.placements)


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def attention_decode(p, x, cache, pos, *, cfg=None, rules=None, slot=None, kv_len=None):
    """One-token decode.  x: (B, d); cache: {k: (B, S, Hkv, Dh), v: ...};
    pos: (B,) int32 absolute positions (for RoPE); slot: (B,) cache write
    slots (defaults to pos); kv_len: (B,) valid cache length (defaults to
    pos + 1).  ``cfg`` masks padded q heads (none without it).

    Writes the token's K/V into ``cache`` in place (the reference returns
    a new cache) and returns ``(y, cache)``.

    On a mesh the cache is sharded on its sequence over "model" (the
    reference's ``seq_kv``): every model rank holds a slab of ``S / tp``
    rows of all kv heads.  The new token's q, K and V are gathered over
    "model", the rank whose slab holds the (clamped) slot writes K and V,
    ``flash_decode`` runs over each slab with its share of ``kv_len`` and
    returns its log-sum-exp, and the slabs' outputs are combined by it in
    rank order (a slab with no visible row weighs 0; a row with
    ``kv_len = 0`` gives zeros).  ``wo`` is row-parallel over the q heads
    and its output is reduced over "model"."""
    if rules is not None:
        return _attention_decode_mesh(p, x, cache, pos, cfg, rules, slot, kv_len)
    B, d = x.shape
    slot = pos if slot is None else slot
    kv_len = pos + 1 if kv_len is None else kv_len
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    out = _decode_whole(q, k, v, pos, slot, kv_len, cache["k"], cache["v"])
    H, Dh = out.shape[1], out.shape[2]
    if cfg is not None:
        out = _apply_mask(out, _head_mask(cfg, 0, H, out.device), 1)
    y = out.reshape(B, H * Dh) @ p["wo"].reshape(H * Dh, d)
    return y, cache


def _rope_token(q, k, pos):
    """RoPE on one token's (B, H, D) q and K; rope wants (..., S, H, D),
    so a singleton S axis is added and dropped."""
    return rope(q[:, None], pos[:, None])[:, 0], rope(k[:, None], pos[:, None])[:, 0]


def _decode_whole(q, k, v, pos, slot, kv_len, kc, vc):
    """RoPE, the token's K and V written at ``slot``, and ``flash_decode``
    over the whole cache (no mesh, or a cache not split on its sequence)."""
    qr, kr = _rope_token(q, k, pos)
    _scatter_token(kc, kr, slot)
    _scatter_token(vc, v, slot)
    return ops.decode_attention(qr, kc, vc, kv_len.to(torch.int32))


def combine_slabs(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over a whole cache from its slabs' (n, B, H, D)
    outputs and (n, B, H) f32 log-sum-exps, summed in slab order in f32:
    each slab weighs ``exp(lse - max lse)``; a slab with no visible row
    (lse = -inf) weighs 0, and a row whose slabs are all empty gives
    zeros."""
    m = lses.amax(dim=0)
    m = torch.where(torch.isinf(m), 0.0, m)
    w = torch.where(torch.isinf(lses), 0.0, torch.exp(lses - m))
    num = (w[..., None] * outs.to(torch.float32)).sum(dim=0)
    den = w.sum(dim=0)[..., None]
    return (num / torch.where(den == 0.0, 1.0, den)).to(outs.dtype)


def _slab_decode(q, k, v, b, pos, slot, kv_len, kc, vc, r: int, n_slabs: int, S: int):
    """One rank's part of the mesh decode: the K and V biases of a
    row-parallel projection (``b``, added after its reduction), RoPE, the
    write into its slab ``r`` of ``n_slabs`` (rows ``[r * Sl, (r + 1) *
    Sl)`` of S), and ``flash_decode`` over the slab; ``(out, lse)`` with a
    leading slab axis when the cache is split, else the output alone."""
    if b:
        k, v = k + b["bk"], v + b["bv"]
    if n_slabs == 1:
        return _decode_whole(q, k, v, pos, slot, kv_len, kc, vc)
    qr, kr = _rope_token(q, k, pos)
    Sl = kc.shape[1]
    rows = torch.arange(kc.shape[0], device=kc.device)
    loc = slot.to(torch.int64).clamp(0, S - 1) - r * Sl  # past the context: row S-1
    mine = ((loc >= 0) & (loc < Sl))[:, None, None]
    idx = loc.clamp(0, Sl - 1)
    kc[rows, idx] = torch.where(mine, kr.to(kc.dtype), kc[rows, idx])
    vc[rows, idx] = torch.where(mine, v.to(vc.dtype), vc[rows, idx])
    n = (kv_len.to(torch.int64) - r * Sl).clamp(0, Sl).to(torch.int32)
    out, lse = ops.decode_attention(qr, kc, vc, n, return_lse=True)
    return out[None], lse[None]


def _attention_decode_mesh(p, x, cache, pos, cfg, rules, slot, kv_len):
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    slot = pos if slot is None else slot
    kv_len = pos + 1 if kv_len is None else kv_len
    w = weights(rules, p)
    hd = _Heads(cfg, w, mesh)
    x_pl = tuple(x.placements)
    x = spmd.rows(x)
    xp = tuple(x.placements)
    q_pl = spmd.with_axis(xp, mesh, "model", Shard(1)) if hd.sharded else xp
    kv_pl = {"col": spmd.with_axis(xp, mesh, "model", Shard(1)), "row": _partial_over_model(xp, mesh), "full": xp}[hd.kv]
    ws = {n: w[n] for n in ("wq", "wk", "wv", "bq", "bk", "bv") if n in w}
    b = {}
    if hd.kv == "row" and "bk" in ws:  # added once K and V are reduced
        b = {n: spmd.replicate(ws.pop(n)) for n in ("bk", "bv")}

    def project(x, ws):
        q = _project(x, ws["wq"])
        k, v = _kv_local(x, ws["wk"], ws["wv"], hd.d_lo, hd.d_n)
        if "bq" in ws:  # the biases sharded as their heads are
            q = q + ws["bq"]
        if "bk" in ws:
            k, v = k + ws["bk"], v + ws["bv"]
        return q, k, v

    q, k, v = spmd.local_call(project, mesh, [x, ws], [xp, _placements(ws)], (q_pl, kv_pl, kv_pl))
    B = q.shape[0]
    tgt = spmd.act_placements(rules, tuple(q.shape), ("batch", None, None))
    q, k, v = spmd.to(q, tgt), spmd.to(k, tgt), spmd.to(v, tgt)
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    n_slabs, r = _slabs(mesh, kc)
    bpl = spmd.act_placements(rules, (B,), ("batch",))
    res = spmd.local_call(
        lambda q, k, v, b, pos, slot, kv_len, kc, vc: _slab_decode(q, k, v, b, pos, slot, kv_len, kc, vc, r, n_slabs, S),
        mesh,
        [q, k, v, b, pos, slot, kv_len, kc, vc],
        [tgt, tgt, tgt, _placements(b), bpl, bpl, bpl, tuple(kc.placements), tuple(vc.placements)],
        _slab_out_placements(mesh, tgt, n_slabs),
    )
    y = _combine_and_project(res, n_slabs, w["wo"], hd, mesh, xp, cfg)
    return spmd.to(y, x_pl), cache


def _slabs(mesh, kc):
    """``(n_slabs, r)``: how many sequence slabs over "model" a decode
    cache ``kc`` (B, S, Hkv, Dh) is cut into, and this rank's."""
    if _model_dim(kc) != 1:
        return 1, 0
    n = spmd.axis_size(mesh, "model")
    return n, (spmd.axis_rank(mesh, "model") if n > 1 else 0)


def _slab_out_placements(mesh, tgt, n_slabs: int):
    """The placements of a slab decode's output (``tgt``), or of its
    ``(out, lse)`` with a leading slab axis sharded over "model"."""
    from torch.distributed.tensor import Shard

    if n_slabs == 1:
        return tgt
    # the (B, Hp) lse is sharded on its batch as the (B, Hp, Dh) output is
    pl = spmd.with_axis(spmd.shift(tgt), mesh, "model", Shard(0))
    return pl, pl


def _combine_and_project(res, n_slabs: int, wo, hd, mesh, xp, cfg, mask: bool = True):
    """The slabs' outputs combined by their log-sum-exps (gathered over
    "model"), the padded q heads masked (``mask``), and ``wo``
    row-parallel over the q heads (partial over "model" when they are
    sharded)."""
    wo_pl = _partial_over_model(xp, mesh) if hd.sharded else xp
    Dh = wo.shape[1]

    def finish(att, lses, wo):
        if lses is not None:
            att = combine_slabs(att, lses)
        if mask:
            att = _apply_mask(att, _head_mask(cfg, 0, att.shape[1], att.device), 1)
        if hd.sharded:
            att = att[:, hd.lo : hd.lo + hd.n]
        return att.reshape(att.shape[0], hd.n * Dh) @ wo.reshape(hd.n * Dh, -1)

    if n_slabs == 1:
        args, exp = [res, None, wo], [tuple(res.placements), None, tuple(wo.placements)]
    else:
        att, lses = (spmd.to(t, spmd.with_axis(t.placements, mesh, "model", _replicate())) for t in res)
        args, exp = [att, lses, wo], [tuple(att.placements), tuple(lses.placements), tuple(wo.placements)]
    return spmd.local_call(finish, mesh, args, exp, wo_pl)


def cross_decode(p, x, mem, kv_len, *, cfg=None, rules=None):
    """One token's cross-attention over precomputed memory keys and values
    ``mem = {"k", "v"}`` (B, Se, Hkv, Dh), every row visible: no rotary
    embedding, bias or head mask, as the reference's encoder-decoder
    decode.  kv_len: (B,) int32, the memory's rows (``enc_len``), built
    once a step by the caller.  On a mesh the memory is a cache leaf
    sharded on its rows over "model" (``seq_kv``) and kv_len is sharded on
    the batch as ``pos`` is: the token's q is gathered over its heads,
    ``flash_decode`` runs over each rank's slab with its log-sum-exp, and
    the slabs are combined and ``wo`` applied as in
    :func:`attention_decode`."""
    B = x.shape[0]
    if rules is None:
        q = _project(x, p["wq"])
        att = ops.decode_attention(q, mem["k"], mem["v"], kv_len)
        return att.reshape(B, -1) @ p["wo"].reshape(-1, x.shape[1])
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    w = weights(rules, {"wq": p["wq"], "wo": p["wo"]})
    hd = _Heads(cfg, {**w, "wk": p["wk"]}, mesh)
    x_pl = tuple(x.placements)
    x = spmd.rows(x)
    xp = tuple(x.placements)
    q_pl = spmd.with_axis(xp, mesh, "model", Shard(1)) if hd.sharded else xp
    q = spmd.local_call(_project, mesh, [x, w["wq"]], [xp, tuple(w["wq"].placements)], q_pl)
    tgt = spmd.act_placements(rules, tuple(q.shape), ("batch", None, None))
    q = spmd.to(q, tgt)
    kc, vc = mem["k"], mem["v"]
    n_slabs, r = _slabs(mesh, kc)
    bpl = spmd.act_placements(rules, (B,), ("batch",))

    def read(q, kv_len, kc, vc):
        if n_slabs == 1:
            return ops.decode_attention(q, kc, vc, kv_len)
        Sl = kc.shape[1]
        n = (kv_len.to(torch.int64) - r * Sl).clamp(0, Sl).to(torch.int32)
        out, lse = ops.decode_attention(q, kc, vc, n, return_lse=True)
        return out[None], lse[None]

    res = spmd.local_call(
        read, mesh, [q, kv_len, kc, vc], [tgt, bpl, tuple(kc.placements), tuple(vc.placements)],
        _slab_out_placements(mesh, tgt, n_slabs),
    )
    y = _combine_and_project(res, n_slabs, w["wo"], hd, mesh, xp, cfg, mask=False)
    return spmd.to(y, x_pl)


def cross_attention_apply(p, x, mem, *, cfg, rules=None):
    """Cross-attention of the queries x (B, S, d) over the memory rows mem
    (B, Se, d): K and V projected from the memory, non-causal, with no
    rotary embedding, bias or head mask, as the reference's
    ``_cross_attend``.  On a mesh both are gathered to ``("batch", None,
    "embed")`` and every model rank attends with its q heads over the
    whole memory, its K and V projected as :func:`attention_apply` does
    (column-parallel over kv heads, or row-parallel and reduced); ``wo``'s
    partial output goes back to ``x``'s placements."""

    def core(ws, x, mem, k, v, lo=0, kv_lo=0):
        q = _project(x, ws["wq"])
        if k is None:
            k, v = _project(mem, ws["wk"]), _project(mem, ws["wv"])
        k, v = _kv_for_heads(k, v, cfg, lo, q.shape[-2], kv_lo)
        att = ops.attention(q, k, v, causal=False)
        B, S, H, Dh = att.shape
        return att.reshape(B, S, H * Dh) @ ws["wo"].reshape(H * Dh, -1)

    if rules is None:
        return core(p, x, mem, None, None)
    mesh = x.device_mesh
    h = spmd.constrain(x, rules, ("batch", None, None))
    m = spmd.constrain(mem, rules, ("batch", None, None))
    w = weights(rules, {n: p[n] for n in ("wq", "wk", "wv", "wo")})
    hd = _Heads(cfg, w, mesh)
    k = v = None
    core_w = {n: w[n] for n in ("wq", "wo")}
    if hd.kv == "row":
        kv_pl = _partial_over_model(m.placements, mesh)
        k, v = spmd.local_call(
            lambda x, wk, wv: _kv_local(x, wk, wv, hd.d_lo, hd.d_n),
            mesh,
            [m, w["wk"], w["wv"]],
            [m.placements, w["wk"].placements, w["wv"].placements],
            (kv_pl, kv_pl),
        )
        full = spmd.with_axis(m.placements, mesh, "model", _replicate())
        k, v = spmd.to(k, full), spmd.to(v, full)
    else:
        core_w.update(wk=w["wk"], wv=w["wv"])
    out_pl = _partial_over_model(h.placements, mesh) if hd.sharded else h.placements
    out = spmd.local_call(
        lambda x, mem, ws, k, v: core(ws, x, mem, k, v, hd.lo, hd.kv_lo),
        mesh,
        [h, m, core_w, k, v],
        [h.placements, m.placements, _placements(core_w), None if k is None else k.placements, None if v is None else v.placements],
        out_pl,
    )
    return spmd.to(out, x.placements)


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
            "w_gate": ParamSpec((d, f), dt, ("embed", "mlp")),
            "w_up": ParamSpec((d, f), dt, ("embed", "mlp")),
            "w_down": ParamSpec((f, d), dt, ("mlp", "embed")),
        }
    return {
        "w_in": ParamSpec((d, f), dt, ("embed", "mlp")),
        "w_out": ParamSpec((f, d), dt, ("mlp", "embed")),
    }


def _mlp_local(p, x, cfg):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


def mlp_apply(p, x, *, cfg, rules=None):
    """On a mesh: column-parallel in, row-parallel out over "model" (the
    hidden width sharded), the input gathered to ``("batch", None,
    "embed")`` and the partial output sent back to ``x``'s placements."""
    if rules is None:
        return _mlp_local(p, x, cfg)
    mesh = x.device_mesh
    h = spmd.constrain(x, rules, ("batch",) + (None,) * (x.dim() - 1))
    w = weights(rules, p)
    first = w["w_gate"] if cfg.act == "swiglu" else w["w_in"]
    out_pl = _partial_over_model(h.placements, mesh) if _model_dim(first) == 1 else h.placements
    out = spmd.local_call(
        lambda x, w: _mlp_local(w, x, cfg), mesh, [h, w], [h.placements, _placements(w)], out_pl
    )
    return spmd.to(out, x.placements)


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k: capacity dispatch, or dropless
# over a held share of the experts)
# ---------------------------------------------------------------------------


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    """The router over all ``n_experts``, the weights of the experts held
    here (``cfg.held_experts()``: all of them unless ``experts_held``
    says fewer) and the shared expert's, of width ``cfg.shared_width()``."""
    d, fe = cfg.d_model, cfg.d_expert or cfg.d_ff
    E, Eh = cfg.n_experts, cfg.held_experts()
    dt = cfg.param_dtype
    sp = {
        "router": ParamSpec((d, E), torch.float32, ("embed", None)),
        "w_gate": ParamSpec((Eh, d, fe), dt, ("experts", "embed", None)),
        "w_up": ParamSpec((Eh, d, fe), dt, ("experts", "embed", None)),
        "w_down": ParamSpec((Eh, fe, d), dt, ("experts", None, "embed")),
    }
    fs = cfg.shared_width()
    if fs:
        sp.update(
            {
                "s_gate": ParamSpec((d, fs), dt, ("embed", "mlp")),
                "s_up": ParamSpec((d, fs), dt, ("embed", "mlp")),
                "s_down": ParamSpec((fs, d), dt, ("mlp", "embed")),
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


def moe_apply(p, x, *, cfg, rules=None):
    """Capacity-based token-choice top-k MoE: x (B, S, d) -> (B, S, d).
    Without rules, the reference's single-device path: all experts local,
    capacity from the B x S tokens; the k contributions are summed in f32
    in choice order, cast to x's dtype, then the shared experts are added.

    With rules on a mesh that has a "model" axis (even of size 1), the
    reference's expert-parallel path: the tokens stay sharded over the
    batch axes when B divides them (else every rank takes them all), every
    model rank runs its slice of ``E / tp`` experts on its token slab with
    the capacity of that slab (so a mesh can drop tokens that one device
    keeps), and the partial outputs are summed over "model" in f32, then
    cast; the shared experts run outside, column- then row-parallel.
    Where the experts do not divide "model", the rules replicate them and
    every model rank runs all of them on its slab (data-parallel over
    "model", the Mamba2 block's rule); the reference asserts there.  No
    published configuration takes that branch (their expert counts divide
    16); the 4-expert smoke configurations on a 16 x 16 dry run do."""
    if rules is None or "model" not in rules.shape:
        if rules is not None:
            raise ValueError("moe_apply on a mesh needs a 'model' axis")
        return _moe_apply_local(p, x, cfg)
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    B, S, d = x.shape
    E = cfg.n_experts
    tp, r = spmd.axis_size(mesh, "model"), spmd.axis_rank(mesh, "model")
    ep = E % tp == 0  # the rules shard the experts over "model"
    E_loc = E // tp if ep else E
    names = mesh.mesh_dim_names
    dp = 1
    for a in ("pod", "data"):
        dp *= spmd.axis_size(mesh, a)
    xpl = tuple(
        Shard(0) if n in ("pod", "data") and B % dp == 0 else Replicate() for n in names
    )
    xl = spmd.to(x, xpl)
    ew = tuple(Shard(0) if n == "model" and ep else Replicate() for n in names)
    ws = {n: spmd.to(p[n], ew) for n in ("w_gate", "w_up", "w_down")}
    ws["router"] = spmd.replicate(p["router"])

    sw = {}
    if cfg.n_shared:
        sw = weights(rules, {n: p[n] for n in ("s_gate", "s_up", "s_down")})
    # shared experts sharded over "model" ("tp") run in the routed experts'
    # local function, so the input's gradient sums its uses in the
    # one-device order; gathered ("fsdp"), every model rank computes them
    # whole, apart (their gradient is not partial over "model")
    # (with the experts replicated, the routed products' gradients are
    # whole on every model rank, so the sharded shared experts run apart)
    sw_split = bool(sw) and _model_dim(sw["s_gate"]) == 1
    together = sw_split and ep
    part = _partial_over_model(xpl, mesh)

    def local(xb, ws, sw):
        Bl, Sl, _ = xb.shape
        xt = xb.reshape(Bl * Sl, d)
        C = moe_capacity(cfg, Bl * Sl)
        y = _moe_local(ws, xt, cfg=cfg, C=C, e_lo=r * E_loc if ep else 0, E_loc=E_loc).reshape(Bl, Sl, d)
        return (y, _shared_experts(sw, xt).reshape(Bl, Sl, d)) if sw else (y,)

    def shared(xb, sw):
        Bl, Sl, _ = xb.shape
        return _shared_experts(sw, xb.reshape(Bl * Sl, d)).reshape(Bl, Sl, d)

    inner = sw if together else {}
    outs = spmd.local_call(
        local, mesh, [xl, ws, inner], [xpl, _placements(ws), _placements(inner)],
        (part if ep else xpl, part)[: 1 + together],
    )
    out = spmd.to(outs[0], xpl).to(x.dtype)
    if together:
        out = out + spmd.to(outs[1], xpl)
    elif sw:
        out = out + spmd.to(spmd.local_call(shared, mesh, [xl, sw], [xpl, _placements(sw)], part if sw_split else xpl), xpl)
    return spmd.to(out, x.placements)


def _moe_apply_local(p, x, cfg):
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if cfg.dropless:
        out = moe_held(p, xt, cfg=cfg)
    else:
        C = moe_capacity(cfg, B * S)
        out = _moe_local(p, xt, cfg=cfg, C=C, e_lo=0, E_loc=cfg.n_experts).to(x.dtype)
    if cfg.shared_width():
        out = out + _shared_experts(p, xt)
    return out.reshape(B, S, d)


def moe_held(p, xt, *, cfg, e_lo: int = 0):
    """Dropless token-choice top-k over a token slab xt (T, d): the router
    (``p["router"]``, f32) scores all ``n_experts``, each token keeps its
    top ``k`` with a softmax over the k chosen logits, and the experts
    held here, ``[e_lo, e_lo + E_loc)`` with E_loc the first dimension of
    ``p["w_gate"]``, give every token routed to them their SwiGLU
    weighted by its gate, with no capacity.  Pairs to the other experts
    add nothing: their cards' part of the sum.  Returns (T, d) in xt's
    dtype.

    The held experts run as one: every token through all E_loc of them
    at once, three products over the experts' concatenated widths, with
    each expert's hidden activation scaled by the token's gate for it (0
    where the token did not choose it), so the last product sums a
    token's contributions in its f32 accumulator.  That computes E_loc
    rows a token where top_k x E_loc / n_experts are routed (1.25 of 9
    for granite-4.0-h), but no shape depends on the routing: no read from
    the device, no gather, no atomic sum, the same work on every step.
    Spans: ``moe.route`` (router and top-k; trace only) and
    ``moe.experts`` (the held experts' products) with its counters, left
    on the device: ``rows``, the pairs routed to the held experts, and
    ``max_rows``, the largest expert's."""
    T, d = xt.shape
    E_loc, _, fe = p["w_gate"].shape
    with obs.span("moe.route"):
        w, idx = ops.topk_gate(xt.to(compute_dtype(xt)) @ p["router"], cfg.top_k)  # (T, k)
        rel = idx - e_lo
        col = torch.where((rel >= 0) & (rel < E_loc), rel, E_loc)  # choices held elsewhere: a spare column
        gates = w.new_zeros(T, E_loc + 1).scatter_add(1, col, w)[:, :E_loc]  # (T, E_loc)
    with obs.span("moe.experts"):
        if obs.recording_now():
            routed = (gates > 0).sum(0)
            obs.count(rows=routed.sum(), max_rows=routed.max())
        h = xt @ p["w_gate"].permute(1, 0, 2).reshape(d, E_loc * fe)
        u = xt @ p["w_up"].permute(1, 0, 2).reshape(d, E_loc * fe)
        hid = (F.silu(h) * u).view(T, E_loc, fe) * gates.to(xt.dtype)[:, :, None]
        return hid.view(T, E_loc * fe) @ p["w_down"].reshape(E_loc * fe, d)


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
    sp = {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": ParamSpec((d, 2 * di + 2 * N + H), dt, ("embed", "ssm_inner")),
        "conv": ParamSpec((cfg.conv_k, di + 2 * N), dt, (None, "ssm_inner")),
        "A_log": ParamSpec((H,), torch.float32, (None,), init="zeros"),
        "D": ParamSpec((H,), torch.float32, (None,), init="ones"),
        "dt_bias": ParamSpec((H,), torch.float32, (None,), init="zeros"),
        "norm": ParamSpec((di,), torch.float32, ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((di, d), dt, ("ssm_inner", "embed")),
    }
    if cfg.mamba_conv_bias:
        sp["conv_b"] = ParamSpec((di + 2 * N,), dt, ("ssm_inner",), init="zeros")
    return sp


def _mamba_split(proj, n: int, P: int, N: int):
    """``(z, xBC, dt)`` of a projection laid out for ``n`` heads of width
    P: ``z (nP) | x (nP) | B | C (2N) | dt (n)``."""
    di = n * P
    return proj[..., :di], proj[..., di : 2 * di + 2 * N], proj[..., 2 * di + 2 * N :]


def _causal_conv(xBC, conv, state=None, bias=None):
    """Depthwise causal conv along S.  xBC: (B, S, C); conv: (K, C); bias
    (C,) or None.  With ``state`` (B, K-1, C) it runs in streaming mode
    and returns the new state.  The K shifted products are summed in the
    input dtype, in the reference's order (``F.conv1d`` would accumulate
    otherwise), and the bias added last."""
    K = conv.shape[0]
    if state is None:
        xp = torch.cat([torch.zeros_like(xBC[:, : K - 1]), xBC], dim=1)
    else:
        xp = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xp[:, i : i + S] * conv[i] for i in range(K))
    if bias is not None:
        out = out + bias
    new_state = xp[:, -(K - 1) :] if K > 1 else None
    return F.silu(out), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(hp, xBC, dtp, n: int, P: int, N: int):
    """The scan's inputs for ``n`` heads from the conv output and the dt
    projection, in f32, as the reference builds them: ``(xh, a, Bm,
    Cm)``, xh the dt-scaled heads and a the log-decay; ``hp`` holds those
    heads' ``A_log`` and ``dt_bias``."""
    di = n * P
    xs = xBC[..., :di]
    Bm = xBC[..., di : di + N].to(torch.float32)
    Cm = xBC[..., di + N :].to(torch.float32)
    dt = _softplus(dtp.to(torch.float32) + hp["dt_bias"])
    a = -torch.exp(hp["A_log"]) * dt  # <= 0
    xh = xs.unflatten(-1, (n, P)).to(torch.float32) * dt[..., None]
    return xh, a, Bm, Cm


def _spans_take(t: torch.Tensor, spans, dim: int) -> torch.Tensor:
    """The ``[lo, hi)`` spans of ``t`` along ``dim``, concatenated (``t``
    itself when they cover it in order)."""
    merged = []
    for lo, hi in spans:
        if merged and merged[-1][1] == lo:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    if merged == [(0, t.shape[dim])]:
        return t
    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in merged], dim=dim)


def _head_spans(cfg, lo: int, n: int, with_z: bool):
    """The columns that heads ``[lo, lo + n)`` read: of ``w_in`` (``z | x |
    B | C | dt``: their z, x and dt columns and all of B and C) with
    ``with_z``, else of ``conv`` and the conv tail (``x | B | C``)."""
    di, N, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim
    a, b = lo * P, (lo + n) * P
    if not with_z:
        return [(a, b), (di, di + 2 * N)]
    dt0 = 2 * di + 2 * N
    return [(a, b), (di + a, di + b), (2 * di, dt0), (dt0 + lo, dt0 + lo + n)]


def _mamba_gated(hp, proj, conv, cfg, dtype, conv_b=None):
    """The block from its projection (laid out for the heads of ``hp``:
    ``A_log``, ``D`` and ``dt_bias``, and of ``conv`` and its bias
    ``conv_b``) to the gated output (B, S, nP) in ``dtype``, before the
    norm.  D multiplies the dt-scaled heads (the reference's skip) or,
    with ``cfg.ssm_skip == "x"``, the heads themselves (Mamba2's)."""
    n, P, N = hp["D"].shape[0], cfg.ssm_head_dim, cfg.ssm_state
    z, xBC, dtp = _mamba_split(proj, n, P, N)
    xBC, _ = _causal_conv(xBC, conv, bias=conv_b)
    xh, a, Bm, Cm = _ssm_inputs(hp, xBC, dtp, n, P, N)
    B, S = proj.shape[0], proj.shape[1]
    y = ops.ssd_scan(xh, a, Bm, Cm, chunk=min(cfg.ssd_chunk, S))
    skip = xBC[..., : n * P].unflatten(-1, (n, P)).to(torch.float32) if cfg.ssm_skip == "x" else xh
    y = y + skip * hp["D"][None, None, :, None]
    y = y.reshape(B, S, n * P).to(dtype)
    return y * F.silu(z)


def mamba2_apply(p, x, *, cfg, rules=None):
    """x: (B, S, d) -> (B, S, d).

    On a mesh the parameters stay at the reference's placements (``w_in``
    and ``conv`` on ``ssm_inner`` over their concatenated columns, which a
    shard cuts across the parts) and the block computes in its own layout:
    under ``"tp"`` with the SSM heads dividing the "model" axis, each
    model rank runs ``ssd_scan`` on its H/tp heads over the whole
    sequence, from ``w_in`` and ``conv`` gathered and cut to its heads'
    columns (z, x and dt by heads, B and C whole); the gated output is
    gathered to whole rows for the norm, and ``w_out`` is row-parallel,
    its partial output reduce-scattered onto ``x``'s sequence slabs.
    (Gathering the weight, not the projection: a layer's ``w_in`` is
    smaller than its B x S x (2di + 2N + H) projection at training
    lengths.)"""
    if rules is not None:
        return _mamba2_mesh(p, x, cfg, rules)
    proj = x @ p["w_in"]
    y = _mamba_gated(p, proj, p["conv"], cfg, x.dtype, p.get("conv_b"))
    y = ops.rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"]


def _ssm_heads(cfg, rules, mesh):
    """``(lo, n)``: the SSM heads this rank computes.  Where the rules put
    the heads on "model" (``"tp"``, H divisible by the axis: the state
    ``h`` is sharded there) each model rank takes its H/tp.  Elsewhere the
    reference's divisible-or-replicate rule replicates ``h``, and every
    model rank computes all H heads on gathered weights: the block is
    data-parallel over "model" by the reference's own placement, not as a
    fallback."""
    H, tp = cfg.ssm_heads, spmd.axis_size(mesh, "model")
    names = tuple(a for a in rules.rules.get("ssm_inner", ()) if a in rules.shape)
    if names == ("model",) and H % tp == 0:
        return spmd.axis_rank(mesh, "model") * (H // tp), H // tp
    return 0, H


def _heads_of(w, lo: int, n: int):
    return {k: w[k][lo : lo + n] for k in ("A_log", "D", "dt_bias")}


def _mamba_out(y, rules, p, cfg):
    """The gated output ``y`` (sharded on its heads' columns over "model",
    or whole) through the norm over whole rows and ``w_out``: row-parallel
    when ``w_out`` is sharded on ``di`` (partial over "model"), else
    whole."""
    mesh = y.device_mesh
    y = spmd.rows(y)
    w = weights(rules, {"w_out": p["w_out"]})
    w["norm"] = spmd.replicate(p["norm"])
    rows_split = _model_dim(w["w_out"]) == 0
    k = w["w_out"].shape[0] // spmd.axis_size(mesh, "model") if rows_split else 0
    lo = spmd.axis_rank(mesh, "model") * k

    def out(y, w):
        y = ops.rmsnorm(y, w["norm"], cfg.norm_eps)
        if rows_split and k < y.shape[-1]:
            y = y[..., lo : lo + k]
        return y @ w["w_out"]

    pl = tuple(y.placements)
    out_pl = _partial_over_model(pl, mesh) if rows_split else pl
    return spmd.local_call(out, mesh, [y, w], [pl, _placements(w)], out_pl)


def _mamba2_mesh(p, x, cfg, rules):
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    lo, n = _ssm_heads(cfg, rules, mesh)
    tp = n < cfg.ssm_heads
    h = spmd.constrain(x, rules, ("batch",) + (None,) * (x.dim() - 1))
    w = {k: spmd.replicate(p[k]) for k in ("w_in", "conv", "A_log", "D", "dt_bias")}
    in_spans, conv_spans = _head_spans(cfg, lo, n, True), _head_spans(cfg, lo, n, False)

    def gated(x, w):
        w_in = _spans_take(w["w_in"], in_spans, 1)
        conv = _spans_take(w["conv"], conv_spans, 1)
        return _mamba_gated(_heads_of(w, lo, n), x @ w_in, conv, cfg, x.dtype)

    hp = tuple(h.placements)
    y_pl = spmd.with_axis(hp, mesh, "model", Shard(2)) if tp else hp
    y = spmd.local_call(gated, mesh, [h, w], [hp, _placements(w)], y_pl, split=("model",) if tp else ())
    return spmd.to(_mamba_out(y, rules, p, cfg), x.placements)


def _mamba_step(hp, proj, tail, conv, h, cfg, lo: int, n: int, dtype):
    """One token of the heads ``[lo, lo + n)`` (``hp``, their state ``h``
    (B, n, N, P)) from the whole projection ``proj`` (B, 2di + 2N + H) and
    conv tail (B, K-1, di + 2N): ``(y (B, nP) gated, new h, new whole
    tail)``.  The conv runs on every channel (a token's worth)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xBC, dtp = _mamba_split(proj[:, None], H, P, N)
    xBC, new_tail = _causal_conv(xBC, conv, tail)
    z, xBC, dtp = z[:, 0], xBC[:, 0], dtp[:, 0]
    if n < H:
        z = z[:, lo * P : (lo + n) * P]
        xBC = _spans_take(xBC, _head_spans(cfg, lo, n, False), 1)
        dtp = dtp[:, lo : lo + n]
    xh, a, Bm, Cm = _ssm_inputs(hp, xBC, dtp, n, P, N)
    decay = torch.exp(a)  # (B, n)
    h = h * decay[..., None, None] + torch.einsum("bn,bhp->bhnp", Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + xh * hp["D"][None, :, None]
    y = y.reshape(y.shape[0], n * P).to(dtype) * F.silu(z)
    return y, h, new_tail


def mamba2_decode(p, x, state, *, cfg, rules=None):
    """One-token recurrent step.  x: (B, d); state: ``{"h": (B, H, N, P)
    f32, "conv": (B, K-1, C)}``.  Returns ``(y, new state)``; the state
    tensors given are not written (the caller copies the new state into
    its cache).

    On a mesh the state is the cache's, at its placements (``h`` on its
    heads, the conv tail on its concatenated channels over "model", as
    ``w_in`` and ``conv`` are), and is written in place: the token's
    projection is gathered whole (a few KB) and so is the tail, every rank
    runs the conv on all channels and the recurrence on its heads (all of
    them where ``h`` is replicated, see :func:`_ssm_heads`), writes its
    slice of the new tail, and the gated output goes through
    :func:`_mamba_out`.  Returns ``(y, state)``."""
    if rules is not None:
        return _mamba2_decode_mesh(p, x, state, cfg, rules), state
    H = cfg.ssm_heads
    y, h, tail = _mamba_step(p, x @ p["w_in"], state["conv"], p["conv"], state["h"], cfg, 0, H, x.dtype)
    y = ops.rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": tail}


def _mamba2_decode_mesh(p, x, state, cfg, rules):
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    lo, n = _ssm_heads(cfg, rules, mesh)
    x_pl = tuple(x.placements)
    x = spmd.rows(x)
    xp = tuple(x.placements)
    w_in = weights(rules, {"w_in": p["w_in"]})["w_in"]
    proj_pl = spmd.with_axis(xp, mesh, "model", Shard(1)) if _model_dim(w_in) == 1 else xp
    proj = spmd.local_call(lambda x, w: x @ w, mesh, [x, w_in], [xp, tuple(w_in.placements)], proj_pl)
    proj = spmd.rows(proj)
    conv_st = state["conv"]
    tail = spmd.rows(conv_st)
    C = conv_st.shape[-1]
    c_n = C // spmd.axis_size(mesh, "model") if _model_dim(conv_st) == 2 else C
    c_lo = spmd.axis_rank(mesh, "model") * c_n if c_n < C else 0
    w = {k: spmd.replicate(p[k]) for k in ("conv", "A_log", "D", "dt_bias")}

    def step(proj, tail, w, h_loc, conv_loc):
        y, h, new_tail = _mamba_step(_heads_of(w, lo, n), proj, tail, w["conv"], h_loc, cfg, lo, n, x.dtype)
        h_loc.copy_(h)
        conv_loc.copy_(new_tail[..., c_lo : c_lo + c_n])
        return y

    pp = tuple(proj.placements)
    y_pl = spmd.with_axis(pp, mesh, "model", Shard(1)) if n < cfg.ssm_heads else pp
    y = spmd.local_call(
        step,
        mesh,
        [proj, tail, w, state["h"], conv_st],
        [pp, tuple(tail.placements), _placements(w), tuple(state["h"].placements), tuple(conv_st.placements)],
        y_pl,
    )
    return spmd.to(_mamba_out(y, rules, p, cfg), x_pl)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg) -> Dict[str, ParamSpec]:
    vpad = round_up(cfg.vocab, 256)
    sp = {"tok": ParamSpec((vpad, cfg.d_model), cfg.param_dtype, ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        sp["unembed"] = ParamSpec((cfg.d_model, vpad), cfg.param_dtype, ("embed", "vocab"))
    return sp


def embed_apply(p, tokens: torch.Tensor, rules=None) -> torch.Tensor:
    """The rows of the table for ``tokens``.  On a mesh with the table
    sharded on its vocabulary over "model" (vocab-parallel), a rank looks
    up the ids in its range, zeros the rest, and the result is partial
    over "model" (the caller's redistribute sums it); a gathered table
    (``"fsdp"``) is looked up whole."""
    if rules is None:
        return p["tok"][tokens]
    from torch.distributed.tensor import Replicate

    mesh = tokens.device_mesh
    tok = weights(rules, {"tok": p["tok"]})["tok"]
    vd = _model_dim(tok)
    tpl = tuple(tokens.placements)
    if vd is None:
        tok = spmd.to(tok, tuple(Replicate() for _ in tpl))
        return spmd.local_call(lambda t, w: w[t], mesh, [tokens, tok], [tpl, tuple(tok.placements)], tpl)
    n = tok.shape[0] // spmd.axis_size(mesh, "model")
    lo = spmd.axis_rank(mesh, "model") * n

    def local(t, w):
        rel = t.to(torch.int64) - lo
        mine = (rel >= 0) & (rel < n)
        rows = w[rel.clamp(0, n - 1)]
        return torch.where(mine[..., None], rows, rows.new_zeros(()))

    return spmd.local_call(
        local, mesh, [tokens, tok], [tpl, tuple(tok.placements)], _partial_over_model(tpl, mesh)
    )


def unembed_apply(p, x: torch.Tensor, cfg, rules=None) -> torch.Tensor:
    """Logits in f32 (f64 for f64 activations).  On a mesh the input is
    gathered to ``("batch", ..., "embed")`` and the logits come out sharded
    on the vocabulary over "model" when the table is (``"tp"``)."""
    w = p.get("unembed")
    tied = w is None
    if rules is None:
        if tied:
            w = p["tok"].t()
        return (x @ w).to(compute_dtype(x))
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    h = spmd.constrain(x, rules, ("batch",) + (None,) * (x.dim() - 1))
    name = "tok" if tied else "unembed"
    w = weights(rules, {name: p[name]})[name]
    vdim = 0 if tied else 1
    out_pl = h.placements
    if _model_dim(w) == vdim:
        out_pl = spmd.with_axis(h.placements, mesh, "model", Shard(x.dim() - 1))

    def local(x, w):
        return (x @ (w.t() if tied else w)).to(compute_dtype(x))

    return spmd.local_call(local, mesh, [h, w], [h.placements, tuple(w.placements)], out_pl)


def token_nll(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """``(nll, valid)`` per token: the negative log-likelihood of each label
    in ``[0, vocab)`` (0 elsewhere), with the padded vocabulary columns
    masked to -1e30, and which labels count."""
    vpad = logits.shape[-1]
    mask = torch.arange(vpad, device=logits.device) < vocab
    logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    valid = (labels >= 0) & (labels < vocab)
    idx = torch.where(valid, labels, 0).to(torch.int64)
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    nll = torch.where(valid, lse - ll, 0.0)
    return nll, valid


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL over logits sharded on the vocabulary: this rank holds
    the columns ``[lo, lo + n)``; the max, the sum of exponentials and the
    label's logit are reduced over ``group``.  Columns ``>= vocab`` are
    masked on the rank that holds them."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, vocab: int, group):
        import torch.distributed as dist

        n = logits.shape[-1]
        cols = torch.arange(lo, lo + n, device=logits.device)
        z = torch.where(cols < vocab, logits, NEG_INF)
        m = z.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = torch.exp(z - m[..., None]).sum(dim=-1)
        dist.all_reduce(se, group=group)
        lse = m + torch.log(se)
        valid = (labels >= 0) & (labels < vocab)
        rel = labels.to(torch.int64) - lo
        mine = valid & (rel >= 0) & (rel < n)
        idx = rel.clamp(0, n - 1)
        ll = torch.where(mine, torch.gather(z, -1, idx[..., None])[..., 0], 0.0)
        dist.all_reduce(ll, group=group)
        ctx.save_for_backward(z, lse, idx, mine, valid)
        return torch.where(valid, lse - ll, 0.0)

    @staticmethod
    def backward(ctx, g):
        z, lse, idx, mine, valid = ctx.saved_tensors
        grad = torch.exp(z - lse[..., None])
        grad = grad.scatter_add(-1, idx[..., None], -mine[..., None].to(grad.dtype))
        return grad * torch.where(valid, g, 0.0)[..., None], None, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int, rules=None) -> torch.Tensor:
    """logits: (B, S, Vpad) f32; labels: (B, S) int; the mean negative
    log-likelihood over the labels in ``[0, vocab)``, with the padded
    vocabulary columns masked to -1e30.

    On a mesh (logits and labels DTensors) each rank takes its tokens'
    NLL, over logits sharded on the vocabulary across "model" when they
    are, and the mean divides the sum over every data rank by the global
    count of valid labels; the loss is a replicated DTensor."""
    if rules is None:
        nll, valid = token_nll(logits, labels, vocab)
        return nll.sum() / valid.sum().clamp(min=1)
    mesh = logits.device_mesh
    lpl = tuple(labels.placements)
    if _model_dim(logits) != logits.dim() - 1 or spmd.axis_size(mesh, "model") == 1:
        def local(z, t):
            return token_nll(z, t, vocab)[0]
    else:
        n = logits.shape[-1] // spmd.axis_size(mesh, "model")
        lo = spmd.axis_rank(mesh, "model") * n
        group = mesh.get_group("model")

        def local(z, t):
            return _VocabParallelNLL.apply(z, t, lo, vocab, group)

    nll = spmd.local_call(local, mesh, [logits, labels], [tuple(logits.placements), lpl], lpl)
    valid = (labels >= 0) & (labels < vocab)
    return spmd.replicate(nll.sum()) / spmd.replicate(valid.sum()).clamp(min=1)


def argmax(logits: torch.Tensor, vocab: int, rules=None) -> torch.Tensor:
    """The greedy next tokens (B,) int32 of (B, Vpad) logits: the first
    maximum, as ``jnp.argmax``, over the first ``vocab`` columns (the
    padding of ``round_up(vocab, 256)`` holds no token, so a served token
    never indexes it; the reference takes the argmax over every
    column).  On a mesh with vocab-sharded logits every
    rank takes its columns' first maximum, the ranks' (max, index) pairs
    are gathered over "model", and the lowest global index among the equal
    maxima wins; the tokens come back as a plain tensor, the same on every
    rank."""

    def real(z, lo=0):
        if lo + z.shape[-1] <= vocab:
            return z
        cols = torch.arange(lo, lo + z.shape[-1], device=z.device)
        return torch.where(cols < vocab, z, torch.finfo(z.dtype).min)

    if rules is None:
        return real(logits).argmax(dim=-1).to(torch.int32)
    from torch.distributed.tensor import Shard

    mesh = logits.device_mesh
    pl = tuple(logits.placements)
    bpl = tuple(_replicate() if p.is_shard() and p.dim == 1 else p for p in pl)
    if _model_dim(logits) != 1 or spmd.axis_size(mesh, "model") == 1:
        tok = spmd.local_call(lambda z: real(z).argmax(dim=-1).to(torch.int32), mesh, [logits], [pl], bpl)
        return spmd.replicate(tok).to_local()
    n = logits.shape[-1] // spmd.axis_size(mesh, "model")
    lo = spmd.axis_rank(mesh, "model") * n

    def local(z):
        v, i = real(z, lo).max(dim=-1)
        return v[None], (i + lo)[None]

    gpl = spmd.with_axis(spmd.shift(bpl), mesh, "model", Shard(0))
    vals, idx = spmd.local_call(local, mesh, [logits], [pl], (gpl, gpl))
    vals, idx = spmd.replicate(vals).to_local(), spmd.replicate(idx).to_local()
    best = vals.amax(dim=0)
    first = torch.where(vals == best, idx, torch.iinfo(idx.dtype).max).amin(dim=0)
    return first.to(torch.int32)
