"""Decoder-only LM assembly (port of ``src/repro/models/lm.py``): the
dense, MoE, SSM, hybrid and VLM families' parameter and cache layouts,
their training forward and their one-token decode step.

Layers keep the reference's stacked layout: every leaf under
``params["layers"]`` has a leading ``n_layers`` axis, the KV cache is
``(n_layers, B, S, Hkv, Dh)`` and the SSM cache ``h (n_layers, B, H, N,
P)`` and ``conv (n_layers, B, K-1, C)``.  The hybrid family (zamba2) adds
one shared attention+MLP block, ``params["shared_attn"]`` (no layer
axis), applied after every ``attn_every`` Mamba2 layers (the last group
may be short), and its cache one K/V ring of ``min(S, window)`` rows for
each application: ``k``/``v`` of shape ``(n_applications, B, W, Hkv,
Dh)``.  Where the reference scans the stack, the port loops over it and
takes layer ``i`` of each leaf (a view, no copy).

Given ``rules`` (an ``AxisRules`` over a ``DeviceMesh``), the parameters,
batch and cache are DTensors and every layer runs sharded
(``layers.py``): between layers the residual stream is sharded on the
sequence over "model" (the reference's ``seq_act``), gathered before
attention and the MLP and reduce-scattered out of ``wo`` and ``w_down``,
so remat keeps only the slab.  The Mamba2 layers of the SSM and hybrid
families run on their SSM heads over "model" (``layers.mamba2_apply``),
and the hybrid family's shared block takes the dense layer's path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..parallel import spmd
from . import layers as L
from .params import ParamSpec, tree_map

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_family(cfg) -> None:
    """Raise ``ValueError`` unless ``cfg`` is a decoder-only family (the
    encoder-decoder family is ``models/encdec.py``'s).  Both norms
    (``rms`` and ``ln``, whose specs add the ``_b`` bias leaves) run in
    every family, as in the reference."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# spec assembly
# ---------------------------------------------------------------------------


def _stack(spec_tree, n: int):
    return tree_map(
        lambda s: dataclasses.replace(
            s, shape=(n,) + s.shape, axes=(None,) + tuple(s.axes or (None,) * len(s.shape))
        ),
        spec_tree,
    )


def _norm_pair(cfg, name: str) -> Dict[str, ParamSpec]:
    sp = {name: L.norm_spec(cfg)}
    if cfg.norm == "ln":
        sp[name + "_b"] = dataclasses.replace(L.norm_spec(cfg), init="zeros")
    return sp


def _dense_layer_specs(cfg) -> Dict[str, Any]:
    sp: Dict[str, Any] = {}
    sp.update(_norm_pair(cfg, "ln1"))
    sp["attn"] = L.attention_specs(cfg)
    sp.update(_norm_pair(cfg, "ln2"))
    if cfg.family == "moe":
        sp["moe"] = L.moe_specs(cfg)
    else:
        sp["mlp"] = L.mlp_specs(cfg)
    return sp


def _ssm_layer_specs(cfg) -> Dict[str, Any]:
    sp: Dict[str, Any] = {}
    sp.update(_norm_pair(cfg, "ln1"))
    sp["mamba"] = L.mamba2_specs(cfg)
    return sp


def lm_specs(cfg) -> Dict[str, Any]:
    check_family(cfg)
    specs: Dict[str, Any] = {"embed": L.embed_specs(cfg)}
    specs.update(_norm_pair(cfg, "final_norm"))
    if cfg.family in ("ssm", "hybrid"):
        specs["layers"] = _stack(_ssm_layer_specs(cfg), cfg.n_layers)
    else:
        specs["layers"] = _stack(_dense_layer_specs(cfg), cfg.n_layers)
    if cfg.family == "hybrid":
        # the shared block: a dense layer with an MLP, no layer axis
        specs["shared_attn"] = _dense_layer_specs(cfg)
    return specs


def _groups(cfg) -> List[Tuple[int, int]]:
    """The hybrid family's groups of Mamba2 layers, ``(start, width)``,
    each followed by one application of the shared block: ``attn_every``
    layers each, the last group possibly short."""
    ae = cfg.attn_every or cfg.n_layers
    return [(s, min(ae, cfg.n_layers - s)) for s in range(0, cfg.n_layers, ae)]


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn(cfg, lp, h, rules=None):
    """A dense layer's feed-forward part: the MoE block for the MoE
    family, else the MLP."""
    if cfg.family == "moe":
        return L.moe_apply(lp["moe"], h, cfg=cfg, rules=rules)
    return L.mlp_apply(lp["mlp"], h, cfg=cfg, rules=rules)


def _dense_layer_apply(cfg, lp, x, positions, rules=None):
    h = L.apply_norm(lp["ln1"], x, cfg.norm, lp.get("ln1_b"), rules=rules)
    with obs.span("model.attention"):
        h = L.attention_apply(
            lp["attn"], h, positions, cfg=cfg, rules=rules, causal=True, window=cfg.window
        )
    x = x + h
    h = L.apply_norm(lp["ln2"], x, cfg.norm, lp.get("ln2_b"), rules=rules)
    with obs.span("model.ffn"):
        h = _ffn(cfg, lp, h, rules)
    return x + h


def _ssm_layer_apply(cfg, lp, x, positions, rules=None):
    """A Mamba2 layer; ``positions`` is unused (no rotary embedding), kept
    so both kinds of layer take the same arguments."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm, lp.get("ln1_b"), rules=rules)
    with obs.span("model.mamba"):
        h = L.mamba2_apply(lp["mamba"], h, cfg=cfg, rules=rules)
    return x + h


def _shared_attn_apply(cfg, sp, x, positions, rules=None):
    """The hybrid family's shared block: attention over the config's
    window, then the MLP, with the same weights at every application."""
    return _dense_layer_apply(cfg, sp, x, positions, rules)


SEQ_ACT = ("batch", "seq_act", "embed")


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views.  ``unbind``
    once per leaf: its backward stacks the layers' gradients in one step,
    where indexing each layer would scatter each into a zeroed copy of the
    whole stack."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def _block(layer, cfg, i, lp, x, positions, rules=None):
    """Stacked layer ``i`` in the span ``model.block``; under remat the
    backward runs it again, and the span with it."""
    with obs.span("model.block", layer=i):
        return layer(cfg, lp, x, positions, rules=rules)


def hidden_states(cfg, params, x, positions, rules=None):
    """Run the layer stack on embedded inputs x: (B, S, d); the final norm
    is the head's (``forward``).  With ``cfg.remat == "full"`` each
    stacked layer runs under ``torch.utils.checkpoint`` (non-reentrant):
    only its input is kept, and the backward recomputes the layer, as the
    reference wraps the scanned layer in ``jax.checkpoint``.  The hybrid
    family's shared block runs outside the scan in the reference, so it
    is not checkpointed here either; its gradient is the sum over its
    applications."""
    check_family(cfg)
    ssm = cfg.family in ("ssm", "hybrid")
    layer = _ssm_layer_apply if ssm else _dense_layer_apply
    layers = _unstack(params["layers"], cfg.n_layers)
    x = spmd.constrain(x, rules, SEQ_ACT)

    def run(i, x):
        fn = functools.partial(_block, layer, cfg, i, layers[i], rules=rules)
        if cfg.remat == "full":
            return checkpoint(fn, x, positions, use_reentrant=False)
        return fn(x, positions)

    if cfg.family == "hybrid":
        for app, (start, width) in enumerate(_groups(cfg)):
            for i in range(start, start + width):
                x = run(i, x)
            with obs.span("model.block", shared=app):
                x = _shared_attn_apply(cfg, params["shared_attn"], x, positions, rules)
    else:
        for i in range(cfg.n_layers):
            x = run(i, x)
    return x


def forward(cfg, params, batch, rules=None):
    """Training forward.  batch: ``tokens`` (B, S_text) and ``labels`` (B,
    S_text), int tensors, and for a model with ``n_frontend_tokens`` (the
    VLM family) ``frontend`` (B, Nf, d), precomputed embeddings cast to
    the activations' dtype and put before the tokens; positions run over
    the whole sequence, and the frontend rows are cut before the
    unembedding.  Returns ``(loss, logits (B, S_text, Vpad) f32)``.

    With ``rules`` the batch leaves are DTensors sharded on the batch (the
    frontend rows too), the loss is a replicated DTensor and the logits
    are sharded on the vocabulary over "model" (``"tp"``).

    Spans (``obs``): ``model.embed``; ``model.block`` for each layer
    (``layer=i``; ``shared=n`` for the hybrid family's n-th application
    of its shared block), with ``model.attention``, ``model.ffn`` (MLP or
    MoE) or ``model.mamba`` inside; ``model.head`` (the final norm, the
    unembedding and the cross-entropy)."""
    check_family(cfg)
    with obs.span("model.embed"):
        x = L.embed_apply(params["embed"], batch["tokens"], rules=rules)
    x = spmd.constrain(x, rules, ("batch", None, "embed"))
    nf = cfg.n_frontend_tokens
    if nf:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    positions = positions[None] if rules is not None else positions.expand(B, S)
    h = hidden_states(cfg, params, x, positions, rules=rules)
    with obs.span("model.head"):
        h = L.apply_norm(params["final_norm"], h, cfg.norm, params.get("final_norm_b"), rules=rules)
        if nf:
            h = spmd.constrain(h, rules, ("batch", None, "embed"))[:, nf:]
        logits = L.unembed_apply(params["embed"], h, cfg, rules=rules)
        loss = L.cross_entropy(logits, batch["labels"], cfg.vocab, rules=rules)
    return loss, logits


# ---------------------------------------------------------------------------
# decode (serve step)
# ---------------------------------------------------------------------------


def cache_specs(cfg, batch: int, seq_len: int) -> Dict[str, Any]:
    """Cache layout for one-token decode, zero-initialised.  Dense, MoE
    and VLM: per-layer K and V of shape (n_layers, B, S, Hkv, Dh) in the
    parameter dtype.  SSM: the recurrent state ``h`` (n_layers, B, H, N,
    P) in f32 and the conv tail ``conv`` (n_layers, B, K-1, d_inner + 2N)
    in the parameter dtype; ``seq_len`` does not enter it.  Hybrid: the
    SSM state plus one K/V ring per application of the shared block,
    (n_applications, B, min(S, window), Hkv, Dh)."""
    check_family(cfg)
    Lc, dt = cfg.n_layers, cfg.param_dtype
    Hkv, Dh = cfg.n_kv, cfg.d_head
    kv_axes = (None, "batch", "seq_kv", "kv_heads", None)
    if cfg.family not in ("ssm", "hybrid"):
        kv = ParamSpec((Lc, batch, seq_len, Hkv, Dh), dt, kv_axes, init="zeros")
        return {"k": kv, "v": kv}
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    ssm = {
        "h": ParamSpec(
            (Lc, batch, H, N, P), torch.float32, (None, "batch", "ssm_inner", None, None), init="zeros"
        ),
        "conv": ParamSpec(
            (Lc, batch, cfg.conv_k - 1, cfg.ssm_inner + 2 * N),
            dt,
            (None, "batch", None, "ssm_inner"),
            init="zeros",
        ),
    }
    if cfg.family == "ssm":
        return ssm
    W = min(seq_len, cfg.window) if cfg.window else seq_len
    kv = ParamSpec((len(_groups(cfg)), batch, W, Hkv, Dh), dt, kv_axes, init="zeros")
    return {**ssm, "k": kv, "v": kv}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views; on a mesh, DTensors
    over views of the local shards, so a write reaches the stack)."""

    def one(a):
        if spmd.is_dtensor(a):
            from torch.distributed.tensor import DTensor

            pl = tuple(a.placements)
            if any(p.is_shard() and p.dim == 0 for p in pl):
                raise ValueError("the layer axis of a stacked leaf is sharded")
            return DTensor.from_local(a.to_local()[i], a.device_mesh, spmd.shift(pl, -1), run_check=False)
        return a[i]

    return tree_map(one, tree)


def _ssm_layer_decode(cfg, lp, cache, i: int, h, rules=None):
    """Mamba2 layer ``i``'s step; its ``h`` and ``conv`` state in
    ``cache`` are overwritten in place (on a mesh, each rank's shards of
    them, by ``layers.mamba2_decode``)."""
    hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"), rules=rules)
    state = _layer({"h": cache["h"], "conv": cache["conv"]}, i)
    y, new = L.mamba2_decode(lp["mamba"], hn, state, cfg=cfg, rules=rules)
    if rules is None:
        state["h"].copy_(new["h"])
        state["conv"].copy_(new["conv"])
    return h + y


def _dense_layer_decode(cfg, lp, kv, h, pos, slot=None, kv_len=None, rules=None):
    """A dense (or MoE, or shared) layer's step; the token's K/V is written
    into ``kv`` in place, at ``slot`` (``pos`` by default).  The MoE block
    takes the step's B tokens as (B, 1, d), so its capacity is
    ``moe_capacity(cfg, B)`` (per data slab on a mesh)."""
    hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"), rules=rules)
    y, _ = L.attention_decode(
        lp["attn"], hn, kv, pos, cfg=cfg, rules=rules, slot=slot, kv_len=kv_len
    )
    h = h + y
    hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"), rules=rules)
    return h + _ffn(cfg, lp, hn.unsqueeze(1), rules).squeeze(1)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens: torch.Tensor, pos: torch.Tensor, rules=None):
    """One token for every sequence.  tokens: (B,) int; pos: (B,) int32
    current lengths.  Returns ``(logits (B, Vpad) f32, cache)``; the cache
    is updated in place: each attention layer writes the token's K/V at
    ``pos``, each SSM layer overwrites its ``h`` and ``conv`` state (which
    ``pos`` does not enter).  The hybrid family's shared block writes its
    ring of W rows at ``pos % W`` and attends to ``min(pos + 1, W)`` rows,
    with RoPE at the absolute ``pos``.

    With ``rules`` tokens and pos are DTensors sharded on the batch, the
    cache's K/V are sharded on the sequence over "model" (each rank's slab
    is written in place) and the logits come back sharded on the
    vocabulary."""
    check_family(cfg)
    h = L.embed_apply(params["embed"], tokens, rules=rules)  # (B, d)
    h = spmd.constrain(h, rules, ("batch", "embed"))

    def kv_of(i):
        return _layer({"k": cache["k"], "v": cache["v"]}, i)

    if cfg.family == "hybrid":
        W = cache["k"].shape[2]
        slot, kv_len = pos % W, torch.clamp(pos + 1, max=W)
        sp = params["shared_attn"]
        for app, (start, width) in enumerate(_groups(cfg)):
            for i in range(start, start + width):
                h = _ssm_layer_decode(cfg, _layer(params["layers"], i), cache, i, h, rules)
            h = _dense_layer_decode(cfg, sp, kv_of(app), h, pos, slot, kv_len, rules)
    else:
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            if cfg.family == "ssm":
                h = _ssm_layer_decode(cfg, lp, cache, i, h, rules)
            else:
                h = _dense_layer_decode(cfg, lp, kv_of(i), h, pos, rules=rules)
    h = L.apply_norm(params["final_norm"], h, cfg.norm, params.get("final_norm_b"), rules=rules)
    logits = L.unembed_apply(params["embed"], h, cfg, rules=rules)
    return logits, cache
