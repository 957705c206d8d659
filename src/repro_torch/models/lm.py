"""Decoder-only LM assembly (port of ``src/repro/models/lm.py``): the
dense and SSM families' parameter and cache layouts, their training
forward and their one-token decode step.

Layers keep the reference's stacked layout: every leaf under
``params["layers"]`` has a leading ``n_layers`` axis, the KV cache is
``(n_layers, B, S, Hkv, Dh)`` and the SSM cache ``h (n_layers, B, H, N,
P)`` and ``conv (n_layers, B, K-1, C)``.  Where the reference scans the
stack, the port loops over it and takes layer ``i`` of each leaf (a view,
no copy).  The other families are not ported yet and raise
``CoxUnsupported`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..core.types import CoxUnsupported
from . import layers as L
from .params import ParamSpec, tree_map


def check_family(cfg) -> None:
    """Raise unless the port runs ``cfg``'s family.  Both norms (``rms``
    and ``ln``, whose specs add the ``_b`` bias leaves) run in either
    family, as in the reference."""
    if cfg.family not in ("dense", "ssm"):
        item = "A.7 (the model stack: MoE, hybrid and VLM families)"
        if cfg.family == "encdec":
            item = "A.7 (models/encdec.py)"
        raise CoxUnsupported(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
            f"yet: ROADMAP queue item {item}"
        )


# ---------------------------------------------------------------------------
# spec assembly
# ---------------------------------------------------------------------------


def _stack(spec_tree, n: int):
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape),
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
    layer = _dense_layer_specs if cfg.family == "dense" else _ssm_layer_specs
    specs["layers"] = _stack(layer(cfg), cfg.n_layers)
    return specs


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _dense_layer_apply(cfg, lp, x, positions):
    h = L.apply_norm(lp["ln1"], x, cfg.norm, lp.get("ln1_b"))
    h = L.attention_apply(lp["attn"], h, positions, cfg=cfg, causal=True, window=cfg.window)
    x = x + h
    h = L.apply_norm(lp["ln2"], x, cfg.norm, lp.get("ln2_b"))
    return x + L.mlp_apply(lp["mlp"], h, cfg=cfg)


def _ssm_layer_apply(cfg, lp, x, positions):
    """A Mamba2 layer; ``positions`` is unused (no rotary embedding), kept
    so both families' layers take the same arguments."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm, lp.get("ln1_b"))
    return x + L.mamba2_apply(lp["mamba"], h, cfg=cfg)


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views.  ``unbind``
    once per leaf: its backward stacks the layers' gradients in one step,
    where indexing each layer would scatter each into a zeroed copy of the
    whole stack."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def hidden_states(cfg, params, x, positions):
    """Run the layer stack on embedded inputs x: (B, S, d), then the final
    norm.  With ``cfg.remat == "full"`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept,
    and the backward recomputes the layer, as the reference wraps the
    scanned layer in ``jax.checkpoint``."""
    check_family(cfg)
    layer = _dense_layer_apply if cfg.family == "dense" else _ssm_layer_apply
    for lp in _unstack(params["layers"], cfg.n_layers):
        fn = functools.partial(layer, cfg, lp)
        if cfg.remat == "full":
            x = checkpoint(fn, x, positions, use_reentrant=False)
        else:
            x = fn(x, positions)
    return L.apply_norm(params["final_norm"], x, cfg.norm, params.get("final_norm_b"))


def forward(cfg, params, batch):
    """Training forward.  batch: ``tokens`` (B, S) and ``labels`` (B, S),
    int tensors.  Returns ``(loss, logits (B, S, Vpad) f32)``."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed_apply(params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    h = hidden_states(cfg, params, x, positions)
    logits = L.unembed_apply(params["embed"], h, cfg)
    loss = L.cross_entropy(logits, batch["labels"], cfg.vocab)
    return loss, logits


# ---------------------------------------------------------------------------
# decode (serve step)
# ---------------------------------------------------------------------------


def cache_specs(cfg, batch: int, seq_len: int) -> Dict[str, Any]:
    """Cache layout for one-token decode, zero-initialised.  Dense: per-layer
    K and V of shape (n_layers, B, S, Hkv, Dh) in the parameter dtype.
    SSM: the recurrent state ``h`` (n_layers, B, H, N, P) in f32 and the
    conv tail ``conv`` (n_layers, B, K-1, d_inner + 2N) in the parameter
    dtype; ``seq_len`` does not enter it."""
    check_family(cfg)
    Lc, dt = cfg.n_layers, cfg.param_dtype
    if cfg.family == "dense":
        kv = ParamSpec((Lc, batch, seq_len, cfg.n_kv, cfg.d_head), dt, init="zeros")
        return {"k": kv, "v": kv}
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    return {
        "h": ParamSpec((Lc, batch, H, N, P), torch.float32, init="zeros"),
        "conv": ParamSpec(
            (Lc, batch, cfg.conv_k - 1, cfg.ssm_inner + 2 * N), dt, init="zeros"
        ),
    }


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views)."""
    return tree_map(lambda a: a[i], tree)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens: torch.Tensor, pos: torch.Tensor):
    """One token for every sequence.  tokens: (B,) int; pos: (B,) int32
    current lengths.  Returns ``(logits (B, Vpad) f32, cache)``; the cache
    is updated in place: each dense layer writes the token's K/V at
    ``pos``, each SSM layer overwrites its ``h`` and ``conv`` state (which
    ``pos`` does not enter)."""
    check_family(cfg)
    x = L.embed_apply(params["embed"], tokens)  # (B, d)
    h = x
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"))
        if cfg.family == "ssm":
            state = {"h": cache["h"][i], "conv": cache["conv"][i]}
            y, new = L.mamba2_decode(lp["mamba"], hn, state, cfg=cfg)
            state["h"].copy_(new["h"])
            state["conv"].copy_(new["conv"])
            h = h + y
            continue
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        y, _ = L.attention_decode(lp["attn"], hn, kv, pos)
        h = h + y
        hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"))
        h = h + L.mlp_apply(lp["mlp"], hn, cfg=cfg)
    h = L.apply_norm(params["final_norm"], h, cfg.norm, params.get("final_norm_b"))
    logits = L.unembed_apply(params["embed"], h, cfg)
    return logits, cache

