"""Decoder-only LM assembly (port of ``src/repro/models/lm.py``): the
dense family's parameter and cache layouts, its training forward and its
one-token decode step.

Layers keep the reference's stacked layout: every leaf under
``params["layers"]`` has a leading ``n_layers`` axis, and the KV cache is
``(n_layers, B, S, Hkv, Dh)``.  Where the reference scans the stack, the
port loops over it and takes layer ``i`` of each leaf (a view, no copy).
The other families are not ported yet and raise ``CoxUnsupported`` naming
their ROADMAP item.
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
    """Raise unless the port runs ``cfg``'s family and norm."""
    if cfg.family != "dense":
        item = "A.7 (the model stack: MoE, SSM, hybrid and VLM families)"
        if cfg.family == "encdec":
            item = "A.7 (models/encdec.py)"
        raise CoxUnsupported(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
            f"yet: ROADMAP queue item {item}"
        )
    if cfg.norm != "rms":
        raise CoxUnsupported(
            f"norm={cfg.norm!r} ({cfg.name}) is not ported to repro_torch yet: "
            "ROADMAP queue item B.4 (the layernorm kernel)"
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


def lm_specs(cfg) -> Dict[str, Any]:
    check_family(cfg)
    specs: Dict[str, Any] = {"embed": L.embed_specs(cfg)}
    specs.update(_norm_pair(cfg, "final_norm"))
    specs["layers"] = _stack(_dense_layer_specs(cfg), cfg.n_layers)
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
    for lp in _unstack(params["layers"], cfg.n_layers):
        fn = functools.partial(_dense_layer_apply, cfg, lp)
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
    """KV cache layout for one-token decode: per-layer K and V of shape
    (n_layers, B, S, Hkv, Dh) in the parameter dtype, zero-initialised."""
    check_family(cfg)
    kv = ParamSpec(
        (cfg.n_layers, batch, seq_len, cfg.n_kv, cfg.d_head),
        cfg.param_dtype,
        init="zeros",
    )
    return {"k": kv, "v": kv}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views)."""
    return tree_map(lambda a: a[i], tree)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens: torch.Tensor, pos: torch.Tensor):
    """One token for every sequence.  tokens: (B,) int; pos: (B,) int32
    current lengths.  Returns ``(logits (B, Vpad) f32, cache)``; the cache
    is updated in place (each layer writes the token's K/V at ``pos``)."""
    check_family(cfg)
    x = L.embed_apply(params["embed"], tokens)  # (B, d)
    h = x
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"))
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        y, _ = L.attention_decode(lp["attn"], hn, kv, pos)
        h = h + y
        hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"))
        h = h + L.mlp_apply(lp["mlp"], hn, cfg=cfg)
    h = L.apply_norm(params["final_norm"], h, cfg.norm, params.get("final_norm_b"))
    logits = L.unembed_apply(params["embed"], h, cfg)
    return logits, cache

