"""Encoder-decoder model, the seamless-m4t backbone (port of
``src/repro/models/encdec.py``).

The speech/text modality frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S_enc, d).  The encoder is
a non-causal transformer; the decoder a causal one with cross-attention
over the encoder's output (the memory), whose keys and values each
decoder layer projects from it (``_mem_kv``).  The decode step serves the
decoder alone: the cross keys and values sit precomputed in the cache as
``xk``/``xv`` of shape (n_layers, B, enc_len, Hkv, Dh).

Both stacks keep the reference's stacked layout (``enc_layers`` and
``dec_layers``, every leaf leading with its depth); where the reference
scans a stack, the port loops over it, as ``lm.py`` does.  On a card the
encoder's attention and the cross-attention launch ``flash_attention``
non-causal, the decoder's self-attention causal, and in decoding
``flash_decode`` runs over the self cache and over the cross memory.

On a mesh (``rules=``) the family is data-parallel: every rank runs the
whole model on its batch rows with the weights gathered, and the loss
divides by the global count of labels.  It does no tensor-parallel work,
so under ``"tp"`` a "model" axis above 1 raises (ROADMAP A.10.4).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel import spmd
from . import layers as L
from .lm import _layer, _norm_pair, _stack, _unstack
from .params import ParamSpec, tree_map


def cross_attention_specs(cfg) -> Dict[str, ParamSpec]:
    return L.attention_specs(cfg)


def encdec_specs(cfg) -> Dict[str, Any]:
    enc_layer: Dict[str, Any] = {}
    enc_layer.update(_norm_pair(cfg, "ln1"))
    enc_layer["attn"] = L.attention_specs(cfg)
    enc_layer.update(_norm_pair(cfg, "ln2"))
    enc_layer["mlp"] = L.mlp_specs(cfg)

    dec_layer: Dict[str, Any] = {}
    dec_layer.update(_norm_pair(cfg, "ln1"))
    dec_layer["attn"] = L.attention_specs(cfg)
    dec_layer.update(_norm_pair(cfg, "lnx"))
    dec_layer["xattn"] = cross_attention_specs(cfg)
    dec_layer.update(_norm_pair(cfg, "ln2"))
    dec_layer["mlp"] = L.mlp_specs(cfg)

    specs: Dict[str, Any] = {
        "embed": L.embed_specs(cfg),
        "enc_layers": _stack(enc_layer, cfg.enc_layers),
        "dec_layers": _stack(dec_layer, cfg.n_layers),
    }
    specs.update(_norm_pair(cfg, "enc_norm"))
    specs.update(_norm_pair(cfg, "final_norm"))
    return specs


def _cross_attend(p, x, mem_k, mem_v):
    """x: (B, S, d) queries; mem_k/v: (B, Se, Hkv, Dh) precomputed.  No
    rotary embedding and no bias, as in the reference.  On a card the
    kernel takes Se == S only (the training batch's frames are as long as
    its text); another length raises there."""
    q = L._project(x, p["wq"])
    att = ops.attention(q, mem_k, mem_v, causal=False)
    B, S, H, Dh = att.shape
    return att.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, -1)


def _remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``cfg.remat ==
    "full"`` (the reference's ``jax.checkpoint`` of the scanned layer)."""
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _enc_layer_apply(cfg, lp, h, positions):
    hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"))
    hn = L.attention_apply(lp["attn"], hn, positions, cfg=cfg, causal=False)
    h = h + hn
    hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"))
    return h + L.mlp_apply(lp["mlp"], hn, cfg=cfg)


def encode(cfg, params, frames):
    """frames: (B, Se, d) precomputed frontend embeddings in the
    parameters' dtype; returns the memory (B, Se, d) after ``enc_norm``."""
    B, Se, _ = frames.shape
    positions = torch.arange(Se, dtype=torch.int32, device=frames.device).expand(B, Se)
    x = frames
    for lp in _unstack(params["enc_layers"], cfg.enc_layers):
        x = _remat(cfg, functools.partial(_enc_layer_apply, cfg, lp), x, positions)
    return L.apply_norm(params["enc_norm"], x, cfg.norm, params.get("enc_norm_b"))


def _mem_kv(p, mem):
    return L._project(mem, p["wk"]), L._project(mem, p["wv"])


def _dec_layer_apply(cfg, lp, h, positions, mem):
    hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"))
    hn = L.attention_apply(lp["attn"], hn, positions, cfg=cfg, causal=True)
    h = h + hn
    hn = L.apply_norm(lp["lnx"], h, cfg.norm, lp.get("lnx_b"))
    mk, mv = _mem_kv(lp["xattn"], mem)
    h = h + _cross_attend(lp["xattn"], hn, mk, mv)
    hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"))
    return h + L.mlp_apply(lp["mlp"], hn, cfg=cfg)


def forward(cfg, params, batch, rules=None):
    """Training forward.  batch: ``frontend`` (B, Se, d) frame embeddings
    (cast to the parameters' dtype), ``tokens`` and ``labels`` (B, S) int
    tensors.  Returns ``(loss, logits (B, S, Vpad) f32)``."""
    if rules is not None:
        logits = _data_parallel(cfg, params, batch, rules, lambda w, b: _logits(cfg, w, b))
        return L.cross_entropy(logits, batch["labels"], cfg.vocab, rules=rules), logits
    logits = _logits(cfg, params, batch)
    return L.cross_entropy(logits, batch["labels"], cfg.vocab), logits


def _data_parallel(cfg, params, inputs, rules, fn):
    """``fn(weights, inputs)`` on this rank's batch rows with every weight
    gathered; the result is sharded on the batch as the tokens are."""
    L.refuse_model_axis(rules, "the encoder-decoder family")
    w = tree_map(spmd.replicate, params)
    mesh = inputs["tokens"].device_mesh
    pl = tuple(inputs["tokens"].placements)
    return spmd.local_call(
        fn, mesh, [w, inputs], [L._placements(w), L._placements(inputs)], pl
    )


def _logits(cfg, params, batch):
    mem = encode(cfg, params, batch["frontend"].to(cfg.param_dtype))
    x = L.embed_apply(params["embed"], batch["tokens"])
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x = _remat(cfg, functools.partial(_dec_layer_apply, cfg, lp), x, positions, mem)
    x = L.apply_norm(params["final_norm"], x, cfg.norm, params.get("final_norm_b"))
    return L.unembed_apply(params["embed"], x, cfg)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_specs(cfg, batch: int, seq_len: int, enc_len: int) -> Dict[str, Any]:
    """The decoder's self K/V, (n_layers, B, seq_len, Hkv, Dh), and the
    cross K/V of the encoder memory, (n_layers, B, enc_len, Hkv, Dh), in
    the parameter dtype, zero-initialised."""
    Lc, Hkv, Dh, dt = cfg.n_layers, cfg.n_kv, cfg.d_head, cfg.param_dtype
    axes = (None, "batch", "seq_kv", "kv_heads", None)
    kv = ParamSpec((Lc, batch, seq_len, Hkv, Dh), dt, axes, init="zeros")
    xkv = ParamSpec((Lc, batch, enc_len, Hkv, Dh), dt, axes, init="zeros")
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


@torch.no_grad()
def decode_step(cfg, params, cache, tokens: torch.Tensor, pos: torch.Tensor, rules=None):
    """One decoder token for every sequence, over the cross K/V in the
    cache.  tokens: (B,) int; pos: (B,) int32 current lengths.  Returns
    ``(logits (B, Vpad) f32, cache)``; each layer writes the token's self
    K/V into the cache in place at ``pos`` and attends to all ``enc_len``
    rows of its cross memory.  On a mesh each rank steps its batch rows of
    the cache in place (a data-only mesh: the cache must not be split on
    its sequence)."""
    if rules is not None:
        mesh = cache["k"].device_mesh
        if any(p.is_shard() and p.dim == 2 and mesh.size(i) > 1 for i, p in enumerate(cache["k"].placements)):
            raise ValueError("the encoder-decoder decode step takes no sequence-sharded cache")
        inputs = {"tokens": tokens, "pos": pos, "cache": cache}
        logits = _data_parallel(
            cfg, params, inputs, rules,
            lambda w, b: decode_step(cfg, w, b["cache"], b["tokens"], b["pos"])[0],
        )
        return logits, cache
    h = L.embed_apply(params["embed"], tokens)  # (B, d)
    B, enc_len = h.shape[0], cache["xk"].shape[2]
    kv_len = torch.full((B,), enc_len, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"))
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        y, _ = L.attention_decode(lp["attn"], hn, kv, pos)
        h = h + y
        hn = L.apply_norm(lp["lnx"], h, cfg.norm, lp.get("lnx_b"))
        xp = lp["xattn"]
        q = L._project(hn, xp["wq"])  # (B, H, Dh)
        att = ops.decode_attention(q, cache["xk"][i], cache["xv"][i], kv_len)
        h = h + att.reshape(B, -1) @ xp["wo"].reshape(-1, h.shape[1])
        hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"))
        h = h + L.mlp_apply(lp["mlp"], hn.unsqueeze(1), cfg=cfg).squeeze(1)
    h = L.apply_norm(params["final_norm"], h, cfg.norm, params.get("final_norm_b"))
    logits = L.unembed_apply(params["embed"], h, cfg)
    return logits, cache
