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

On a mesh (``rules=``) both stacks take the dense layers' sharded paths
(``layers.py``): the residual streams on sequence slabs over "model",
tensor-parallel attention (the encoder's non-causal) and MLPs, the
cross-attention on q heads sharded over "model" over the whole memory,
and the vocab-parallel unembedding and cross-entropy of the tied
vocabulary.  In decoding, the self cache and the cross memory ``xk``/``xv``
are sharded on their rows over "model" (``seq_kv``), and each is read by
``flash_decode`` slab by slab, the slabs combined by log-sum-exp.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import spmd
from . import layers as L
from .lm import SEQ_ACT, _layer, _norm_pair, _stack, _unstack
from .params import ParamSpec


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


def _remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``cfg.remat ==
    "full"`` (the reference's ``jax.checkpoint`` of the scanned layer)."""
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mem_kv(p, mem):
    """A decoder layer's cross keys and values projected from the memory
    (the decode cache's ``xk``/``xv``)."""
    return L._project(mem, p["wk"]), L._project(mem, p["wv"])


def _positions(n: int, B: int, device, rules):
    """Positions 0..n-1 for RoPE: (B, n), or (1, n) on a mesh (every rank
    broadcasts them over its batch rows)."""
    pos = torch.arange(n, dtype=torch.int32, device=device)
    return pos[None] if rules is not None else pos.expand(B, n)


def _enc_layer_apply(cfg, lp, h, positions, rules=None):
    hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"), rules=rules, eps=cfg.norm_eps)
    hn = L.attention_apply(lp["attn"], hn, positions, cfg=cfg, rules=rules, causal=False)
    h = h + hn
    hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"), rules=rules, eps=cfg.norm_eps)
    return h + L.mlp_apply(lp["mlp"], hn, cfg=cfg, rules=rules)


def encode(cfg, params, frames, rules=None):
    """frames: (B, Se, d) precomputed frontend embeddings in the
    parameters' dtype; returns the memory (B, Se, d) after ``enc_norm``
    (on a mesh, on its sequence slabs)."""
    B, Se, _ = frames.shape
    positions = _positions(Se, B, frames.device, rules)
    x = spmd.constrain(frames, rules, SEQ_ACT)
    for lp in _unstack(params["enc_layers"], cfg.enc_layers):
        x = _remat(cfg, functools.partial(_enc_layer_apply, cfg, lp, rules=rules), x, positions)
    return L.apply_norm(params["enc_norm"], x, cfg.norm, params.get("enc_norm_b"), rules=rules, eps=cfg.norm_eps)


def _dec_layer_apply(cfg, lp, h, positions, mem, rules=None):
    if rules is None:
        # the layer reads the memory through a node of its own, so that the
        # memory's gradient sums each layer's K and V contributions before
        # it sums the layers, as on a mesh (whose per-layer gather is that
        # node): a 1 x 1 mesh is then bitwise this path
        mem = mem.view_as(mem)
    hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"), rules=rules, eps=cfg.norm_eps)
    hn = L.attention_apply(lp["attn"], hn, positions, cfg=cfg, rules=rules, causal=True)
    h = h + hn
    hn = L.apply_norm(lp["lnx"], h, cfg.norm, lp.get("lnx_b"), rules=rules, eps=cfg.norm_eps)
    h = h + L.cross_attention_apply(lp["xattn"], hn, mem, cfg=cfg, rules=rules)
    hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"), rules=rules, eps=cfg.norm_eps)
    return h + L.mlp_apply(lp["mlp"], hn, cfg=cfg, rules=rules)


def forward(cfg, params, batch, rules=None):
    """Training forward.  batch: ``frontend`` (B, Se, d) frame embeddings
    (cast to the parameters' dtype), ``tokens`` and ``labels`` (B, S) int
    tensors.  Returns ``(loss, logits (B, S, Vpad) f32)``; with ``rules``
    the batch leaves are DTensors sharded on the batch, the loss is a
    replicated DTensor and the logits are sharded on the vocabulary over
    "model" (``"tp"``)."""
    mem = encode(cfg, params, batch["frontend"].to(cfg.param_dtype), rules=rules)
    x = L.embed_apply(params["embed"], batch["tokens"], rules=rules)
    x = spmd.constrain(x, rules, ("batch", None, "embed"))
    B, S, _ = x.shape
    positions = _positions(S, B, x.device, rules)
    x = spmd.constrain(x, rules, SEQ_ACT)
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x = _remat(cfg, functools.partial(_dec_layer_apply, cfg, lp, rules=rules), x, positions, mem)
    x = L.apply_norm(params["final_norm"], x, cfg.norm, params.get("final_norm_b"), rules=rules, eps=cfg.norm_eps)
    logits = L.unembed_apply(params["embed"], x, cfg, rules=rules)
    return L.cross_entropy(logits, batch["labels"], cfg.vocab, rules=rules), logits


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
    rows of its cross memory.  With ``rules`` tokens and pos are DTensors
    sharded on the batch, each rank's slabs of the self cache are written
    in place, and the logits come back sharded on the vocabulary."""
    h = L.embed_apply(params["embed"], tokens, rules=rules)  # (B, d)
    h = spmd.constrain(h, rules, ("batch", "embed"))
    kv_len = torch.full_like(pos, cache["xk"].shape[2], dtype=torch.int32)  # every memory row
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        hn = L.apply_norm(lp["ln1"], h, cfg.norm, lp.get("ln1_b"), rules=rules, eps=cfg.norm_eps)
        y, _ = L.attention_decode(lp["attn"], hn, _layer({"k": cache["k"], "v": cache["v"]}, i), pos, cfg=cfg, rules=rules)
        h = h + y
        hn = L.apply_norm(lp["lnx"], h, cfg.norm, lp.get("lnx_b"), rules=rules, eps=cfg.norm_eps)
        mem = _layer({"k": cache["xk"], "v": cache["xv"]}, i)
        h = h + L.cross_decode(lp["xattn"], hn, mem, kv_len, cfg=cfg, rules=rules)
        hn = L.apply_norm(lp["ln2"], h, cfg.norm, lp.get("ln2_b"), rules=rules, eps=cfg.norm_eps)
        h = h + L.mlp_apply(lp["mlp"], hn.unsqueeze(1), cfg=cfg, rules=rules).squeeze(1)
    h = L.apply_norm(params["final_norm"], h, cfg.norm, params.get("final_norm_b"), rules=rules, eps=cfg.norm_eps)
    logits = L.unembed_apply(params["embed"], h, cfg, rules=rules)
    return logits, cache
