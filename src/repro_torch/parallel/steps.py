"""The training and serving steps (port of ``src/repro/parallel/steps.py``),
on one device or on a ``DeviceMesh`` with the full sharding tables.

Without a mesh the steps run on one device as before.  With ``mesh=`` the
parameters, gradients, optimizer moments, batch and cache are DTensors at
the placements of the reference's tables (``AxisRules``, ``default_rules``
for ``"tp"`` or ``"fsdp"``): ZeRO-1 puts the moments on ``zero1_pspec``'s
placements, and ZeRO-2 redistributes every gradient there right out of
the backward.  The steps run eagerly, with no ``jit`` and no donation:
``jit_train_step`` and ``jit_serve_step`` return the reference's
``(step, bundle, abstract)`` around the same eager step (CUDA-graph
capture of the decode step is ROADMAP A.9.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..launch import specs as S
from ..models import encdec, layers, lm
from ..models.params import (
    AxisRules,
    ParamSpec,
    default_rules,
    mesh_shape,
    placements,
    tree_map,
    zero1_pspec,
)
from ..optim import adamw
from . import spmd


def model_specs(cfg: ModelConfig):
    """The parameter spec tree of ``cfg``'s family."""
    return encdec.encdec_specs(cfg) if cfg.family == "encdec" else lm.lm_specs(cfg)


def param_shardings(rules: AxisRules, spec_tree):
    """Each parameter's :class:`spmd.Sharding`."""
    return tree_map(lambda s: spmd.Sharding(rules.mesh, rules.placements(s)), spec_tree)


def zero1_shardings(rules: AxisRules, spec_tree):
    """ZeRO-1: each parameter's placements plus 'data' on a free dim."""
    return tree_map(
        lambda s: spmd.Sharding(rules.mesh, placements(zero1_pspec(rules, s), rules.mesh)), spec_tree
    )


def opt_shardings(rules: AxisRules, spec_tree, opt_cfg: adamw.AdamWConfig):
    """ZeRO-1: moments (and ``err`` under ``grad_compress``) take the param
    sharding + 'data' on a free axis; the step counter is a plain tensor
    (None)."""
    moments = zero1_shardings(rules, spec_tree)
    out = {"m": moments, "v": moments, "step": None}
    if opt_cfg.grad_compress:
        out["err"] = moments
    return out


def batch_shardings(rules: AxisRules, cfg, shape: ShapeConfig):
    axes = S.batch_pspec_axes(cfg, shape)
    bspecs = S.batch_specs(cfg, shape)
    return {
        k: spmd.Sharding(rules.mesh, rules.placements_for(bspecs[k].shape, axes[k], what=f"batch.{k}"))
        for k in bspecs
    }


def _with_tp_pad(cfg: ModelConfig, mesh) -> ModelConfig:
    """Record the mesh's TP degree on the config: enables group-aligned
    head padding (exact math; see ModelConfig.head_padding) and the
    row-parallel KV fallback in attention_specs."""
    tp = mesh_shape(mesh).get("model", 1)
    if tp > 1 and cfg.n_heads:
        return dataclasses.replace(cfg, tp_pad=tp)
    return cfg


def _forward(cfg):
    return encdec.forward if cfg.family == "encdec" else lm.forward


def loss_and_grads(cfg: ModelConfig, params, batch, rules=None):
    """``(loss, grads)``: the training forward's loss and its gradient with
    respect to every parameter, a tree like ``params`` with each gradient
    in its parameter's dtype (bf16 weights give bf16 gradients, as
    ``jax.value_and_grad`` does).  On a mesh the loss comes back as a
    plain tensor, the same on every rank, and the gradients as DTensors."""
    leaves = []

    def track(t: torch.Tensor) -> torch.Tensor:
        leaf = t.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    with torch.enable_grad():
        tracked = tree_map(track, params)
        if rules is None:
            loss, _ = _forward(cfg)(cfg, tracked, batch)
        else:
            loss, _ = _forward(cfg)(cfg, tracked, batch, rules=rules)
            loss = loss.to_local()
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    *,
    mesh=None,
    rules: Optional[AxisRules] = None,
    strategy: str = "tp",
):
    """Without ``mesh``: ``(step, specs)``; ``step(params, opt_state,
    batch)`` runs one AdamW step and returns ``(params, opt_state,
    metrics)``, with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``
    (0-dim tensors on the parameters' device); the parameters and moments
    are updated in place.  ``batch`` holds ``tokens`` and ``labels`` (B, S)
    int tensors on the parameters' device, and ``frontend`` (B, Nf, d) for
    a VLM or (B, S, d) for an encoder-decoder model; ``specs`` is the
    model's parameter spec tree.  The kernels a step launches, by family,
    are listed in ``launch/train.py``.

    With ``mesh``: ``(step, bundle)``, the reference's: the same step over
    DTensors (the batch too, at ``batch_shardings``), the gradients
    redistributed to the moments' ZeRO-1 placements right out of the
    backward (ZeRO-2), and ``bundle`` with ``cfg`` (``tp_pad`` set from the
    mesh), ``rules``, ``specs``, ``param_sh``, ``opt_sh`` and ``opt_cfg``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if mesh is None:
        specs = model_specs(cfg)

        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(cfg, params, batch)
            params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
            return params, opt_state, dict(metrics, loss=loss)

        return step, specs

    cfg = _with_tp_pad(cfg, mesh)
    rules = rules or default_rules(mesh, strategy)
    spec_tree = model_specs(cfg)
    z1 = zero1_shardings(rules, spec_tree)

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, rules)
        # ZeRO-2: no rank keeps a full gradient replica
        grads = tree_map(lambda g, sh: spmd.to(g, sh.placements), grads, z1)
        params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss)

    bundle = {
        "cfg": cfg,
        "rules": rules,
        "specs": spec_tree,
        "param_sh": param_shardings(rules, spec_tree),
        "opt_sh": opt_shardings(rules, spec_tree, opt_cfg),
        "opt_cfg": opt_cfg,
    }
    return step, bundle


def jit_train_step(cfg, mesh, shape: ShapeConfig, opt_cfg=None, rules=None, strategy: str = "tp"):
    """The reference's ``(step, bundle, abstract)``.  There is no ``jit``
    and no donation: ``step`` is ``make_train_step``'s eager step, and
    ``bundle`` adds ``batch_sh``; ``abstract`` holds the parameter,
    optimizer and batch spec trees."""
    step, bundle = make_train_step(cfg, opt_cfg, mesh=mesh, rules=rules, strategy=strategy)
    bundle["batch_sh"] = batch_shardings(bundle["rules"], bundle["cfg"], shape)
    abstract = (bundle["specs"], opt_like(bundle["specs"], bundle["opt_cfg"]), S.batch_specs(bundle["cfg"], shape))
    return step, bundle, abstract


def opt_like(specs, opt_cfg: adamw.AdamWConfig):
    """The optimizer state's layout: f32 moments shaped like the
    parameters (their axes kept), and the int32 step."""
    mom = tree_map(lambda s: ParamSpec(s.shape, torch.float32, s.axes), specs)
    out = {"m": mom, "v": mom, "step": ParamSpec((), torch.int32)}
    if opt_cfg.grad_compress:
        out["err"] = mom
    return out


def make_serve_step(cfg: ModelConfig, *, mesh=None, rules: Optional[AxisRules] = None, strategy: str = "tp"):
    """Without ``mesh``: ``(step, specs)``; ``step(params, cache, tokens,
    pos)`` runs one decode step and returns ``(next_tokens (B,) int32,
    cache)``, the greedy ``argmax`` over the vocabulary (the first
    maximum, as ``jnp.argmax``; the padded columns never win);
    ``specs`` is the model's parameter spec
    tree.  The kernels a step launches, by family, are listed in
    ``launch/serve.py``.

    With ``mesh``: ``(step, bundle)``; the step takes DTensor parameters
    and cache and plain ``tokens`` and ``pos`` (every rank passes the same
    ones), shards them on the batch, and returns the next tokens as a
    plain tensor, the same on every rank (the argmax over the
    vocab-sharded logits)."""
    if mesh is None:
        specs = model_specs(cfg)
        decode = encdec.decode_step if cfg.family == "encdec" else lm.decode_step

        def step(params, cache, tokens, pos):
            logits, cache = decode(cfg, params, cache, tokens, pos)
            return layers.argmax(logits, cfg.vocab), cache

        return step, specs

    cfg = _with_tp_pad(cfg, mesh)
    rules = rules or default_rules(mesh, strategy)
    spec_tree = model_specs(cfg)
    decode = encdec.decode_step if cfg.family == "encdec" else lm.decode_step

    def step(params, cache, tokens, pos):
        B = tokens.shape[0]
        bpl = rules.placements_for((B,), ("batch",), what="tokens")
        toks = spmd.shard_full(tokens, rules.mesh, bpl)
        p = spmd.shard_full(pos, rules.mesh, bpl)
        logits, cache = decode(cfg, params, cache, toks, p, rules=rules)
        return layers.argmax(logits, cfg.vocab, rules), cache

    return step, {"cfg": cfg, "rules": rules, "specs": spec_tree, "param_sh": param_shardings(rules, spec_tree)}


def jit_serve_step(cfg, mesh, shape: ShapeConfig, rules=None, strategy: str = "tp"):
    """The reference's ``(step, bundle, abstract)``, eager (no ``jit``, no
    donation); ``bundle`` adds ``cache_sh``, and ``abstract`` holds the
    parameter and cache spec trees and the token and position specs."""
    step, bundle = make_serve_step(cfg, mesh=mesh, rules=rules, strategy=strategy)
    cache_tree = S.cache_spec_tree(bundle["cfg"], shape)
    bundle["cache_sh"] = param_shardings(bundle["rules"], cache_tree)
    b = S.batch_specs(bundle["cfg"], shape)
    return step, bundle, (bundle["specs"], cache_tree, b["tokens"], b["pos"])
