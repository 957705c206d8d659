"""The training and serving steps (port of ``make_train_step`` and
``make_serve_step`` in ``src/repro/parallel/steps.py``).

One card, no sharding: the reference's ``AxisRules``, shardings, ZeRO
placement, donation and ``jax.jit`` have no counterpart here (ROADMAP
A.10), and ``tp_pad`` stays 0, as the reference's ``_with_tp_pad`` leaves
it on a mesh whose model axis is 1.  The steps run eagerly; CUDA-graph
capture of the decode step is ROADMAP A.9.1.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..models import encdec, lm
from ..models.params import tree_map
from ..optim import adamw


def model_specs(cfg: ModelConfig):
    """The parameter spec tree of ``cfg``'s family."""
    return encdec.encdec_specs(cfg) if cfg.family == "encdec" else lm.lm_specs(cfg)


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``(loss, grads)``: the training forward's loss and its gradient with
    respect to every parameter, a tree like ``params`` with each gradient
    in its parameter's dtype (bf16 weights give bf16 gradients, as
    ``jax.value_and_grad`` does)."""
    leaves = []

    def track(t: torch.Tensor) -> torch.Tensor:
        leaf = t.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    fwd = encdec.forward if cfg.family == "encdec" else lm.forward
    with torch.enable_grad():
        tracked = tree_map(track, params)
        loss, _ = fwd(cfg, tracked, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[adamw.AdamWConfig] = None):
    """Returns ``(step, specs)``: ``step(params, opt_state, batch)`` runs
    one AdamW step and returns ``(params, opt_state, metrics)``, with
    ``loss``, ``grad_norm`` and ``lr`` in ``metrics`` (0-dim tensors on the
    parameters' device); the parameters and moments are updated in place.
    ``batch`` holds ``tokens`` and ``labels`` (B, S) int tensors on the
    parameters' device, and ``frontend`` (B, Nf, d) for a VLM or (B, S,
    d) for an encoder-decoder model; ``specs``
    is the model's parameter spec tree.  The kernels a step launches, by
    family, are listed in ``launch/train.py``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    specs = model_specs(cfg)

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss)

    return step, specs


def make_serve_step(cfg: ModelConfig):
    """Returns ``(step, specs)``: ``step(params, cache, tokens, pos)`` runs
    one decode step and returns ``(next_tokens (B,) int32, cache)``, the
    greedy ``argmax`` over the padded vocabulary (the first maximum, as
    ``jnp.argmax``); ``specs`` is the model's parameter spec tree.  The
    kernels a step launches, by family, are listed in
    ``launch/serve.py``."""
    specs = model_specs(cfg)
    decode = encdec.decode_step if cfg.family == "encdec" else lm.decode_step

    def step(params, cache, tokens, pos):
        logits, cache = decode(cfg, params, cache, tokens, pos)
        return logits.argmax(dim=-1).to(torch.int32), cache

    return step, specs
