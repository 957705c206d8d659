"""The serving step (port of ``make_serve_step`` in
``src/repro/parallel/steps.py``).

One card, no sharding: the reference's ``AxisRules``, shardings and
``jax.jit`` have no counterpart here (ROADMAP A.10), and ``tp_pad`` stays
0, as the reference's ``_with_tp_pad`` leaves it on a mesh whose model
axis is 1.  The step runs eagerly; CUDA-graph capture is ROADMAP A.9.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import lm


def make_serve_step(cfg: ModelConfig):
    """Returns ``(step, specs)``: ``step(params, cache, tokens, pos)`` runs
    one decode step and returns ``(next_tokens (B,) int32, cache)``, the
    greedy ``argmax`` over the padded vocabulary (the first maximum, as
    ``jnp.argmax``); ``specs`` is the model's parameter spec tree."""
    specs = lm.lm_specs(cfg)

    def step(params, cache, tokens, pos):
        logits, cache = lm.decode_step(cfg, params, cache, tokens, pos)
        return logits.argmax(dim=-1).to(torch.int32), cache

    return step, specs
