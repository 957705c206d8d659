"""Cache layouts for the serving driver (port of the decode part of
``src/repro/launch/specs.py``).

It mirrors the reference's layout: the serving driver asks for its cache
by ``ShapeConfig`` here, and the batch and dry-run spec trees of that file
join it when the training path is ported (ROADMAP A.7)."""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models import lm


def cache_spec_tree(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache's spec tree for ``shape``'s batch and context (the
    families the port does not run raise in ``lm.cache_specs``)."""
    return lm.cache_specs(cfg, shape.global_batch, shape.seq_len)
