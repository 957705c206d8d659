"""Cache layouts for the serving driver (port of the decode part of
``src/repro/launch/specs.py``).

It mirrors the reference's layout: the serving driver asks for its cache
by ``ShapeConfig`` here.  The reference's batch and dry-run spec trees
feed its dry-run, which comes with multi-device (ROADMAP A.10); the
trainer's batches come from ``data/pipeline.py``, with ``frontend`` for
the VLM family."""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models import lm


def cache_spec_tree(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache's spec tree for ``shape``'s batch and context (the
    encoder-decoder family, not ported yet, raises in
    ``lm.cache_specs``)."""
    return lm.cache_specs(cfg, shape.global_batch, shape.seq_len)
