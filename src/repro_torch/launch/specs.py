"""Cache layouts for the serving driver (port of the decode part of
``src/repro/launch/specs.py``).

It mirrors the reference's layout: the serving driver asks for its cache
by ``ShapeConfig`` here.  The reference's batch and dry-run spec trees
feed its dry-run, which comes with multi-device (ROADMAP A.10); the
trainer's batches come from ``data/pipeline.py``, with ``frontend`` for
the VLM and encoder-decoder families."""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models import encdec, lm

ENC_LEN_DECODE = 3072  # encoder memory length for enc-dec decode shapes


def cache_spec_tree(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache's spec tree for ``shape``'s batch and context; an
    encoder-decoder model's adds its cross K/V of ``ENC_LEN_DECODE``
    rows."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg, B, S, ENC_LEN_DECODE)
    return lm.cache_specs(cfg, B, S)
