"""Input and cache layouts (port of ``src/repro/launch/specs.py``): the
batch's spec tree and the logical axes that place it on a mesh, and the
decode cache the serving driver asks for by ``ShapeConfig``.  The
trainer's batches come from ``data/pipeline.py``, with ``frontend`` for
the VLM and encoder-decoder families."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import encdec, lm
from ..models.params import ParamSpec

ENC_LEN_DECODE = 3072  # encoder memory length for enc-dec decode shapes


def cache_spec_tree(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache's spec tree for ``shape``'s batch and context; an
    encoder-decoder model's adds its cross K/V of ``ENC_LEN_DECODE``
    rows."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg, B, S, ENC_LEN_DECODE)
    return lm.cache_specs(cfg, B, S)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The batch's leaves as specs (shape, dtype): ``tokens`` and
    ``labels`` (and ``frontend``) for training, ``tokens`` and ``pos`` for
    a decode step."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {
                "frontend": ParamSpec((B, S, cfg.d_model), torch.float32),
                "tokens": ParamSpec((B, S), torch.int32),
                "labels": ParamSpec((B, S), torch.int32),
            }
        St = S - cfg.n_frontend_tokens
        out = {"tokens": ParamSpec((B, St), torch.int32), "labels": ParamSpec((B, St), torch.int32)}
        if cfg.n_frontend_tokens:
            out["frontend"] = ParamSpec((B, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
        return out
    return {"tokens": ParamSpec((B,), torch.int32), "pos": ParamSpec((B,), torch.int32)}


def batch_pspec_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """Logical axes for each batch input (resolved via AxisRules)."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        if cfg.family == "encdec" or cfg.n_frontend_tokens:
            axes["frontend"] = ("batch", None, None)
        return axes
    return {"tokens": ("batch",), "pos": ("batch",)}
