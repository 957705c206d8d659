"""Deterministic sharded data pipeline (a copy of
``src/repro/data/pipeline.py``, which is numpy only: the port keeps its
own, so that it imports nothing of the JAX package).  Its batches equal
the reference's bit for bit.

Design for the 1000-node posture:
* every (step, dp_rank) pair maps to a unique deterministic sample set —
  resume after failure or *elastic re-partitioning* (different dp world
  size) never replays or skips data;
* the iterator is stateless (`batch_at(step)`), so checkpoints only need
  the step counter — no iterator state to persist;
* sources: synthetic LM stream (default; token statistics controllable)
  or a memory-mapped token file (binary .npy of uint16/uint32).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    kind: str = "synthetic"       # synthetic | file
    path: Optional[str] = None    # token file for kind="file"
    zipf_a: float = 1.2           # synthetic vocabulary skew


class TokenSource:
    """Deterministic token batches: batch_at(step) -> {tokens, labels}."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        if data_cfg.kind == "file":
            if not data_cfg.path:
                raise ValueError("file source needs path")
            self._tokens = np.load(data_cfg.path, mmap_mode="r")
        else:
            self._tokens = None

    def _rng(self, step: int) -> np.random.Generator:
        h = hashlib.sha256(
            f"{self.data_cfg.seed}/{self.shape.name}/{step}".encode()
        ).digest()
        return np.random.default_rng(int.from_bytes(h[:8], "little"))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B = self.shape.global_batch
        S = self.shape.seq_len
        cfg = self.cfg
        if cfg.n_frontend_tokens and cfg.family != "encdec":
            S_text = S - cfg.n_frontend_tokens
        else:
            S_text = S
        rng = self._rng(step)
        if self._tokens is not None:
            n = self._tokens.shape[0] - (S_text + 1)
            starts = rng.integers(0, n, size=B)
            toks = np.stack([self._tokens[s:s + S_text + 1] for s in starts])
            toks = toks.astype(np.int32) % cfg.vocab
        else:
            # zipf-ish synthetic stream with local structure (bigram walk)
            toks = rng.zipf(self.data_cfg.zipf_a,
                            size=(B, S_text + 1)).astype(np.int64)
            toks = (toks - 1) % cfg.vocab
            toks = toks.astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            batch["frontend"] = rng.normal(
                size=(B, S, cfg.d_model)).astype(np.float32)
        elif cfg.n_frontend_tokens:
            batch["frontend"] = rng.normal(
                size=(B, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32)
        return batch

    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
