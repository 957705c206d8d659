"""The generator of training traffic: a mix file of
``portbench/traffic/`` gives its parameters, ``--seed`` its draws.

``kind: "train"`` -- every step one batch of ``batch`` rows of ``seq``
tokens and their next-token labels, drawn from a Zipf law of exponent
``zipf_a`` folded onto the vocabulary.  Row sets of different steps
differ; step ``i`` of a seed is the same batch in every run.  The draws
are those of the program's synthetic token source
(``repro_torch/data/pipeline.py``, copied here so that a change of the
program cannot change the traffic): a generator per step seeded from
``sha256("<seed>/train_<seq>/<step>")``.
"""

from __future__ import annotations

import hashlib

import numpy as np


def check(mix: dict) -> None:
    if mix.get("kind") != "train":
        raise ValueError(f"not a training mix: kind {mix.get('kind')!r}")
    for key in ("batch", "seq", "zipf_a"):
        if key not in mix:
            raise ValueError(f"training mix lacks {key!r}")


class TrainBatches:
    """``batch(step) -> (tokens, labels)``, int32 arrays of (batch, seq)."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        check(mix)
        self.B, self.S, self.a = int(mix["batch"]), int(mix["seq"]), float(mix["zipf_a"])
        self.vocab, self.seed = int(vocab), int(seed)

    @property
    def tokens_per_step(self) -> int:
        return self.B * self.S

    def _rng(self, step: int) -> np.random.Generator:
        h = hashlib.sha256(f"{self.seed}/train_{self.S}/{step}".encode()).digest()
        return np.random.default_rng(int.from_bytes(h[:8], "little"))

    def batch(self, step: int):
        toks = self._rng(step).zipf(self.a, size=(self.B, self.S + 1)).astype(np.int64)
        toks = ((toks - 1) % self.vocab).astype(np.int32)
        return toks[:, :-1], toks[:, 1:]
