"""Weights and caches carried across from the JAX package.

The JAX package initialises its parameters with ``jax.random``, which
torch cannot reproduce, so both packages compute from the same weights
only when one is handed the other's.  :func:`from_jax_params` takes the
tree that ``repro.models.params.init_params(model_specs(cfg), key)``
returns, as nested dicts of numpy arrays (``np.asarray`` of each leaf),
and returns the port's parameters; :func:`cache_from_numpy` does the same
for a decode cache.  Both keep the stacked-layer layout as it is
(``params["layers"]`` leaves lead with ``n_layers``, an encoder-decoder
model's ``enc_layers`` and ``dec_layers`` with their depths, the MoE
experts are ``(n_layers, E, d, fe)`` and ``(n_layers, E, fe, d)`` with the
router in f32, and the hybrid family's ``shared_attn`` has no layer axis;
every cache leaf is
``(n_layers, B, ...)``, but the hybrid family's ``k``/``v`` rings, which
lead with the number of shared-block applications), since the port's
layout is the reference's.  Every leaf is checked against the port's
spec tree: same keys, shapes and dtypes.

This module takes numpy arrays only, so it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..parallel.steps import model_specs
from . import encdec, lm
from .params import ParamSpec, is_spec


def _to_tensor(a: np.ndarray, spec: ParamSpec, where: str, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if tuple(t.shape) != tuple(spec.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)}, the port expects {spec.shape}")
    if t.dtype != spec.dtype:
        raise ValueError(f"{where}: dtype {t.dtype}, the port expects {spec.dtype}")
    return t.to(device)


def _carry(spec_tree, tree, device, where: str = "") -> Any:
    if is_spec(spec_tree):
        return _to_tensor(tree, spec_tree, where or "leaf", device)
    if not isinstance(tree, dict) or set(tree) != set(spec_tree):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{where or 'tree'}: keys {got}, the port expects {sorted(spec_tree)}")
    return {
        k: _carry(spec_tree[k], tree[k], device, f"{where}.{k}" if where else k)
        for k in spec_tree
    }


def from_jax_params(cfg, tree, device) -> Any:
    """The port's parameters for ``cfg`` from the JAX package's parameter
    tree (numpy leaves), on ``device``."""
    return _carry(model_specs(cfg), tree, torch.device(device))


def cache_from_numpy(cfg, tree, device) -> Any:
    """The port's decode cache from a JAX cache tree (numpy leaves: K/V of
    shape ``(n_layers, B, S, Hkv, Dh)``, the SSM state ``h`` and ``conv``,
    or both, the hybrid family's K/V rings leading with its applications,
    and an encoder-decoder model's cross K/V ``xk``/``xv``), on
    ``device``.  The batch is axis 1 of every leaf; the length, axis 2 of
    K (an SSM cache has none; a ring's is its W rows); the encoder
    memory's, axis 2 of ``xk``."""
    batch = np.shape(next(iter(tree.values())))[1]
    seq_len = np.shape(tree["k"])[2] if "k" in tree else 0
    if cfg.family == "encdec":
        specs = encdec.cache_specs(cfg, batch, seq_len, np.shape(tree["xk"])[2])
    else:
        specs = lm.cache_specs(cfg, batch, seq_len)
    return _carry(specs, tree, torch.device(device))


def shard_params(tree, bundle) -> Any:
    """Place carried weights (full tensors, the same on every rank) on the
    mesh of a step bundle: each leaf a DTensor at ``bundle["param_sh"]``'s
    placements, of which this rank keeps its slice.  A padded config
    (``tp_pad``) takes the reference's padded leaves as they are."""
    from ..models.params import shard_full, tree_map

    return tree_map(lambda t, sh: shard_full(t, sh.mesh, sh.placements), tree, bundle["param_sh"])


def gather_params(tree) -> Any:
    """The inverse of :func:`shard_params`: every DTensor leaf's full
    tensor (a collective: every rank calls it)."""
    from ..models.params import tree_map

    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)
