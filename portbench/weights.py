"""The weights of a run, drawn by the benchmark from ``--seed`` on the
device, leaf by leaf from the reference's layout, each from a generator
of its own, so any leaf can be drawn again bit for bit (the reference and
the comparison of the parameters' change do so).

- ``normal``: N(0, 1) drawn in the leaf's dtype, times ``1/sqrt(fan_in)``
  with fan_in the width the leaf multiplies (d_model for q, k and v, H x
  Dh for the output projection, the vocabulary for the embedding, the
  kernel width for the convolution).
- ``ones``, ``zeros``: norm weights and biases, Mamba2's D.
- ``a_log``: log U[1, 16]; ``dt_bias``: the inverse softplus of dt drawn
  log-uniform in [1e-3, 1e-1] (Mamba2's published initialisation).
"""

from __future__ import annotations

import hashlib
import math

import torch

from .reference.layout import get, layout


def leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(cfg: dict, seed: int, path: str, device) -> torch.Tensor:
    leaf = get(layout(cfg), path)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    if leaf.init == "normal":
        out = torch.randn(leaf.shape, dtype=leaf.dtype, generator=gen, device=device)
        return out.mul_(1.0 / math.sqrt(leaf.fan_in))
    u = torch.rand(leaf.shape, dtype=torch.float32, generator=gen, device=device)
    if leaf.init == "a_log":
        return torch.log(1 + 15 * u).to(leaf.dtype)
    if leaf.init == "dt_bias":
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return (dt + torch.log(-torch.expm1(-dt))).to(leaf.dtype)
    raise ValueError(leaf.init)


def make(cfg: dict, seed: int, device) -> dict:
    """Every leaf of ``cfg``'s layout, as a nested dict of tensors."""
    return _draw_tree(cfg, seed, device, layout(cfg), "")


def _draw_tree(cfg, seed, device, tree, prefix: str):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out[k] = _draw_tree(cfg, seed, device, v, path) if isinstance(v, dict) else draw(cfg, seed, path, device)
    return out
