"""The parameter layout of a configuration and how each leaf is drawn.

A nested dict of :class:`Leaf` (shape, dtype, init rule) in the program's
layout: every leaf under ``layers`` has a leading layer axis, and a block
outside the stack (the hybrid family's ``shared_attn``) has none.  The
benchmark draws the weights from this layout (``portbench/weights.py``)
and hands the same tensors to the program and to the plain reference;
the reference reads its shapes from here, never from the program.

Each family's module (``portbench/families/<family>.py``) builds its
tree from the blocks here; :func:`layout` finds it by the
configuration's ``family``.  A configuration is a dict of the keys in
``portbench/configs/*.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import torch

from .. import catalog

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str  # normal | ones | zeros | a_log | dt_bias
    fan_in: int = 1  # normal: std = 1 / sqrt(fan_in)


def round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def sizes(cfg: dict) -> dict:
    """The configuration's sizes, with the derived ones filled in: the
    head width where there are heads, the SSM inner width and heads where
    there is an SSM state, the padded vocabulary."""
    out = dict(cfg)
    out.setdefault("d_head", 0)
    if not out["d_head"] and cfg["n_heads"]:
        out["d_head"] = cfg["d_model"] // cfg["n_heads"]
    if cfg.get("ssm_state"):
        out.setdefault("ssm_inner", 2 * cfg["d_model"])
        out["ssm_inner"] = out["ssm_inner"] or 2 * cfg["d_model"]
        out.setdefault("ssm_heads", 0)
        out["ssm_heads"] = out["ssm_heads"] or out["ssm_inner"] // cfg["ssm_head_dim"]
    out["vocab_padded"] = round_up(cfg["vocab"], 256)
    return out


def _norm(cfg, stack=()) -> Dict[str, Leaf]:
    d = cfg["d_model"]
    out = {"w": Leaf(stack + (d,), torch.float32, "ones")}
    if cfg["norm"] == "ln":
        out["b"] = Leaf(stack + (d,), torch.float32, "zeros")
    return out


def norm_pair(cfg, name: str, stack=()) -> Dict[str, Leaf]:
    n = _norm(cfg, stack)
    sp = {name: n["w"]}
    if "b" in n:
        sp[name + "_b"] = n["b"]
    return sp


def attention(cfg, stack=()) -> Dict[str, Leaf]:
    d, H, Hkv, Dh = cfg["d_model"], cfg["n_heads"], cfg["n_kv"], cfg["d_head"]
    dt = DTYPES[cfg["param_dtype"]]
    return {
        "wq": Leaf(stack + (d, H, Dh), dt, "normal", d),
        "wk": Leaf(stack + (d, Hkv, Dh), dt, "normal", d),
        "wv": Leaf(stack + (d, Hkv, Dh), dt, "normal", d),
        "wo": Leaf(stack + (H, Dh, d), dt, "normal", H * Dh),
    }


def mlp(cfg, stack=()) -> Dict[str, Leaf]:
    d, f = cfg["d_model"], cfg["d_ff"]
    dt = DTYPES[cfg["param_dtype"]]
    if cfg["act"] == "swiglu":
        return {
            "w_gate": Leaf(stack + (d, f), dt, "normal", d),
            "w_up": Leaf(stack + (d, f), dt, "normal", d),
            "w_down": Leaf(stack + (f, d), dt, "normal", f),
        }
    return {"w_in": Leaf(stack + (d, f), dt, "normal", d), "w_out": Leaf(stack + (f, d), dt, "normal", f)}


def dense_layer(cfg, stack=()) -> Dict[str, object]:
    sp: Dict[str, object] = {}
    sp.update(norm_pair(cfg, "ln1", stack))
    sp["attn"] = attention(cfg, stack)
    sp.update(norm_pair(cfg, "ln2", stack))
    sp["mlp"] = mlp(cfg, stack)
    return sp


def mamba2(cfg, stack=()) -> Dict[str, Leaf]:
    d, di = cfg["d_model"], cfg["ssm_inner"]
    H, N, K = cfg["ssm_heads"], cfg["ssm_state"], cfg["conv_k"]
    dt = DTYPES[cfg["param_dtype"]]
    f32 = torch.float32
    return {
        "w_in": Leaf(stack + (d, 2 * di + 2 * N + H), dt, "normal", d),
        "conv": Leaf(stack + (K, di + 2 * N), dt, "normal", K),
        "A_log": Leaf(stack + (H,), f32, "a_log"),
        "D": Leaf(stack + (H,), f32, "ones"),
        "dt_bias": Leaf(stack + (H,), f32, "dt_bias"),
        "norm": Leaf(stack + (di,), f32, "ones"),
        "w_out": Leaf(stack + (di, d), dt, "normal", di),
    }


def lm(cfg: dict, layers: Dict[str, object], **blocks) -> Dict[str, object]:
    """The tree of a decoder-only model of sized ``cfg``: the (tied)
    embedding, the final norm, the stacked ``layers`` and any ``blocks``
    outside the stack."""
    dt = DTYPES[cfg["param_dtype"]]
    Vp = cfg["vocab_padded"]
    tree: Dict[str, object] = {"embed": {"tok": Leaf((Vp, cfg["d_model"]), dt, "normal", Vp)}}
    tree.update(norm_pair(cfg, "final_norm"))
    tree["layers"] = layers
    tree.update(blocks)
    return tree


def layout(cfg: dict) -> Dict[str, object]:
    """The parameter tree of ``cfg``, as its family builds it."""
    return catalog.family(cfg["family"]).layout(cfg)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(dotted path, leaf)`` for every leaf, keys in sorted order."""
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], path)
        else:
            yield path, tree[k]


def get(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
