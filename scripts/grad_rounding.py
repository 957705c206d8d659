#!/usr/bin/env python3
"""Where a card-vs-CPU train step's gradient gap comes from, on one CUDA card.

    python3 scripts/grad_rounding.py [--arch granite-20b]

Runs the train cross-check's step of ``chip_smoke.py`` (the model at full
width, 1 layer, f32, TF32 off, batch 1 of 256 tokens, the same weights
and tokens) four ways: on the card through the CUDA kernels; on the card
with the plain versions in place of every attention and norm kernel; on
the CPU (the plain versions); and on the CPU in f64 throughout, the
anchor.  For each gradient leaf it prints each f32 step's largest
distance from the f64 step over that leaf's largest magnitude, and the
card's distance from the CPU's, the cross-check's measure.  Then it runs
the attention alone on the step's own inputs (q, k, v and the output
gradient, as the CPU step saw them): dq, dk and dv of the kernels and of
the plain version in f32 against the plain version in f64, with the
share of rows whose softmax is one-hot.  It prints one JSON object.
"""

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import norms, ref  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.parallel import steps  # noqa: E402


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree.detach().double().cpu()}


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card_name = subprocess.run(smi, capture_output=True, text=True).stdout.strip()

    cfg = dataclasses.replace(
        registry.get(args.arch), n_layers=cs.CROSS_TRAIN["n_layers"], param_dtype=torch.float32
    )
    cpu, card = cs._cross_weights(cfg, 3)
    B, S = cs.CROSS_TRAIN["batch"], cs.CROSS_TRAIN["seq"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    on_card = {k: t.cuda() for k, t in batch.items()}

    kernel_attn, kernel_norm = fa.flash_attention, norms.layernorm
    if cfg.norm == "rms":
        kernel_norm = norms.rmsnorm

    def plain_attn(q, k, v, causal=True, window=0):
        return ref.attention(q, k, v, causal=causal, window=window)

    plain_norm = ref.layernorm if cfg.norm == "ln" else ref.rmsnorm
    norm_name = "layernorm" if cfg.norm == "ln" else "rmsnorm"

    def step(params, b, attn, norm):
        fa.flash_attention = attn
        setattr(norms, norm_name, norm)
        try:
            return leaves(steps.loss_and_grads(cfg, params, b)[1])
        finally:
            fa.flash_attention = kernel_attn
            setattr(norms, norm_name, kernel_norm)

    captured = {}

    def capture(q, k, v, causal=True, window=0):
        captured["qkv"] = [t.detach().clone() for t in (q, k, v)]
        out = plain_attn(q, k, v, causal=causal, window=window)
        out.register_hook(lambda g: captured.__setitem__("do", g.detach().clone()))
        return out

    runs = {
        "card_kernels": step(card, on_card, kernel_attn, kernel_norm),
        "card_plain": step(card, on_card, plain_attn, plain_norm),
        "cpu": step(cpu, batch, capture, plain_norm),
    }
    cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64)
    f64 = leaves(steps.loss_and_grads(cfg64, tree_map(lambda t: t.double(), cpu), batch)[1])
    per_leaf = {
        leaf: {
            **{f"{name}_from_f64": gap(run[leaf], want) for name, run in runs.items()},
            **{
                f"{name}_from_cpu": gap(run[leaf], runs["cpu"][leaf])
                for name, run in runs.items()
                if name != "cpu"
            },
        }
        for leaf, want in f64.items()
    }

    q, k, v = captured["qkv"]
    do = captured["do"]

    def attn_grads(fn, device, dtype):
        ins = [t.to(device, dtype).clone().requires_grad_() for t in (q, k, v)]
        fn(*ins, causal=True, window=0).backward(do.to(device, dtype).clone())
        return [t.grad.double().cpu() for t in ins]

    want = attn_grads(plain_attn, "cpu", torch.float64)
    attention = {
        name: dict(zip(("dq", "dk", "dv"), (gap(g, w) for g, w in zip(got, want))))
        for name, got in (
            ("kernels", attn_grads(kernel_attn, "cuda", torch.float32)),
            ("plain_card", attn_grads(plain_attn, "cuda", torch.float32)),
            ("plain_cpu", attn_grads(plain_attn, "cpu", torch.float32)),
        )
    }
    g = q.shape[-2] // k.shape[-2]
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.double(), k.double().repeat_interleave(g, dim=-2)
    ) / np.sqrt(q.shape[-1])
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    p_max = scores.masked_fill(~causal, -np.inf).softmax(-1).amax(-1)
    print(
        json.dumps(
            {
                "card": card_name,
                "arch": args.arch,
                **cs.CROSS_TRAIN,
                "grad_gap_of_max": per_leaf,
                "worst_from_cpu": {
                    name: max(d[f"{name}_from_cpu"] for d in per_leaf.values())
                    for name in ("card_kernels", "card_plain")
                },
                "attention_grad_gap_from_f64": attention,
                "rows_one_hot_share": float((p_max > 1 - 1e-7).double().mean()),
                "score_std": float(scores.masked_select(causal.expand_as(scores)).std()),
            },
            indent=1,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
