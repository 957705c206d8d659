"""The hybrid_moe family (granite-4.0-h-small-10l) on the CPU.

- Its configuration file restates the published sizes under the
  program's names, and cuts only the layers and the experts held.
- Its layout, parameter count and model flops are frozen to their values,
  and the program counts its parameters alike.
- At the family's small cut, in float32 and in bfloat16, the program's
  loss, first gradient and change over three steps agree with the plain
  reference, and in float32 leaf by leaf.
- The shares add up: the eight cards' routed outputs of one MoE layer
  (each card's program holding its ninth of the experts), plus the shared
  expert counted once, equal the reference's uncut layer.
- The readers of its per-layer metrics read a planted summary, and nothing
  where there is nothing to read.
"""

import hashlib
import pathlib
import sys
import time
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import catalog, compare, program, weights  # noqa: E402
from portbench.arith import moe_flops  # noqa: E402
from portbench.drivers import train as drv  # noqa: E402
from portbench.generator import TrainBatches  # noqa: E402
from portbench.reference import held_moe, model  # noqa: E402
from portbench.reference.layout import layout, leaves  # noqa: E402
from portbench.reference.train import nest  # noqa: E402
from portbench_small import reduced  # noqa: E402

NAME = "granite-4.0-h-small-10l"
CELL = "granite-4.0-h-small.train-4x4k"
CONFIG = catalog.config(NAME)
FAMILY = catalog.family("hybrid_moe")
MIX = {"kind": "train", "batch": 2, "seq": 64, "zipf_a": 1.2}
SEED = 2**31 + 35

# the published sizes, under the catalog's names and the program's
SAME = {
    "hidden_size": "d_model", "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv",
    "intermediate_size": "d_expert", "num_experts_per_tok": "top_k", "num_local_experts": "experts_held",
    "vocab_size": "vocab", "num_hidden_layers": "n_layers", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings", "mamba_d_state": "ssm_state", "mamba_n_heads": "ssm_heads",
    "mamba_d_head": "ssm_head_dim", "mamba_d_conv": "conv_k", "mamba_chunk_size": "ssd_chunk",
}
FROZEN = {
    "layout": ("9c682f684e6dc314f55fab7a1e25e9e5dea8ffd4b6348472c81b631a93fa3504", 32),
    "params": 2_414_692_992,
    "flops": 169469322199040.0,
}


def test_the_file_restates_the_published_sizes():
    c = CONFIG
    for published, ours in SAME.items():
        assert c[published] == c[ours], (published, ours)
    assert c["mamba_expand"] * c["hidden_size"] == c["ssm_inner"] == c["mamba_n_heads"] * c["mamba_d_head"]
    assert c["mamba_n_groups"] == 1 and c["hidden_act"] == "silu" and c["act"] == "swiglu"
    assert c["position_embedding_type"] == "nope" and c["mamba_conv_bias"] and not c["mamba_proj_bias"]
    assert c["d_head"] * c["n_heads"] == c["d_model"]
    assert c["reduced"] == ["num_hidden_layers", "num_local_experts"]
    assert c["published"] == {"num_hidden_layers": 40, "num_local_experts": 72} and c["n_experts"] == 72
    kinds = c["layer_types"]
    assert len(kinds) == 40 and [i for i, k in enumerate(kinds) if k == "attention"] == [5, 15, 25, 35]
    mcfg = program.model_config(c)
    assert mcfg.pattern() == tuple(kinds[:10]) and mcfg.pattern().count("mamba") == 9
    assert (mcfg.held_experts(), mcfg.shared_width(), mcfg.norm_eps) == (9, 1536, 1e-5)


def test_layout_count_and_flops_are_frozen():
    rows = [(p, tuple(leaf.shape), str(leaf.dtype), leaf.init, leaf.fan_in) for p, leaf in leaves(FAMILY.layout(CONFIG))]
    assert (hashlib.sha256(repr(rows).encode()).hexdigest(), len(rows)) == FROZEN["layout"]
    assert FAMILY.param_count(CONFIG) == FROZEN["params"] == program.model_config(CONFIG).param_count()
    assert repr(FAMILY.model_flops(CONFIG, 4, 4096)) == repr(FROZEN["flops"])
    program.check_layout(program.model_config(CONFIG), layout(CONFIG))


def _at(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_the_reference(dtype):
    cfg = reduced(CONFIG, dtype)
    params = weights.make(cfg, 11, "cpu")
    toks, labels = TrainBatches(MIX, cfg["vocab"], 3).batch(0)
    toks, labels = torch.from_numpy(toks), torch.from_numpy(labels)
    loss, grads = program.train_step(cfg).loss_and_grads(params, {"tokens": toks, "labels": labels})
    flat = {p: weights.draw(cfg, 11, p, "cpu").float().requires_grad_(True) for p, _ in leaves(layout(cfg))}
    want = model.loss(cfg, nest(flat), toks, labels)
    want_grads = dict(zip(flat, torch.autograd.grad(want, list(flat.values()))))
    f32 = dtype == "float32"
    assert float(loss) == pytest.approx(float(want.detach()), rel=2e-6 if f32 else 2e-5)
    for path, g in want_grads.items():
        got = _at(grads, path).float()
        if f32:  # leaf by leaf, element by element
            assert float((got - g).abs().max()) <= 2e-5 * float(g.abs().max()) + 1e-12, path
        else:  # bf16 weights and products: the norm of each leaf's gradient
            assert float(got.norm()) == pytest.approx(float(g.norm()), rel=0.05), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_reference(dtype):
    cfg = reduced(CONFIG, dtype)
    prog = drv.Program(cfg, MIX, SEED, torch.device("cpu"))
    side = drv.program_readings(prog)
    ref = drv.reference_readings(cfg, SEED, torch.device("cpu"), prog.batch_at)
    nums = {k: v["value"] for k, v in compare.numbers(side, ref).items()}
    bound = {"float32": {"loss": 1e-6, "grad": 1e-4, "change": 1e-3}, "bfloat16": {"loss": 1e-4, "grad": 0.05,
                                                                                     "change": 0.1}}[dtype]
    assert all(nums[k] <= bound[k] for k in bound), nums
    assert len(side.losses) == len(ref.losses) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_shares_add_up_to_the_uncut_layer(dtype):
    """72 experts, top 10, over 8 cards of 9: each card's program holds its
    experts (``moe_held`` at ``e_lo = 9 r``); their outputs, plus the
    shared expert once, are the reference's layer with all 72 held."""
    from repro_torch.models import layers as PL

    c = dict(reduced(CONFIG), n_experts=72, experts_held=72, top_k=10, d_expert=32)
    gen = torch.Generator().manual_seed(7)
    d, T = c["d_model"], 96
    p = {name: (torch.randn(leaf.shape, generator=gen) / leaf.fan_in**0.5) for name, leaf in held_moe.leaves(c).items()}
    x = torch.randn(T, d, generator=gen)
    want = held_moe.block(c, model.Numerics(), p, x[None])[0]
    mcfg = program.model_config(dict(c, experts_held=9, param_dtype="bfloat16" if dtype == torch.bfloat16 else "float32"))
    xw = x.to(dtype)
    parts = []
    for r in range(8):
        share = {k: v.to(dtype) if k != "router" else v for k, v in p.items()}
        for k in ("w_gate", "w_up", "w_down"):
            share[k] = share[k][9 * r : 9 * (r + 1)]
        parts.append(PL.moe_held(share, xw, cfg=mcfg, e_lo=9 * r))
    shared = PL._shared_experts({k: v.to(dtype) for k, v in p.items()}, xw).float()
    got = sum(parts) + shared
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    # each share computes only its own experts' pairs: together every pair once
    assert all(float(part.abs().max()) > 0 for part in parts)


def _span(name, device_ms, **counters):
    return {"name": name, "attrs": {}, "device_ms": device_ms, "mem_delta": None, "counters": counters}


def _run(n_steps=2):
    return types.SimpleNamespace(trace=types.SimpleNamespace(n_steps=lambda: n_steps), config=CONFIG)


@pytest.fixture
def planted(monkeypatch):
    from repro_torch import obs

    def step(scale):
        return [
            _span("model.mamba", 10.0 * scale), _span("model.moe", 4.0 * scale),
            _span("moe.experts", 2.0 * scale, rows=20_000, max_rows=2_500),
            _span("model.mamba", 11.0 * scale), _span("model.moe", 5.0 * scale),
            _span("moe.experts", 3.0 * scale, rows=21_000, max_rows=2_600),
        ]

    monkeypatch.setattr(obs, "summary", lambda last_steps=None: {1: step(1.0), 2: step(2.0)})


def test_readers_on_a_planted_summary(planted):
    assert catalog.reader("mamba_ms")(_run()) == pytest.approx(31.5)
    assert catalog.reader("moe_ms")(_run()) == pytest.approx(13.5)
    bound = 2 * sum(moe_flops.expert_bound_s(r, 9, 4096, 768) for r in (20_000, 21_000))
    assert catalog.reader("moe_experts_roofline")(_run()) == pytest.approx(100 * bound / 0.015)


@pytest.mark.parametrize("name", ["mamba_ms", "moe_ms", "moe_experts_roofline"])
def test_nothing_to_read(monkeypatch, name):
    from repro_torch import obs

    assert catalog.reader(name)(types.SimpleNamespace(trace=None, config=CONFIG)) is None
    monkeypatch.setattr(obs, "summary", lambda last_steps=None: {1: [_span("train.forward", 5.0)]})
    assert catalog.reader(name)(_run(1)) is None
    # a program whose spans carry no counters: no roofline
    no_counters = {1: [dict(_span("moe.experts", 2.0), counters={})]}
    monkeypatch.setattr(obs, "summary", lambda last_steps=None: no_counters)
    assert catalog.reader("moe_experts_roofline")(_run(1)) is None


def test_expert_arithmetic():
    assert moe_flops.expert_ops(2_276, 4096, 768) == 6 * 2_276 * 4096 * 768
    assert moe_flops.expert_bytes(2_276, 9, 4096, 768) == (3 * 9 * 4096 * 768 + 2 * 2_276 * 4096) * 2
    # at ~2,276 rows an expert the products bound it, at a handful of rows the weights
    assert moe_flops.expert_bound_s(9 * 2_276, 9, 4096, 768) == pytest.approx(6 * 9 * 2_276 * 4096 * 768 / 989e12)
    assert moe_flops.expert_bound_s(9, 9, 4096, 768) == pytest.approx((3 * 9 * 4096 * 768 + 18 * 4096) * 2 / 3.35e12)


def test_cpu_run_of_the_cell_is_correct():
    cell = catalog.cell(CELL)
    rec = drv.run(cell, reduced(CONFIG), MIX, seed=SEED, seconds=0.1, trace=True, device="cpu", t0=time.perf_counter())
    assert rec.correct, rec.checks
    assert rec.flops_per_step == FAMILY.model_flops(reduced(CONFIG), 2, 64)
