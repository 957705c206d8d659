"""The plain reference agrees with the program's CPU path (its kernels'
plain versions) at a reduced size of each configuration: the loss, every
gradient, and one AdamW update from the same gradients.  The benchmark's
own copies (layout, traffic) match the program's."""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import catalog, program, weights  # noqa: E402
from portbench.generator import TrainBatches  # noqa: E402
from portbench.reference import adamw as ref_adamw  # noqa: E402
from portbench.reference import model  # noqa: E402
from portbench.reference.layout import layout, leaves  # noqa: E402
from portbench.reference.train import nest  # noqa: E402

import portbench_small as small  # noqa: E402

CONFIGS = ["granite-20b-4l", "zamba2-1.2b"]


def reduced(name: str, dtype: str = "float32") -> dict:
    return small.reduced(catalog.config(name), dtype)


def batch(cfg, seed=3, B=2, S=48):
    toks, labels = TrainBatches({"kind": "train", "batch": B, "seq": S, "zipf_a": 1.2}, cfg["vocab"], seed).batch(0)
    return torch.from_numpy(toks), torch.from_numpy(labels)


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_programs(name):
    cfg = catalog.config(name)
    program.check_layout(program.model_config(cfg), layout(cfg))


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_program(name):
    cfg = reduced(name)
    params = weights.make(cfg, 11, "cpu")
    tokens, labels = batch(cfg)
    step = program.train_step(cfg)
    loss, grads = step.loss_and_grads(params, {"tokens": tokens, "labels": labels})
    flat = {p: weights.draw(cfg, 11, p, "cpu").requires_grad_(True) for p, _ in leaves(layout(cfg))}
    want = model.loss(cfg, nest(flat), tokens, labels)
    want_grads = torch.autograd.grad(want, list(flat.values()))
    assert float(loss) == pytest.approx(float(want.detach()), rel=2e-6)
    tree = dict(zip(flat, want_grads))
    for path, g in tree.items():
        got = program_leaf(grads, path)
        scale = float(g.abs().max())
        assert float((got - g).abs().max()) <= 2e-5 * scale + 1e-12, path


def program_leaf(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", CONFIGS)
def test_one_adamw_update_matches_the_program(name):
    cfg = reduced(name)
    params = weights.make(cfg, 5, "cpu")
    tokens, labels = batch(cfg, seed=5)
    step = program.train_step(cfg)
    _, grads = step.loss_and_grads(params, {"tokens": tokens, "labels": labels})
    opt = step.init_opt(params)
    flat = {p: weights.draw(cfg, 5, p, "cpu").float() for p, _ in leaves(layout(cfg))}
    g = {p: program_leaf(grads, p).float() for p in flat}
    m = {p: torch.zeros_like(t) for p, t in flat.items()}
    v = {p: torch.zeros_like(t) for p, t in flat.items()}
    stored = {p: leaf.dtype for p, leaf in leaves(layout(cfg))}
    gnorm = ref_adamw.update(cfg["adamw"], flat, g, m, v, 1, stored)
    new, opt, metrics = step.update(grads, opt, params)
    assert float(metrics["grad_norm"]) == pytest.approx(gnorm, rel=1e-5)
    for p, want in flat.items():
        got = program_leaf(new, p).float()
        start = weights.draw(cfg, 5, p, "cpu").float()
        moved = float((want - start).abs().max())
        last_place = 2.0**-23 * float(start.abs().max())  # an f32 parameter's rounding
        assert float((got - want).abs().max()) <= 1e-3 * moved + last_place, p
        assert torch.allclose(program_leaf(opt["m"], p), m[p], rtol=1e-5, atol=1e-12)


def test_bf16_storage_is_the_programs():
    """A bf16 parameter keeps each update rounded to bf16, on both sides."""
    cfg = reduced("granite-20b-4l", "bfloat16")
    p = weights.draw(cfg, 1, "layers.mlp.w_in", "cpu")
    assert p.dtype == torch.bfloat16
    flat = {"w": p.float()}
    g = {"w": torch.randn(p.shape, generator=torch.Generator().manual_seed(0))}
    ref_adamw.update(cfg["adamw"], flat, g, {"w": torch.zeros_like(flat["w"])}, {"w": torch.zeros_like(flat["w"])}, 1,
                     {"w": torch.bfloat16})
    assert torch.equal(flat["w"], flat["w"].to(torch.bfloat16).float())


def test_weights_are_drawn_again_bit_for_bit():
    cfg = reduced("zamba2-1.2b", "bfloat16")
    for path, leaf in leaves(layout(cfg)):
        a, b = weights.draw(cfg, 2**31 + 9, path, "cpu"), weights.draw(cfg, 2**31 + 9, path, "cpu")
        assert a.dtype == leaf.dtype and tuple(a.shape) == leaf.shape
        assert torch.equal(a, b)
    a = weights.draw(cfg, 1, "layers.mamba.A_log", "cpu")
    assert float(a.min()) >= 0 and float(a.max()) <= np.log(16) + 1e-6


@pytest.mark.parametrize("seed", [0, 2**31 + 77])
def test_traffic_is_the_programs_token_source(seed):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenSource

    cfg = catalog.config("zamba2-1.2b")
    mine = TrainBatches({"kind": "train", "batch": 3, "seq": 256, "zipf_a": 1.2}, cfg["vocab"], seed)
    theirs = TokenSource(program.model_config(cfg), ShapeConfig("train_256", 256, 3, "train"), DataConfig(seed=seed))
    for step in (0, 5):
        toks, labels = mine.batch(step)
        b = theirs.batch_at(step)
        assert np.array_equal(toks, b["tokens"]) and np.array_equal(labels, b["labels"])
    assert not np.array_equal(mine.batch(0)[0], mine.batch(1)[0])
