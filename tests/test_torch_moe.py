"""The port's MoE family against the JAX package, on the CPU.

Configs: ``deepseek-moe-16b-smoke`` (f32, 2 layers, d_model 64, 4 experts
of 32, top 2, one shared expert, MHA 4/2 heads of 16) and
``granite-moe-1b-a400m-smoke`` (the same without shared experts), both at
the smoke twin's no-drop ``capacity_factor`` 8 and at 0.5 and 0.25, where
tokens drop.  Weights: ``tests/torch_models.py``.

- ``topk_gate`` equals ``lax.top_k`` and its softmax: the indices bitwise
  (ties to the lower index), the weights to 1e-6;
- ``moe_capacity`` equals the reference's over a sweep;
- ``moe_apply`` matches the reference's within 1e-5 of its scale, and the
  kept/dropped choice of every (token, j) equals the reference's bitwise
  (the reference's own mask, read from its ``jnp.where``), with drops at
  the tight factors and none at 8; with no drops it matches the dense
  oracle ``moe_apply_dense``, which matches the reference's;
- the MoE block's gradients (router included) match ``jax.grad`` within
  1e-4 of their scale, with and without drops;
- the spec trees match the reference's, at the smoke and the published
  widths;
- ``forward`` matches the reference's plain path and its Pallas kernels
  (``interpret``), logits within 1e-4 of their scale as in
  ``tests/test_torch_train.py`` (rope's ulp), the loss within 1e-5; the
  model's gradients match the port's own in f64 within 1e-4 and
  ``jax.grad``'s within 2e-4 (``torch_models.check_grads`` says why);
  decode steps match (1e-5; Pallas 1e-4);
- granite-moe-1b-a400m at its published widths, one layer: ``forward``
  and a decode step match;
- three train steps match the reference's ``jit_train_step``;
- the server gives the reference server's tokens, token for token, and
  ``serve_requests`` the same counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.configs import registry as preg
from repro_torch.core.types import CoxUnsupported
from repro_torch.kernels import ops
from repro_torch.launch import serve as pserve
from repro_torch.models import layers as pL
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from torch_models import (
    as_jax,
    assert_same_specs,
    auto_mesh,
    both_weights,
    check_forward_and_decode,
    check_grads,
    close_to_scale,
    configs,
    drive_servers,
    forward_both,
    get_path,
    jax_weights,
    leaves_with_paths,
    published_f32,
    random_caches,
    servers,
    tokens_batch,
    train_steps_both,
)

DEEPSEEK = "deepseek-moe-16b-smoke"  # shared experts
GRANITE_MOE = "granite-moe-1b-a400m-smoke"  # none; GQA
ARCHS = [DEEPSEEK, GRANITE_MOE]
FACTORS = [8.0, 0.5, 0.25]  # 8 never drops; 0.5 and 0.25 do


def moe_params(cj, seed):
    """One layer's MoE weights as numpy."""
    spec = jL.moe_specs(cj)
    tree = jparams.init_params(spec, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, tree)


def moe_inputs(cj, seed, B=3, S=16):
    return np.random.default_rng(seed).normal(size=(B, S, cj.d_model)).astype(np.float32)


class _WhereSpy:
    """Stands in for ``jnp`` in the reference's layers module and records
    the mask of every ``jnp.where``: in ``_moe_local`` these are the k
    kept/dropped masks, in choice order."""

    def __init__(self):
        self.masks = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, cond, *args):
        self.masks.append(np.asarray(cond))
        return jnp.where(cond, *args)


# ---------------------------------------------------------------------------
# the router and the capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k", [(37, 4, 2), (16, 64, 6), (9, 32, 8)])
def test_topk_gate_matches_jax(T, E, k):
    logits = np.random.default_rng(T).normal(size=(T, E)).astype(np.float32)
    logits[:, 1] = logits[:, 2]  # a tie in every row
    wj, ij = jops.topk_gate(jnp.asarray(logits), k)
    wp, ip = ops.topk_gate(torch.from_numpy(logits), k)
    assert wp.dtype == torch.float32 and wp.shape == (T, k)
    assert np.array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_gate_takes_the_lowest_indices_on_ties(dtype):
    """All-equal logits: the lowest k indices, in order, and weights 1/k,
    bitwise as the reference's ``lax.top_k``."""
    logits = np.full((5, 8), 0.25, np.float32)
    wj, ij = jops.topk_gate(jnp.asarray(logits), 3)
    wp, ip = ops.topk_gate(torch.from_numpy(logits).to(dtype), 3)
    assert ip.tolist() == [[0, 1, 2]] * 5
    assert np.array_equal(ip.numpy(), np.asarray(ij))
    assert np.array_equal(wp.numpy(), np.asarray(wj))


def test_moe_capacity_matches_the_reference():
    for arch in ("deepseek-moe-16b", "granite-moe-1b-a400m"):
        for smoke in (False, True):
            for cf in (0.25, 0.5, 1.0, 1.25, 8.0):
                cj = dataclasses.replace(jreg.get(arch, smoke), capacity_factor=cf)
                cp = dataclasses.replace(preg.get(arch, smoke), capacity_factor=cf)
                for n in (1, 2, 4, 7, 64, 100, 4096, 8192):
                    assert pL.moe_capacity(cp, n) == jL.moe_capacity(cj, n), (arch, cf, n)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(monkeypatch, arch, cf):
    """The output within 1e-5 of its scale, and every (token, j) pair kept
    or dropped as in the reference, bitwise."""
    cj, cp = configs(arch, capacity_factor=cf)
    p = moe_params(cj, seed=1)
    x = moe_inputs(cj, seed=2)
    spy = _WhereSpy()
    monkeypatch.setattr(jL, "jnp", spy)
    want = jL.moe_apply(as_jax(p), jnp.asarray(x), cfg=cj)
    monkeypatch.undo()
    assert len(spy.masks) == cj.top_k
    pp = pparams.tree_map(torch.from_numpy, p)
    xt = torch.from_numpy(x)
    got = pL.moe_apply(pp, xt, cfg=cp)
    close_to_scale(got, want, 1e-5)
    T = x.shape[0] * x.shape[1]
    C = pL.moe_capacity(cp, T)
    _, idx = ops.topk_gate(xt.reshape(T, -1) @ pp["router"], cp.top_k)
    _, keeps = pL._gshard_slots(idx, E=cp.n_experts, C=C, e_lo=0, E_loc=cp.n_experts)
    kept = np.stack([k.numpy() for k in keeps])
    assert np.array_equal(kept, np.stack(spy.masks))
    assert kept.all() == (cf == 8.0)  # the tight factors drop tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_the_dense_oracle(arch):
    """No drops at the smoke twin's factor 8: the capacity path equals the
    dense dispatch within 1e-5, and the port's oracle the reference's."""
    cj, cp = configs(arch)
    p = moe_params(cj, seed=3)
    x = moe_inputs(cj, seed=4, B=2, S=16)
    pp = pparams.tree_map(torch.from_numpy, p)
    dense = pL.moe_apply_dense(pp, torch.from_numpy(x), cfg=cp)
    close_to_scale(pL.moe_apply(pp, torch.from_numpy(x), cfg=cp), dense.numpy(), 1e-5)
    close_to_scale(dense, jL.moe_apply_dense(as_jax(p), jnp.asarray(x), cfg=cj), 1e-5)


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax(arch, cf):
    """Gradients of a weighted sum of the block's output, with respect to
    the input and every weight (the router through the gate weights),
    within 1e-4 of their scale."""
    cj, cp = configs(arch, capacity_factor=cf)
    p = moe_params(cj, seed=5)
    x = moe_inputs(cj, seed=6)
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def loss_j(p, x):
        return (jL.moe_apply(p, x, cfg=cj) * g).sum()

    want_p, want_x = jax.grad(loss_j, argnums=(0, 1))(as_jax(p), jnp.asarray(x))
    pp = pparams.tree_map(lambda a: torch.from_numpy(a).requires_grad_(True), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    (pL.moe_apply(pp, xt, cfg=cp) * torch.from_numpy(g)).sum().backward()
    close_to_scale(xt.grad, want_x, 1e-4)
    for path, leaf in leaves_with_paths(pp):
        assert leaf.grad is not None and leaf.grad.abs().max() > 0, path
        close_to_scale(leaf.grad, get_path(want_p, path), 1e-4)


def test_moe_apply_refuses_a_mesh():
    """The expert-parallel path on a 1 x 1 ("data", "model") mesh (the
    refusal it replaces was lifted by ROADMAP A.10.2): bitwise the local
    path, since one rank holds every expert and the whole token slab."""
    from torch.distributed.tensor import DTensor

    from torch_suite import one_rank_mesh

    cj, cp = configs(DEEPSEEK)
    pp = pparams.tree_map(torch.from_numpy, moe_params(cj, seed=8))
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 8, cp.d_model)).astype(np.float32))
    want = pL.moe_apply(pp, x, cfg=cp)
    with one_rank_mesh(("data", "model")) as mesh:
        rules = pparams.default_rules(mesh)
        specs = pL.moe_specs(cp)
        pd = pparams.tree_map(lambda t, s: pparams.shard_full(t, mesh, rules.placements(s)), pp, specs)
        xd = pparams.shard_full(x, mesh, rules.placements_for(x.shape, ("batch", None, "embed")))
        got = pL.moe_apply(pd, xd, cfg=cp, rules=rules)
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-1b-a400m"])
def test_moe_spec_trees_match_the_reference(arch, smoke):
    """The router in f32 (d, E), the experts (L, E, d, fe) and (L, E, fe,
    d), the shared experts where ``n_shared`` is set; the KV cache."""
    cj, cp = jreg.get(arch, smoke), preg.get(arch, smoke)
    specs = plm.lm_specs(cp)
    assert_same_specs(specs, jlm.lm_specs(cj))
    moe = specs["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    E, fe = cp.n_experts, cp.d_expert
    assert moe["w_gate"].shape == (cp.n_layers, E, cp.d_model, fe)
    assert moe["w_down"].shape == (cp.n_layers, E, fe, cp.d_model)
    assert ("s_gate" in moe) == bool(cp.n_shared)
    assert_same_specs(plm.cache_specs(cp, 4, 512), jlm.cache_specs(cj, 4, 512))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, cf, backend):
    cj, cp = configs(arch, capacity_factor=cf)
    pj, pp = both_weights(cj, cp, seed=9)
    batch = tokens_batch(cj, 2, 64, seed=10)
    (loss_j, logits_j), (loss_p, logits_p) = forward_both(cj, cp, pj, pp, batch, backend)
    assert logits_p.shape == logits_j.shape
    close_to_scale(logits_p, logits_j, 1e-4)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch, cf):
    """Every gradient within 1e-4 of its scale of the port's own in f64,
    and within 2e-4 of ``jax.grad``'s (``torch_models.check_grads``)."""
    cj, cp = configs(arch, capacity_factor=cf, remat="full")
    grads = check_grads(cj, cp, jax_weights(cj, seed=11), tokens_batch(cj, 2, 64, seed=12))
    assert float(grads["layers"]["moe"]["router"].abs().max()) > 0


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, backend, tol):
    """Decode steps on a stale cache, each MoE block at the step's
    capacity ``moe_capacity(cfg, B)``: logits and K/V caches within tol of
    their scale, the same greedy tokens."""
    cj, cp = configs(arch)
    pj, pp = both_weights(cj, cp, seed=13)
    B, S = 3, 128  # S a multiple of the Pallas decode block
    cache_j, cache_p = random_caches(cj, cp, B, S, seed=14)
    rng = np.random.default_rng(15)
    for step in range(3):
        toks = rng.integers(0, cj.vocab, size=B).astype(np.int32)
        pos = np.array([step, 60 + step, S - 2 + step], np.int32)
        lj, cache_j = jlm.decode_step(
            cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend=backend
        )
        lp, cache_p = plm.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
        close_to_scale(lp, lj, tol)
        for leaf in ("k", "v"):
            close_to_scale(cache_p[leaf], cache_j[leaf], tol)
        assert torch.equal(lp.argmax(-1), torch.from_numpy(np.asarray(jnp.argmax(lj, -1))))


def test_published_width_matches_jax():
    """granite-moe-1b-a400m at its published widths (d 1,024, 32 experts of
    512, top 8, GQA 16/8), one layer, f32: forward and a decode step."""
    check_forward_and_decode(*published_f32("granite-moe-1b-a400m"))


def test_three_train_steps_match_jax():
    """deepseek-moe-16b-smoke: losses within 1e-5, grad norms within 1e-3,
    every parameter within 1e-5 of its scale after three steps (the
    settings and reasons of ``tests/test_torch_train.py``)."""
    run = train_steps_both(DEEPSEEK)
    for _ in range(3):
        pm, jm = next(run)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    pp, jp = next(run)
    for path, want in leaves_with_paths(jp):
        close_to_scale(get_path(pp, path), want, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_the_jax_server(arch):
    js, ps = servers(arch, batch=2, ctx=32)
    assert set(ps.cache) == set(js.cache) == {"k", "v"}
    drive_servers(js, ps, preg.get(arch).vocab)
    close_to_scale(ps.cache["k"], js.cache["k"], 1e-5)


def test_serve_requests_matches_the_jax_counts(monkeypatch):
    monkeypatch.setattr(jserve, "make_host_mesh", lambda **kw: auto_mesh())
    kw = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)
    want = jserve.serve_requests(DEEPSEEK, **kw)
    got = pserve.serve_requests(DEEPSEEK, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    assert got["completed"] == 3
