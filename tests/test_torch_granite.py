"""The port's layer norm and granite (the dense family with ``norm="ln"``,
MQA and the gelu MLP) against the JAX package, on the CPU.

Config: ``granite-20b-smoke`` (f32, 2 layers, d_model 64, 4 query heads
over 1 kv head of 16, gelu MLP of 128, vocabulary 512, tied embeddings).
Weights come from the JAX package's ``init_params``; the norm weights and
the norm biases (``ln1_b``, ``ln2_b``, ``final_norm_b``), which it
initialises to ones and zeros, are overwritten with random values so
their paths are tested; then the same numpy tree is carried into the port
(``models.carry``).  Inputs are drawn from seeded numpy generators and
handed to both packages.

- ``ref.layernorm`` matches the JAX plain version and the Pallas kernel
  (``interpret=True``) to rtol = atol = 1e-4 in f32 and bf16 (rows with a
  large mean included); its gradient matches
  ``jax.vjp`` of the JAX plain version to 1e-4;
- the spec tree matches the reference's, the norm biases included;
- a granite layer (its gelu MLP included) and the decode step match the
  JAX functions on their plain path (``backend="xla"``) and through the
  Pallas kernels (``"interpret"``);
- the SSM family takes ``norm="ln"`` as the reference does.

granite's forward, gradients, train steps, server, ``serve_requests``,
CLIs and default device are cases of the qwen and mamba2 tests
(``tests/test_torch_train.py``, ``test_torch_serve.py``,
``test_torch_ssm.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import norms as jnorms
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.configs import registry as preg
from repro_torch.kernels import ref
from repro_torch.models import carry
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams

ARCH = "granite-20b-smoke"
TOL = dict(rtol=1e-5, atol=1e-5)
LN_TOL = dict(rtol=1e-4, atol=1e-4)  # the layer norm against the JAX package


def configs(arch=ARCH, **changes):
    cj, cp = jreg.get(arch), preg.get(arch)
    if changes:
        cj = dataclasses.replace(cj, **changes)
        cp = dataclasses.replace(cp, **changes)
    return cj, cp


def jax_weights(cfg_j, seed=0):
    """The JAX package's weights as numpy, with every norm weight drawn
    around 1 and every norm bias around 0 (their inits are ones and
    zeros)."""
    tree = jparams.init_params(jlm.lm_specs(cfg_j), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed + 100)
    for parent, names in ((tree, ("final_norm",)), (tree["layers"], ("ln1", "ln2"))):
        for name in names:
            if name not in parent:
                continue
            shape = parent[name].shape
            parent[name] = (1 + 0.3 * rng.normal(size=shape)).astype(np.float32)
            parent[name + "_b"] = (0.3 * rng.normal(size=shape)).astype(np.float32)
    return tree


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL)
    )


def close_to_scale(got: torch.Tensor, want, rtol):
    """Within rtol of the tensor's largest magnitude, entry by entry."""
    want = np.asarray(want, np.float32)
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, atol=atol)


def leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def tokens_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def ln_inputs(rng, shape, offset=0.0):
    x = (offset + rng.normal(size=shape)).astype(np.float32)
    w = (1 + 0.3 * rng.normal(size=shape[-1])).astype(np.float32)
    b = (0.3 * rng.normal(size=shape[-1])).astype(np.float32)
    return x, w, b


# ---------------------------------------------------------------------------
# the layer norm: the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 256), (4, 6144), (2, 3, 1001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_layernorm_matches_jax_and_pallas(shape, dtype):
    """rtol = atol = 1e-4 in f32, and in bf16 (x in bf16, w and b in f32,
    the serving path's types), where each side rounds its f32 result once
    to bf16."""
    x, w, b = ln_inputs(np.random.default_rng(len(shape) + shape[-1]), shape)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    xp = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ref.layernorm(xp, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == xp.dtype and got.shape == xp.shape
    for want in (
        jref.layernorm(xj, jnp.asarray(w), jnp.asarray(b)),
        jnorms.layernorm(xj, jnp.asarray(w), jnp.asarray(b), interpret=True),
    ):
        assert want.dtype == jdt
        close(got, want, **LN_TOL)


def test_plain_layernorm_keeps_the_variance_of_rows_with_a_large_mean():
    """Two passes, as the reference: rows at a mean of 300 and a spread of
    1 normalise as the same rows at mean 0 do (E[x^2] - mean^2 in f32
    would lose the variance's digits)."""
    x, w, b = ln_inputs(np.random.default_rng(3), (4, 6144))
    shifted = x + np.float32(300.0)
    want = jref.layernorm(jnp.asarray(shifted), jnp.asarray(w), jnp.asarray(b))
    got = ref.layernorm(*(torch.from_numpy(a) for a in (shifted, w, b)))
    close(got, want, **LN_TOL)
    close(got, ref.layernorm(*(torch.from_numpy(a) for a in (x, w, b))), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", [(5, 48), (6, 6144)])
def test_plain_layernorm_bwd_matches_jax_grad(shape):
    rng = np.random.default_rng(shape[-1])
    x, w, b = ln_inputs(rng, shape, offset=2.0)
    dy = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(jref.layernorm, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    got = ref.layernorm_bwd(*(torch.from_numpy(a) for a in (x, w, b, dy)))
    assert len(got) == 3
    for g, wt in zip(got, want):
        close_to_scale(g, wt, 1e-4)


# ---------------------------------------------------------------------------
# granite's layers and model
# ---------------------------------------------------------------------------


def test_spec_tree_matches_the_reference():
    """Shapes, inits and dtypes of every leaf, the norm biases included."""
    cj, cp = configs()
    flat = dict(leaves_with_paths(jlm.lm_specs(cj)))
    port = dict(leaves_with_paths(plm.lm_specs(cp)))
    assert set(port) == set(flat)
    for path in ("final_norm_b", "layers.ln1_b", "layers.ln2_b", "layers.mlp.w_in"):
        assert path in port, path
    assert "layers.attn.bq" not in port and port["layers.attn.wk"].shape[2] == 1  # MQA
    for key, s in port.items():
        assert s.shape == flat[key].shape and s.init == flat[key].init, key
        assert str(s.dtype) == f"torch.{jnp.dtype(flat[key].dtype)}", key


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
def test_granite_layer_matches_jax(backend, tol):
    """One layer: ln1 (with bias), MQA attention, ln2, the gelu MLP; the
    Pallas kernels (interpret) at 1e-4 of the output's scale."""
    cj, cp = configs()
    tree = jax_weights(cj, seed=3)
    lj = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["layers"])
    lp = pparams.tree_map(lambda a: torch.from_numpy(np.array(a[0])), tree["layers"])
    rng = np.random.default_rng(4)
    B, S = 2, 128
    x = rng.normal(size=(B, S, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = jlm._dense_layer_apply(cj, None, 0, backend, lj, jnp.asarray(x), jnp.asarray(pos))
    got = plm._dense_layer_apply(cp, lp, torch.from_numpy(x), torch.from_numpy(pos))
    close_to_scale(got, want, tol)


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
def test_decode_step_matches_jax(backend, tol):
    """Several decode steps on a stale cache, one slot past the cache's end
    (the write clamps): logits and K/V caches to ``tol`` of their scale,
    the same greedy tokens."""
    cj, cp = configs()
    tree = jax_weights(cj, seed=5)
    pj, pp = as_jax(tree), carry.from_jax_params(cp, tree, "cpu")
    B, S = 3, 128  # S a multiple of the Pallas decode block
    kv = np.random.default_rng(6).normal(size=(2, cj.n_layers, B, S, 1, cj.d_head))
    kv = kv.astype(np.float32)
    cache_j = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
    cache_p = carry.cache_from_numpy(cp, {"k": kv[0], "v": kv[1]}, "cpu")
    assert cache_p["k"].shape == (cj.n_layers, B, S, 1, cj.d_head)
    rng = np.random.default_rng(7)
    for step in range(3):
        toks = rng.integers(0, cj.vocab, size=B).astype(np.int32)
        pos = np.array([step, 60 + step, S - 1 + step], np.int32)
        lj, cache_j = jlm.decode_step(
            cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend=backend
        )
        lp, cache_p = plm.decode_step(
            cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos)
        )
        close_to_scale(lp, lj, tol)
        close_to_scale(cache_p["k"], cache_j["k"], tol)
        close_to_scale(cache_p["v"], cache_j["v"], tol)
        assert torch.equal(lp.argmax(-1), torch.from_numpy(np.asarray(jnp.argmax(lj, -1))))


def test_the_ssm_family_takes_layer_norm():
    """mamba2-130m-smoke with norm="ln", which the reference builds (its
    ln1 and final norm become layer norms with biases; the Mamba2 block's
    inner norm stays an rmsnorm): the forward within 1e-5 of its scale."""
    cj, cp = configs("mamba2-130m-smoke", norm="ln")
    tree = jax_weights(cj, seed=15)
    assert "ln1_b" in tree["layers"] and "final_norm_b" in tree
    batch = tokens_batch(cj, 2, 128, seed=16)
    loss_j, logits_j = jlm.forward(
        cj, as_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()}, backend="xla"
    )
    loss_p, logits_p = plm.forward(cp, carry.from_jax_params(cp, tree, "cpu"), to_torch(batch))
    close_to_scale(logits_p, logits_j, 1e-5)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
