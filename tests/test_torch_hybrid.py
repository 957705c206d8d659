"""The port's hybrid family (zamba2: Mamba2 layers with one shared
attention+MLP block) against the JAX package, on the CPU.

Config: ``zamba2-1.2b-smoke`` (f32, d_model 64, d_inner 128, 8 SSD heads
of P = 16, N = 16, 4/2 attention heads of 16, the gelu MLP of 128) with
``n_layers=5`` and ``attn_every=2``, so the groups of Mamba2 layers are 2,
2 and 1, each followed by the shared block (3 applications), and a
window under the sequence, so the windowed mask acts.  Weights:
``tests/torch_models.py``.

- the spec and cache trees match the reference's (smoke and published
  widths: zamba2-1.2b's 38 layers make 7 applications);
- with the shared block's wq and wk at a fan-in of d_model, ``forward``
  matches the reference's plain path (1e-5 of the logits' scale) and its
  Pallas kernels (``interpret``, 1e-4), the loss within 1e-5; the
  gradients match the port's own in f64 and ``jax.grad`` within 1e-4,
  with and without remat (the shared block's gradient is the sum over
  its applications on both sides); at the reference's own init, whose
  nearly one-hot attention amplifies f32 rounding through the stack,
  both packages' f32 forward and gradients are held to the port's f64;
- decode steps past the window, so the ring of W rows wraps (``slot = pos
  % W``, ``kv_len = min(pos + 1, W)``, RoPE at the absolute position):
  logits and every cache leaf (``h``, ``conv``, ``k``, ``v``) within 1e-5
  of their scale; through the Pallas kernels at 1e-4 on a stale ring;
- zamba2-1.2b at its published widths, one layer and one application:
  ``forward`` and a decode step match;
- three train steps match the reference's ``jit_train_step``;
- the server gives the reference server's tokens, token for token, with
  a slot reused (its SSM state and ring carry over, as the reference's
  do), and ``serve_requests`` the same counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import registry as preg
from repro_torch.launch import serve as pserve
from repro_torch.models import carry
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from torch_models import (
    as_jax,
    assert_same_specs,
    at_model_fan_in,
    auto_mesh,
    check_forward_and_decode,
    check_grads,
    close_to_scale,
    configs,
    drive_servers,
    forward_both,
    get_path,
    grads_both,
    jax_weights,
    leaves_with_paths,
    published_f32,
    random_caches,
    servers,
    to_torch,
    tokens_batch,
    train_steps_both,
)

ARCH = "zamba2-1.2b-smoke"
HYBRID = dict(n_layers=5, attn_every=2, window=16)  # groups 2, 2, 1; S 64 > window


def hybrid_configs(**changes):
    return configs(ARCH, **{**HYBRID, **changes})


def test_groups_and_trees_match_the_reference():
    cj, cp = hybrid_configs()
    assert plm._groups(cp) == [(0, 2), (2, 2), (4, 1)]
    specs = plm.lm_specs(cp)
    assert_same_specs(specs, jlm.lm_specs(cj))
    assert set(specs["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    assert specs["shared_attn"]["attn"]["wq"].shape == (cp.d_model, cp.n_heads, cp.d_head)
    cache = plm.cache_specs(cp, 3, 40)
    assert_same_specs(cache, jlm.cache_specs(cj, 3, 40))
    assert cache["k"].shape == (3, 3, 16, cp.n_kv, cp.d_head)  # min(S, window) rows
    assert cache["h"].shape[0] == 5


@pytest.mark.parametrize("ctx", [512, 8192])
def test_published_trees_match_the_reference(ctx):
    """zamba2-1.2b: 38 Mamba2 layers, 7 applications of the shared block,
    a ring of min(ctx, 4,096) rows."""
    cj, cp = jreg.get("zamba2-1.2b"), preg.get("zamba2-1.2b")
    assert len(plm._groups(cp)) == 7
    assert_same_specs(plm.lm_specs(cp), jlm.lm_specs(cj))
    cache = plm.cache_specs(cp, 4, ctx)
    assert_same_specs(cache, jlm.cache_specs(cj, 4, ctx))
    assert cache["k"].shape == (7, 4, min(ctx, 4096), 32, 64)


def conditioned_weights(cj, seed):
    """The shared block's wq and wk at a fan-in of d_model
    (``torch_models.at_model_fan_in``): at the reference's init the
    attention is nearly one-hot, and through 5 Mamba2 layers and 3
    applications each package's f32 forward lies up to 3.3e-4 of the
    logits' scale from the port's f64 forward, its gradients up to 2.3e-3
    (``test_deep_stack_at_the_reference_init`` holds that case); here
    the two packages agree within 7e-6 and 2e-5."""
    tree = jax_weights(cj, seed=seed)
    at_model_fan_in(tree["shared_attn"]["attn"])
    return tree


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
def test_forward_matches_jax(backend, tol):
    cj, cp = hybrid_configs()
    tree = conditioned_weights(cj, seed=1)
    pj, pp = as_jax(tree), carry.from_jax_params(cp, tree, "cpu")
    batch = tokens_batch(cj, 2, 64, seed=2)
    (loss_j, logits_j), (loss_p, logits_p) = forward_both(cj, cp, pj, pp, batch, backend)
    assert logits_p.shape == logits_j.shape
    close_to_scale(logits_p, logits_j, tol)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax(remat):
    """Every gradient within 1e-4 of its scale of the port's own in f64
    and of ``jax.grad``'s; the shared block's is the sum over its three
    applications on both sides."""
    cj, cp = hybrid_configs(remat=remat)
    tree = conditioned_weights(cj, seed=3)
    grads = check_grads(cj, cp, tree, tokens_batch(cj, 2, 64, seed=4), jax_rtol=1e-4)
    shared = grads["shared_attn"]
    assert float(shared["attn"]["wq"].abs().max()) > 0 and float(shared["ln1"].abs().max()) > 0


def test_deep_stack_at_the_reference_init():
    """The same model at the reference's own init, each package's f32
    held to the port's f64: the logits within 1e-3 of their scale
    (measured: JAX 3.3e-4, the port 2.6e-4) and every gradient within
    5e-3 (JAX 2.3e-3, the port 1.6e-3).  A wrong layer order, window,
    ring or gradient sum would part the JAX package from the port's f64
    by far more."""
    cj, cp = hybrid_configs()
    tree = jax_weights(cj, seed=1)
    batch = tokens_batch(cj, 2, 64, seed=2)
    _, grads_j, _, grads_p, grads_64, params = grads_both(cj, cp, tree, batch)
    (_, logits_j), (_, logits_p) = forward_both(cj, cp, as_jax(tree), params, batch, "xla")
    cp64 = dataclasses.replace(cp, param_dtype=torch.float64)
    p64 = pparams.tree_map(lambda t: t.double(), params)
    _, logits_64 = plm.forward(cp64, p64, to_torch(batch))
    for got in (logits_p, torch.from_numpy(np.asarray(logits_j))):
        close_to_scale(got, logits_64.numpy(), 1e-3)
    for path, _ in leaves_with_paths(tree):
        want = get_path(grads_64, path).numpy()
        close_to_scale(get_path(grads_p, path), want, 5e-3)
        close_to_scale(torch.from_numpy(np.asarray(get_path(grads_j, path))), want, 5e-3)


def _decode_both(cj, cp, pj, pp, cache_j, cache_p, toks, pos, backend):
    lj, cache_j = jlm.decode_step(cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend=backend)
    lp, cache_p = plm.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
    return lj, cache_j, lp, cache_p


def _zero_caches(cj, cp, B, S):
    specs = jlm.cache_specs(cj, B, S)
    tree = {k: np.zeros(s.shape, np.float32) for k, s in specs.items()}
    return as_jax(tree), carry.cache_from_numpy(cp, tree, "cpu")


def test_decode_steps_wrap_the_ring():
    """A window of 8 rows under a context of 32: 14 steps from empty
    caches, one slot 3 positions ahead, so both rings wrap; every step's
    logits, tokens and cache leaves against the reference's (the weights
    of the forward test)."""
    cj, cp = hybrid_configs(window=8)
    tree = conditioned_weights(cj, seed=5)
    pj, pp = as_jax(tree), carry.from_jax_params(cp, tree, "cpu")
    B = 2
    cache_j, cache_p = _zero_caches(cj, cp, B, 32)
    assert cache_p["k"].shape[2] == 8
    rng = np.random.default_rng(6)
    for step in range(14):
        toks = rng.integers(0, cj.vocab, size=B).astype(np.int32)
        pos = np.array([step, step + 3], np.int32)
        lj, cache_j, lp, cache_p = _decode_both(cj, cp, pj, pp, cache_j, cache_p, toks, pos, "xla")
        close_to_scale(lp, lj, 1e-5)
        assert torch.equal(lp.argmax(-1), torch.from_numpy(np.asarray(jnp.argmax(lj, -1))))
        for leaf in ("h", "conv", "k", "v"):
            close_to_scale(cache_p[leaf], cache_j[leaf], 1e-5)
    assert float(cache_p["k"].abs().min()) > 0  # every ring row written


def test_decode_step_matches_the_pallas_kernels():
    """A stale ring of 128 rows (a multiple of the Pallas decode block),
    positions before, at and past it: the reference through its Pallas
    kernels (interpret) at 1e-4."""
    cj, cp = hybrid_configs(window=128)
    tree = conditioned_weights(cj, seed=7)
    pj, pp = as_jax(tree), carry.from_jax_params(cp, tree, "cpu")
    B = 3
    cache_j, cache_p = random_caches(cj, cp, B, 256, seed=8, scale=0.5)
    assert cache_p["k"].shape[2] == 128
    rng = np.random.default_rng(9)
    for step in range(2):
        toks = rng.integers(0, cj.vocab, size=B).astype(np.int32)
        pos = np.array([5 + step, 127 + step, 300 + step], np.int32)
        lj, cache_j, lp, cache_p = _decode_both(
            cj, cp, pj, pp, cache_j, cache_p, toks, pos, "interpret"
        )
        close_to_scale(lp, lj, 1e-4)
        for leaf in ("h", "conv", "k", "v"):
            close_to_scale(cache_p[leaf], cache_j[leaf], 1e-4)


def test_published_width_matches_jax():
    """zamba2-1.2b at its published widths (d 2,048, 64 SSD heads of P 64,
    N 64, the shared block's 32/32 heads of 64), one Mamba2 layer and one
    application, f32: forward and a decode step."""
    check_forward_and_decode(*published_f32("zamba2-1.2b"))


def test_three_train_steps_match_jax():
    """zamba2-1.2b-smoke (2 Mamba2 layers, one application): losses within
    1e-5, grad norms within 1e-3, every parameter within 1e-5 of its scale
    after three steps (the settings of ``tests/test_torch_train.py``)."""
    run = train_steps_both(ARCH)
    for _ in range(3):
        pm, jm = next(run)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    pp, jp = next(run)
    for path, want in leaves_with_paths(jp):
        close_to_scale(get_path(pp, path), want, 1e-5)


def test_batched_server_matches_the_jax_server():
    """The reused slot 0 keeps its SSM state and ring, on both sides."""
    js, ps = servers(ARCH, batch=2, ctx=32)
    assert set(ps.cache) == set(js.cache) == {"h", "conv", "k", "v"}
    for leaf, t in ps.cache.items():
        assert tuple(t.shape) == tuple(js.cache[leaf].shape), leaf
    drive_servers(js, ps, preg.get(ARCH).vocab)
    for leaf in ("h", "conv", "k", "v"):
        close_to_scale(ps.cache[leaf], js.cache[leaf], 1e-5)


def test_serve_requests_matches_the_jax_counts(monkeypatch):
    monkeypatch.setattr(jserve, "make_host_mesh", lambda **kw: auto_mesh())
    kw = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)
    want = jserve.serve_requests(ARCH, **kw)
    got = pserve.serve_requests(ARCH, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    assert got["completed"] == 3


def test_jax_cache_specs_are_carried():
    """``cache_from_numpy`` takes the reference's hybrid cache, whose
    ``k``/``v`` lead with the applications, not the layers."""
    cj, cp = hybrid_configs()
    specs = jlm.cache_specs(cj, 2, 12)
    tree = {k: np.zeros(s.shape, np.dtype(s.dtype)) for k, s in specs.items()}
    cache = carry.cache_from_numpy(cp, tree, "cpu")
    assert cache["k"].shape[0] == 3 and cache["h"].shape[0] == 5
