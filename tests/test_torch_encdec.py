"""The port's encoder-decoder family (seamless-m4t: a non-causal encoder
over precomputed frame embeddings, a causal decoder with cross-attention
over the encoder's output) against the JAX package, on the CPU.

Configs: ``seamless-m4t-large-v2-smoke`` (f32, 2 + 2 layers, d_model 64,
4/2 heads of 16, the gelu MLP of 128, layer norms with biases, vocab
512) and the published widths cut to 1 + 1 layers in f32.  Weights:
``tests/torch_models.py`` (the norm weights and biases randomised); the
frames are drawn with numpy in f32, as the data pipeline makes them.

- the spec trees and cache specs equal the reference's (keys, shapes,
  dtypes, inits), the serving cache with ``ENC_LEN_DECODE`` cross rows;
- with every attention block's wq and wk at a fan-in of d_model
  (``torch_models.at_model_fan_in``; ROADMAP C.4: the reference's init
  makes six attentions nearly one-hot, which amplifies f32 rounding):
  ``encode``'s memory and ``forward``'s logits within 1e-4 of their
  scale (rope's ulp, as in ``tests/test_torch_train.py``: the encoder's
  attention takes rotary embeddings too) and the loss within 1e-5,
  against the reference's plain path and, on one small case, its Pallas
  kernels (``interpret``); the gradients within 1e-4 of the port's own
  in f64 and 2e-4 of ``jax.grad`` (``torch_models.check_grads``), with
  and without remat; at the reference's own init both packages' f32 held
  to the port's f64, and at depth the gradient's growth from the loss
  back in both packages (ROADMAP C.3);
- ``decode_step`` on a random cache with a non-zero cross memory: the
  logits within 1e-5 of their scale and the written K/V within 1e-5;
- decoding tokens 0..t over ``_mem_kv(encode(frames))`` gives
  ``forward``'s logits at t, in both packages (1e-4 of their scale);
- the server's tokens equal the JAX server's, token for token, both over
  the all-zero cross memory of ``ENC_LEN_DECODE`` rows that the
  reference's server never fills (ROADMAP C.3); ``serve_requests`` the
  same counts;
- three train steps equal the reference's ``jit_train_step`` (wq and wk
  at a fan-in of d_model);
- ``carry`` takes the reference's parameter tree and cache.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import encdec as jencdec
from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig as PShape
from repro_torch.launch import serve as pserve
from repro_torch.launch import specs as pspecs
from repro_torch.models import carry
from repro_torch.models import encdec as pencdec
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from repro_torch.parallel import steps as psteps
from torch_models import (
    as_jax,
    assert_same_specs,
    auto_mesh,
    both_weights,
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
    servers,
    to_torch,
    tokens_batch,
    train_steps_both,
)

ARCH = "seamless-m4t-large-v2-smoke"


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_trees_match_the_reference(smoke):
    cj = jreg.get("seamless-m4t-large-v2", smoke)
    cp = preg.get("seamless-m4t-large-v2", smoke)
    specs = psteps.model_specs(cp)
    assert_same_specs(specs, jencdec.encdec_specs(cj))
    assert set(specs["dec_layers"]) == {
        "ln1", "ln1_b", "attn", "lnx", "lnx_b", "xattn", "ln2", "ln2_b", "mlp"
    }
    assert_same_specs(pencdec.cache_specs(cp, 4, 512, 96), jencdec.cache_specs(cj, 4, 512, 96))
    shape_j, shape_p = JShape("serve", 512, 4, "decode"), PShape("serve", 512, 4, "decode")
    want = jspecs.cache_spec_tree(cj, shape_j)
    assert want["xk"].shape[2] == pspecs.ENC_LEN_DECODE == jspecs.ENC_LEN_DECODE
    assert_same_specs(pspecs.cache_spec_tree(cp, shape_p), want)


def test_lm_specs_refuse_the_family_as_the_reference_does():
    with pytest.raises(ValueError, match="encdec"):
        plm.lm_specs(preg.get(ARCH))


@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_encode_and_forward_match_jax(backend):
    cj, cp = configs(ARCH)
    pj, pp = both_weights(cj, cp, seed=1, model_fan_in=True)
    batch = tokens_batch(cj, 2, 64, seed=2)
    assert batch["frontend"].shape == (2, 64, cj.d_model)
    mem_j = jencdec.encode(cj, pj, jnp.asarray(batch["frontend"]), backend=backend)
    mem_p = pencdec.encode(cp, pp, torch.from_numpy(batch["frontend"]))
    close_to_scale(mem_p, mem_j, 1e-4)
    (loss_j, logits_j), (loss_p, logits_p) = forward_both(cj, cp, pj, pp, batch, backend)
    assert logits_p.shape == logits_j.shape == (2, 64, 512)
    close_to_scale(logits_p, logits_j, 1e-4)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def test_the_frames_move_the_logits():
    """Other frames under the same tokens give other logits (the encoder's
    memory is attended to), and a bf16 model takes the f32 frames."""
    cj, cp = configs(ARCH)
    _, pp = both_weights(cj, cp, seed=3)
    batch = tokens_batch(cj, 1, 32, seed=4)
    _, first = pencdec.forward(cp, pp, to_torch(batch))
    batch["frontend"] = batch["frontend"][:, ::-1].copy()
    loss, second = pencdec.forward(cp, pp, to_torch(batch))
    assert float((first - second).abs().max()) > 1e-3
    cbf = dataclasses.replace(cp, param_dtype=torch.bfloat16)
    pbf = pparams.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() > 1 else t, pp)
    loss_bf, logits_bf = pencdec.forward(cbf, pbf, to_torch(batch))
    assert logits_bf.dtype == torch.float32 and logits_bf.shape == first.shape
    assert abs(float(loss_bf) - float(loss)) < 0.05


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax(remat):
    cj, cp = configs(ARCH, remat=remat)
    tree = jax_weights(cj, seed=5, model_fan_in=True)
    grads = check_grads(cj, cp, tree, tokens_batch(cj, 2, 32, seed=6))
    # every leaf of both stacks is reached, the cross-attention's too
    for path in ("enc_layers.attn.wq", "dec_layers.xattn.wk", "enc_norm_b", "dec_layers.lnx"):
        assert float(get_path(grads, path).abs().max()) > 0, path


def test_at_the_reference_init():
    """The smoke model at the reference's own init, each package's f32
    held to the port's f64: the logits within 1e-3 of their scale
    (measured: the port 1.0e-4, JAX 1.3e-4) and every gradient within
    5e-3 (the port 2.2e-3, JAX 1.6e-3), the bounds of the hybrid family's
    deep stack (``tests/test_torch_hybrid.py``).  A wrong mask, memory or
    layer order would part the JAX package from the port's f64 by far
    more."""
    cj, cp = configs(ARCH)
    tree = jax_weights(cj, seed=1)
    batch = tokens_batch(cj, 2, 64, seed=2)
    _, grads_j, _, grads_p, grads_64, params = grads_both(cj, cp, tree, batch)
    (_, logits_j), (_, logits_p) = forward_both(cj, cp, as_jax(tree), params, batch, "xla")
    cp64 = dataclasses.replace(cp, param_dtype=torch.float64)
    p64 = pparams.tree_map(lambda t: t.double(), params)
    _, logits_64 = pencdec.forward(cp64, p64, to_torch(batch))
    for got in (logits_p, torch.from_numpy(np.asarray(logits_j))):
        close_to_scale(got, logits_64.numpy(), 1e-3)
    for path, _ in leaves_with_paths(tree):
        want = get_path(grads_64, path).numpy()
        close_to_scale(get_path(grads_p, path), want, 5e-3)
        close_to_scale(torch.from_numpy(np.asarray(get_path(grads_j, path))), want, 5e-3)


@pytest.mark.parametrize("model_fan_in", [False, True])
def test_the_reference_init_blows_the_gradient_up_in_both_packages(model_fan_in):
    """ROADMAP C.3: seamless at its published widths (the vocabulary cut
    to 512), 4 + 4 layers, f32.  At the reference's init (fan-in = the
    head count for wq and wk) the attention is nearly one-hot and the
    gradient grows from the loss back: the first encoder layer's ln1
    gradient is over 100x the last's in both packages (measured: JAX
    240x, the port 410x; the amplified rounding parts them), which at
    24 + 24 layers overflows f32 (``chip_smoke.py``'s
    ``encdec_reference_init``).  At a fan-in of d_model it stays flat
    (0.5x) and the packages agree within 2e-4."""
    cj, cp = configs("seamless-m4t-large-v2", n_layers=4, enc_layers=4, vocab=512)
    cj = dataclasses.replace(cj, param_dtype=jnp.float32)
    cp = dataclasses.replace(cp, param_dtype=torch.float32)
    tree = jax_weights(cj, seed=2, model_fan_in=model_fan_in)
    _, grads_j, _, grads_p, _, _ = grads_both(cj, cp, tree, tokens_batch(cj, 1, 64, seed=3))
    for g in (np.asarray(grads_j["enc_layers"]["ln1"]), grads_p["enc_layers"]["ln1"].numpy()):
        by_layer = np.abs(g).max(axis=1)
        growth = by_layer[0] / by_layer[-1]
        assert growth > 100 if not model_fan_in else growth < 2, by_layer
    if model_fan_in:
        close_to_scale(grads_p["enc_layers"]["ln1"], grads_j["enc_layers"]["ln1"], 2e-4)


def test_published_width_matches_jax():
    """seamless at its published widths (d 1,024, 16/16 heads of 64, MLP
    8,192, vocabulary 256,206), 1 + 1 layers, f32: forward and one decode
    step as for the smoke config."""
    cj, cp = published_f32("seamless-m4t-large-v2")
    assert (cj.n_layers, cj.enc_layers, cp.enc_layers) == (1, 1, 1)
    pj, pp = both_weights(cj, cp, seed=7, model_fan_in=True)
    batch = tokens_batch(cj, 1, 64, seed=8)
    (loss_j, logits_j), (loss_p, logits_p) = forward_both(cj, cp, pj, pp, batch, "xla")
    close_to_scale(logits_p, logits_j, 1e-4)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    check_decode_step(cj, cp, pj, pp, seed=9)


def random_caches(cj, cp, B, S, enc_len, seed, scale=0.5):
    """A stale cache of the reference's layout drawn with numpy, its cross
    K/V not zero: ``(JAX cache, port cache)``."""
    rng = np.random.default_rng(seed)
    specs = jencdec.cache_specs(cj, B, S, enc_len)
    tree = {k: (scale * rng.normal(size=s.shape)).astype(np.float32) for k, s in specs.items()}
    return as_jax(tree), carry.cache_from_numpy(cp, tree, "cpu")


def check_decode_step(cj, cp, pj, pp, seed):
    cache_j, cache_p = random_caches(cj, cp, 2, 32, 48, seed=seed)
    toks, pos = np.array([5, 17], np.int32), np.array([3, 31], np.int32)
    want, new_j = jencdec.decode_step(
        cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="xla"
    )
    got, new_p = pencdec.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
    close_to_scale(got, want, 1e-5)
    for leaf in ("k", "v", "xk", "xv"):
        close_to_scale(new_p[leaf], new_j[leaf], 1e-5)


def test_decode_step_matches_jax():
    cj, cp = configs(ARCH)
    pj, pp = both_weights(cj, cp, seed=10)
    check_decode_step(cj, cp, pj, pp, seed=11)


def test_decode_step_matches_the_pallas_kernels():
    """The reference's flash_decode and layer norm kernels in interpret
    mode, over a cross memory of 48 rows."""
    cj, cp = configs(ARCH)
    pj, pp = both_weights(cj, cp, seed=12)
    cache_j, cache_p = random_caches(cj, cp, 2, 16, 48, seed=13)
    toks, pos = np.array([1, 2], np.int32), np.array([0, 9], np.int32)
    want, _ = jencdec.decode_step(
        cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="interpret"
    )
    got, _ = pencdec.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
    close_to_scale(got, want, 1e-5)


def test_decode_agrees_with_teacher_forcing():
    """Decoding tokens 0..t one at a time over the cross K/V of the encoded
    frames gives ``forward``'s logits at t, in each package, and the two
    packages agree."""
    cj, cp = configs(ARCH)
    pj, pp = both_weights(cj, cp, seed=14, model_fan_in=True)
    B, S = 2, 16
    batch = tokens_batch(cj, B, S, seed=15)
    (_, fwd_j), (_, fwd_p) = forward_both(cj, cp, pj, pp, batch, "xla")
    mem_j = jencdec.encode(cj, pj, jnp.asarray(batch["frontend"]), backend="xla")
    mem_p = pencdec.encode(cp, pp, torch.from_numpy(batch["frontend"]))
    cache_j = {k: jnp.zeros(s.shape, s.dtype) for k, s in jencdec.cache_specs(cj, B, S, S).items()}
    cache_p = pparams.init_params(pencdec.cache_specs(cp, B, S, S), None, "cpu")
    xk_j, xv_j, xk_p, xv_p = [], [], [], []
    for i in range(cj.n_layers):
        k, v = jencdec._mem_kv(jax_layer(pj["dec_layers"]["xattn"], i), mem_j)
        xk_j.append(k)
        xv_j.append(v)
        k, v = pencdec._mem_kv(pparams.tree_map(lambda t: t[i], pp["dec_layers"]["xattn"]), mem_p)
        xk_p.append(k)
        xv_p.append(v)
    cache_j = dict(cache_j, xk=jnp.stack(xk_j), xv=jnp.stack(xv_j))
    cache_p = dict(cache_p, xk=torch.stack(xk_p), xv=torch.stack(xv_p))
    for t in range(S):
        toks = batch["tokens"][:, t]
        pos = np.full((B,), t, np.int32)
        got_j, cache_j = jencdec.decode_step(
            cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="xla"
        )
        got_p, cache_p = pencdec.decode_step(
            cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos)
        )
        close_to_scale(torch.from_numpy(np.asarray(got_j)), fwd_j[:, t], 1e-4)
        close_to_scale(got_p, fwd_p[:, t].detach().numpy(), 1e-4)
        close_to_scale(got_p, got_j, 1e-4)


def jax_layer(tree, i):
    return {k: jax_layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def test_batched_server_matches_the_jax_server():
    """Both servers' cross memory is the cache's zero initialisation of
    ENC_LEN_DECODE rows, and stays zero: the reference's server never runs
    the encoder (ROADMAP C.3)."""
    js, ps = servers(ARCH, batch=2, ctx=32)
    assert set(ps.cache) == set(js.cache) == {"k", "v", "xk", "xv"}
    for server in (js, ps):
        assert server.cache["xk"].shape[2] == pspecs.ENC_LEN_DECODE
    drive_servers(js, ps, preg.get(ARCH).vocab)
    close_to_scale(ps.cache["k"], js.cache["k"], 1e-5)
    for leaf in ("xk", "xv"):
        assert not bool(ps.cache[leaf].any()) and not bool(jnp.any(js.cache[leaf]))


def test_zero_cross_memory_adds_nothing():
    """Over the all-zero memory every cross-attention output is the mean
    of zero V, so the step's logits are those of the decoder with the
    cross-attention's output projection zeroed."""
    cj, cp = configs(ARCH)
    _, pp = both_weights(cj, cp, seed=16)
    cache = pparams.init_params(pspecs.cache_spec_tree(cp, PShape("s", 8, 2, "decode")), None, "cpu")
    toks, pos = torch.tensor([3, 4]), torch.tensor([0, 0], dtype=torch.int32)
    got, _ = pencdec.decode_step(cp, pp, cache, toks, pos)
    cut = pparams.tree_map(lambda t: t, pp)  # new dicts, the same tensors
    cut["dec_layers"]["xattn"]["wo"] = torch.zeros_like(pp["dec_layers"]["xattn"]["wo"])
    cache = pparams.init_params(pspecs.cache_spec_tree(cp, PShape("s", 8, 2, "decode")), None, "cpu")
    want, _ = pencdec.decode_step(cp, cut, cache, toks, pos)
    assert torch.equal(got, want)


def test_serve_requests_matches_the_jax_counts(monkeypatch):
    monkeypatch.setattr(jserve, "make_host_mesh", lambda **kw: auto_mesh())
    kw = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)
    want = jserve.serve_requests(ARCH, **kw)
    got = pserve.serve_requests(ARCH, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    assert got["completed"] == 3


def test_three_train_steps_match_jax():
    """The reference's token source makes the frames (B, S, d): losses
    within 1e-5, grad norms within 1e-3, every parameter within 1e-5 of
    its scale (``tests/test_torch_train.py``)."""
    run = train_steps_both(ARCH, model_fan_in=True)
    for _ in range(3):
        pm, jm = next(run)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    pp, jp = next(run)
    for path, want in leaves_with_paths(jp):
        close_to_scale(get_path(pp, path), want, 1e-5)


def test_carry_takes_the_reference_trees():
    """The reference's parameter tree and cache come across leaf for leaf
    (the cache's memory length from axis 2 of ``xk``); a tree of another
    layout is refused."""
    cj, cp = configs(ARCH)
    tree = jax_weights(cj, seed=17)
    params = carry.from_jax_params(cp, tree, "cpu")
    for path, want in leaves_with_paths(tree):
        assert np.array_equal(get_path(params, path).numpy(), want), path
    cache = {
        k: np.random.default_rng(18).normal(size=s.shape).astype(np.float32)
        for k, s in jencdec.cache_specs(cj, 2, 8, 40).items()
    }
    got = carry.cache_from_numpy(cp, cache, "cpu")
    assert tuple(got["xk"].shape) == (2, 2, 40, 2, 16) and tuple(got["k"].shape)[2] == 8
    for k, v in cache.items():
        assert np.array_equal(got[k].numpy(), v), k
    del tree["enc_norm"]
    with pytest.raises(ValueError, match="enc_norm"):
        carry.from_jax_params(cp, tree, "cpu")
